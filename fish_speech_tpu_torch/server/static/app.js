// fish-speech-tpu built-in web UI.
//
// Streaming playback: the /v1/tts streaming response is a WAV header
// followed by int16 PCM per decode chunk. MediaSource has no WAV/PCM
// type, so chunks are parsed off the fetch ReadableStream and scheduled
// as AudioBuffers on a WebAudio clock — audio starts on the first chunk,
// seconds before generation finishes (the reference React UI downloads
// fully before playing).

"use strict";

const $ = (id) => document.getElementById(id);

// ---------------------------------------------------------------------------
// Format picker (populated from the server's actual encoder backends)
// ---------------------------------------------------------------------------

async function loadFormats() {
  const sel = $("format");
  let formats = ["wav", "pcm", "flac"];
  try {
    const r = await fetch("/v1/formats", { headers: { Accept: "application/json" } });
    if (r.ok) formats = (await r.json()).formats;
  } catch (e) { /* keep defaults */ }
  sel.innerHTML = "";
  for (const f of formats) {
    const o = document.createElement("option");
    o.value = o.textContent = f;
    sel.appendChild(o);
  }
}

// ---------------------------------------------------------------------------
// WAV stream parsing + WebAudio scheduling
// ---------------------------------------------------------------------------

function concatU8(a, b) {
  const out = new Uint8Array(a.length + b.length);
  out.set(a); out.set(b, a.length);
  return out;
}

// Returns {rate, channels, dataOffset} once the data chunk header has
// arrived, else null. Handles headers split across reads.
function parseWavHeader(buf) {
  if (buf.length < 12) return null;
  const dv = new DataView(buf.buffer, buf.byteOffset, buf.byteLength);
  if (dv.getUint32(0) !== 0x52494646 /* RIFF */) throw new Error("not a WAV stream");
  let pos = 12, rate = null, channels = null;
  while (pos + 8 <= buf.length) {
    const id = dv.getUint32(pos);
    const size = dv.getUint32(pos + 4, true);
    if (id === 0x666d7420 /* fmt  */ && pos + 16 <= buf.length) {
      channels = dv.getUint16(pos + 10, true);
      rate = dv.getUint32(pos + 12, true);
    }
    if (id === 0x64617461 /* data */) {
      if (rate === null) throw new Error("wav data before fmt");
      return { rate, channels, dataOffset: pos + 8 };
    }
    pos += 8 + size + (size & 1);
  }
  return null;
}

class StreamingPlayer {
  constructor() {
    this.ctx = new (window.AudioContext || window.webkitAudioContext)();
    this.playTime = 0;
    this.firstChunkAt = null;
    this.totalSamples = 0;
    this.rate = null;
    this.sources = [];
  }

  schedule(pcmBytes, rate, channels) {
    const n = Math.floor(pcmBytes.length / 2 / channels);
    if (n === 0) return;
    const i16 = new Int16Array(pcmBytes.buffer.slice(
      pcmBytes.byteOffset, pcmBytes.byteOffset + n * 2 * channels));
    const buf = this.ctx.createBuffer(channels, n, rate);
    for (let c = 0; c < channels; c++) {
      const ch = buf.getChannelData(c);
      for (let i = 0; i < n; i++) ch[i] = i16[i * channels + c] / 32768;
    }
    const src = this.ctx.createBufferSource();
    src.buffer = buf;
    src.connect(this.ctx.destination);
    const startAt = Math.max(this.ctx.currentTime + 0.08, this.playTime);
    src.start(startAt);
    this.sources.push(src);
    this.playTime = startAt + n / rate;
    this.totalSamples += n;
    this.rate = rate;
  }

  stop() {
    for (const s of this.sources) { try { s.stop(); } catch (e) {} }
    this.ctx.close();
  }
}

// ---------------------------------------------------------------------------
// Synthesis
// ---------------------------------------------------------------------------

let abortController = null;

function requestBody(streaming) {
  const seedRaw = $("seed").value;
  return {
    text: $("text").value,
    temperature: parseFloat($("temperature").value),
    top_p: parseFloat($("top_p").value),
    repetition_penalty: parseFloat($("repetition_penalty").value),
    max_new_tokens: parseInt($("max_new_tokens").value),
    chunk_length: parseInt($("chunk_length").value),
    seed: seedRaw ? parseInt(seedRaw) : null,
    reference_id: $("reference_id").value || null,
    references: [],
    format: streaming ? "wav" : $("format").value,
    streaming: streaming,
  };
}

function setStatus(msg, err) {
  const s = $("status");
  s.textContent = msg;
  s.className = err ? "err" : "";
}

function showDownload(blob, fmt) {
  const a = $("download");
  a.href = URL.createObjectURL(blob);
  a.download = "audio." + fmt;
  a.textContent = "download audio." + fmt + " (" + (blob.size / 1024).toFixed(0) + " KiB)";
  a.style.display = "inline";
}

async function synthesize() {
  const streaming = $("streaming").checked;
  const t0 = performance.now();
  $("go").disabled = true;
  $("stop").disabled = false;
  $("metrics").textContent = "";
  $("download").style.display = "none";
  abortController = new AbortController();
  try {
    if (streaming) {
      await synthesizeStreaming(t0);
    } else {
      await synthesizeBlocking(t0);
    }
  } catch (e) {
    if (e.name !== "AbortError") setStatus("Error: " + e.message, true);
    else setStatus("Stopped.");
  } finally {
    $("go").disabled = false;
    $("stop").disabled = true;
    abortController = null;
  }
}

async function synthesizeStreaming(t0) {
  setStatus("Generating (streaming)…");
  const r = await fetch("/v1/tts", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(requestBody(true)),
    signal: abortController.signal,
  });
  if (!r.ok) throw new Error(await r.text());
  const reader = r.body.getReader();
  const player = new StreamingPlayer();
  const allChunks = [];
  let pending = new Uint8Array(0);
  let head = null;
  let firstAudioMs = null;
  try {
    while (true) {
      const { done, value } = await reader.read();
      if (done) break;
      allChunks.push(value);
      pending = concatU8(pending, value);
      if (head === null) {
        head = parseWavHeader(pending);
        if (head === null) continue;
        pending = pending.slice(head.dataOffset);
      }
      const usable = pending.length - (pending.length % (2 * head.channels));
      if (usable > 0) {
        player.schedule(pending.slice(0, usable), head.rate, head.channels);
        pending = pending.slice(usable);
        if (firstAudioMs === null) {
          firstAudioMs = performance.now() - t0;
          setStatus("Playing while generating…");
        }
      }
    }
  } finally {
    // let scheduled audio finish; keep the context alive until done
    const tailMs = Math.max(0, (player.playTime - player.ctx.currentTime) * 1000);
    setTimeout(() => player.ctx.close(), tailMs + 250);
  }
  const totalMs = performance.now() - t0;
  const blob = new Blob(allChunks, { type: "audio/wav" });
  $("player").src = URL.createObjectURL(blob);
  showDownload(blob, "wav");
  const audioS = player.rate ? player.totalSamples / player.rate : 0;
  $("metrics").textContent =
    "first audio " + (firstAudioMs / 1000).toFixed(2) + "s · total " +
    (totalMs / 1000).toFixed(2) + "s · " + audioS.toFixed(1) + "s audio (" +
    (audioS / (totalMs / 1000)).toFixed(2) + "x realtime)";
  setStatus("Done.");
}

async function synthesizeBlocking(t0) {
  const fmt = $("format").value;
  setStatus("Generating…");
  const r = await fetch("/v1/tts", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(requestBody(false)),
    signal: abortController.signal,
  });
  if (!r.ok) throw new Error(await r.text());
  const blob = await r.blob();
  const totalMs = performance.now() - t0;
  if (fmt !== "pcm") $("player").src = URL.createObjectURL(blob);
  showDownload(blob, fmt);
  $("metrics").textContent = "total " + (totalMs / 1000).toFixed(2) + "s";
  setStatus("Done.");
}

// ---------------------------------------------------------------------------
// Reference library browser (CRUD against /v1/references/*)
// ---------------------------------------------------------------------------

async function refreshReferences() {
  const r = await fetch("/v1/references/list", { headers: { Accept: "application/json" } });
  if (!r.ok) return;
  const ids = (await r.json()).reference_ids;
  const tbody = $("ref_table").querySelector("tbody");
  tbody.innerHTML = "";
  const datalist = $("ref_ids");
  datalist.innerHTML = "";
  for (const id of ids) {
    const opt = document.createElement("option");
    opt.value = id;
    datalist.appendChild(opt);

    const tr = document.createElement("tr");
    const tdId = document.createElement("td");
    tdId.textContent = id;
    const tdAct = document.createElement("td");
    tdAct.className = "actions";
    const useBtn = document.createElement("button");
    useBtn.className = "mini sec";
    useBtn.textContent = "use";
    useBtn.onclick = () => { $("reference_id").value = id; };
    const delBtn = document.createElement("button");
    delBtn.className = "danger mini";
    delBtn.textContent = "delete";
    delBtn.onclick = async () => {
      await fetch("/v1/references/delete", {
        method: "DELETE",
        headers: { "Content-Type": "application/json", Accept: "application/json" },
        body: JSON.stringify({ id }),
      });
      refreshReferences();
    };
    tdAct.appendChild(useBtn);
    tdAct.appendChild(delBtn);
    tr.appendChild(tdId);
    tr.appendChild(tdAct);
    tbody.appendChild(tr);
  }
  if (ids.length === 0) {
    const tr = document.createElement("tr");
    const td = document.createElement("td");
    td.colSpan = 2;
    td.style.color = "var(--dim)";
    td.textContent = "(no saved references)";
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}

function b64(buf) {
  let s = "";
  const u8 = new Uint8Array(buf);
  for (let i = 0; i < u8.length; i += 0x8000) {
    s += String.fromCharCode.apply(null, u8.subarray(i, i + 0x8000));
  }
  return btoa(s);
}

async function saveReference() {
  const f = $("ref_audio").files[0];
  const id = $("ref_save_id").value.trim();
  const st = $("ref_status");
  if (!f || !id) { st.textContent = "need an audio file and an ID"; return; }
  const r = await fetch("/v1/references/add", {
    method: "POST",
    headers: { "Content-Type": "application/json", Accept: "application/json" },
    body: JSON.stringify({
      id, audio: b64(await f.arrayBuffer()), text: $("ref_text").value || "",
    }),
  });
  const j = await r.json();
  st.textContent = j.message;
  refreshReferences();
}

function wireDropzone() {
  const dz = $("dropzone");
  const input = $("ref_audio");
  dz.onclick = () => input.click();
  input.onchange = () => { dz.textContent = input.files[0] ? input.files[0].name : dz.textContent; };
  dz.ondragover = (e) => { e.preventDefault(); dz.classList.add("hover"); };
  dz.ondragleave = () => dz.classList.remove("hover");
  dz.ondrop = (e) => {
    e.preventDefault();
    dz.classList.remove("hover");
    if (e.dataTransfer.files.length) {
      input.files = e.dataTransfer.files;
      dz.textContent = input.files[0].name;
    }
  };
}

// ---------------------------------------------------------------------------

window.addEventListener("DOMContentLoaded", () => {
  loadFormats();
  refreshReferences();
  wireDropzone();
  $("go").onclick = synthesize;
  $("stop").onclick = () => { if (abortController) abortController.abort(); };
  $("save_ref").onclick = saveReference;
});
