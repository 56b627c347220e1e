"""The port's HTTP server (`fish_speech_tpu_torch/server/`) against the
cases of `tests/test_server.py`: endpoint parity, content negotiation, auth,
streaming, the OpenAI route, the live WebSocket, the VQ routes and the
references, each case as the original holds the JAX server, here on the
port's tiny random-weight engine on the CPU. Beyond them: a client that
disconnects mid-stream is counted cancelled and, behind the continuous
batcher, its pool row is freed and reused; the OpenAPI spec equals the JAX
server's; the entry point's flags map as the JAX server's do.

aiohttp's TestClient is driven from sync tests via asyncio.run (no
pytest-asyncio in the image).
"""

import asyncio
import io
import wave

import msgpack
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from fish_speech_tpu_torch.audio.io import write_wav
from fish_speech_tpu_torch.config import SamplingConfig, dac_tiny, dual_ar_tiny
from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
from fish_speech_tpu_torch.generate import GenerationSession
from fish_speech_tpu_torch.models.dac.model import init_dac
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
from fish_speech_tpu_torch.server.app import create_app
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

torch.set_num_threads(1)


def _tiny_models(tokenizer):
    dac_cfg = dac_tiny()
    cfg = dual_ar_tiny(
        vocab_size=tokenizer.vocab_size,
        semantic_begin_id=tokenizer.semantic_begin_id,
        semantic_end_id=tokenizer.semantic_end_id,
        im_end_id=tokenizer.im_end_id,
        codebook_size=4096,
        num_codebooks=dac_cfg.rvq.total_codebooks,
        max_seq_len=256,
    )
    params = init_dual_ar(0, cfg, dtype=torch.float32, device="cpu")
    dac_params = init_dac(1, dac_cfg, dtype=torch.float32, device="cpu")
    return cfg, params, dac_cfg, dac_params


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    tokenizer = build_test_tokenizer()
    cfg, params, dac_cfg, dac_params = _tiny_models(tokenizer)
    session = GenerationSession(
        params, cfg, SamplingConfig(), dtype=torch.float32, decode_chunk_size=8
    )
    refs_dir = tmp_path_factory.mktemp("references")
    return TTSInferenceEngine(
        session, tokenizer, dac_params, dac_cfg, references_dir=str(refs_dir)
    )


def run_client(engine, fn, api_key=None):
    async def go():
        app = create_app(engine, api_key=api_key)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client, app) if fn.__code__.co_argcount == 2 \
                else await fn(client)
        finally:
            await client.close()

    return asyncio.run(go())


def make_wav_bytes(n=None, sr=44100):
    n = n or (dac_tiny().frame_length * 2)
    x = (np.random.default_rng(0).normal(size=n) * 0.1).astype(np.float32)
    buf = io.BytesIO()
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_health(engine):
    async def fn(client):
        r = await client.get("/v1/health")
        return r.status, await r.json()

    status, body = run_client(engine, fn)
    assert status == 200 and body == {"status": "ok"}


def test_openapi_and_docs(engine):
    """Schema self-description parity with the reference's kui OpenAPI mount
    (`tools/api_server.py:59-66`): /v1/openapi.json is a valid spec built
    from the live pydantic models (open even under auth — /docs needs it),
    and /docs serves the self-contained viewer."""
    async def fn(client):
        spec = await (await client.get("/v1/openapi.json")).json()
        docs = await client.get("/docs")
        authed = await client.get(
            "/v1/openapi.json", headers={"Authorization": "Bearer wrong"}
        )
        return spec, docs.status, docs.content_type, authed.status

    spec, docs_status, docs_ct, open_status = run_client(
        engine, fn, api_key="secret"
    )
    assert spec["openapi"].startswith("3.")
    assert "/v1/tts" in spec["paths"]
    for path in ("/v1/vqgan/encode", "/v1/vqgan/decode", "/v1/references/add",
                 "/v1/references/list", "/v1/formats", "/v1/health"):
        assert path in spec["paths"], path
    req = spec["paths"]["/v1/tts"]["post"]["requestBody"]
    assert (req["content"]["application/json"]["schema"]["$ref"]
            == "#/components/schemas/ServeTTSRequest")
    tts_schema = spec["components"]["schemas"]["ServeTTSRequest"]
    # spec is generated from the live model: field set matches exactly
    from fish_speech_tpu_torch.server.schema import ServeTTSRequest
    assert set(tts_schema["properties"]) == set(ServeTTSRequest.model_fields)
    assert docs_status == 200 and docs_ct == "text/html"
    assert open_status == 200  # spec stays reachable under auth


def test_auth_rejects_without_key(engine):
    async def fn(client):
        r1 = await client.get("/v1/health")
        r2 = await client.get(
            "/v1/health", headers={"Authorization": "Bearer secret"}
        )
        return r1.status, r2.status

    s1, s2 = run_client(engine, fn, api_key="secret")
    assert s1 == 401 and s2 == 200


def test_tts_json_wav(engine):
    async def fn(client):
        r = await client.post(
            "/v1/tts",
            json={"text": "hi there", "max_new_tokens": 8, "format": "wav"},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF"
    with wave.open(io.BytesIO(body)) as f:
        assert f.getframerate() == engine.sample_rate
        assert f.getnframes() > 0


def test_tts_msgpack_streaming(engine):
    async def fn(client):
        payload = msgpack.packb(
            {"text": "stream me", "max_new_tokens": 8, "streaming": True},
            use_bin_type=True,
        )
        r = await client.post(
            "/v1/tts",
            data=payload,
            headers={"Content-Type": "application/msgpack"},
        )
        return r.status, await r.read()

    status, body = run_client(engine, fn)
    assert status == 200
    assert body[:4] == b"RIFF"  # streamed header then PCM
    assert len(body) > 44


def test_tts_flac_format(engine):
    async def fn(client):
        r = await client.post(
            "/v1/tts",
            json={"text": "flac please", "max_new_tokens": 8, "format": "flac"},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/flac"
    assert body[:4] == b"fLaC"
    from fish_speech_tpu_torch.audio.transcode import decode_flac

    samples, sr = decode_flac(body)
    assert sr == engine.sample_rate and samples.shape[0] > 0


def test_tts_mp3_format(engine):
    from fish_speech_tpu_torch.audio import libcodec
    from fish_speech_tpu_torch.audio.transcode import available_formats

    if "mp3" not in available_formats():  # pragma: no cover
        pytest.skip("no mp3 backend in this environment")

    async def fn(client):
        r = await client.post(
            "/v1/tts",
            json={"text": "mp3 please", "max_new_tokens": 8, "format": "mp3"},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/mpeg"
    samples, sr = libcodec.decode_mp3(body)
    assert sr == engine.sample_rate and samples.shape[0] > 0


def test_tts_opus_format(engine):
    from fish_speech_tpu_torch.audio import libcodec
    from fish_speech_tpu_torch.audio.transcode import available_formats

    if "opus" not in available_formats():  # pragma: no cover
        pytest.skip("no opus backend in this environment")

    async def fn(client):
        r = await client.post(
            "/v1/tts",
            json={"text": "opus please", "max_new_tokens": 8, "format": "opus"},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/opus"
    assert body[:4] == b"OggS"
    samples, sr = libcodec.decode_opus(body)
    assert sr == 48000 and samples.shape[0] > 0


def test_tts_unavailable_format_names_alternatives(engine, monkeypatch):
    # Simulate a stripped system: no mp3/opus backends of any kind.
    from fish_speech_tpu_torch.server import app as app_mod

    monkeypatch.setattr(
        app_mod.transcode, "available_formats", lambda: ["wav", "pcm", "flac"]
    )

    async def fn(client):
        r = await client.post("/v1/tts", json={"text": "x", "format": "opus"})
        return r.status, await r.json()

    status, body = run_client(engine, fn)
    assert status == 400
    assert "flac" in body["error"]  # lists what IS available


def test_tts_rejects_streaming_nonwav(engine):
    async def fn(client):
        r = await client.post(
            "/v1/tts", json={"text": "x", "streaming": True, "format": "pcm"}
        )
        return r.status

    assert run_client(engine, fn) == 400


def test_vqgan_encode_decode_roundtrip(engine):
    wav_bytes = make_wav_bytes()

    async def fn(client):
        payload = msgpack.packb({"audios": [wav_bytes]}, use_bin_type=True)
        r = await client.post(
            "/v1/vqgan/encode",
            data=payload,
            headers={"Content-Type": "application/msgpack"},
        )
        enc = msgpack.unpackb(await r.read(), raw=False)
        payload = msgpack.packb({"tokens": enc["tokens"]}, use_bin_type=True)
        r2 = await client.post(
            "/v1/vqgan/decode",
            data=payload,
            headers={"Content-Type": "application/msgpack"},
        )
        dec = msgpack.unpackb(await r2.read(), raw=False)
        return enc, dec

    enc, dec = run_client(engine, fn)
    tokens = np.asarray(enc["tokens"][0])
    assert tokens.shape[0] == engine.codec_cfg.rvq.total_codebooks
    audio = np.frombuffer(dec["audios"][0], dtype=np.float16)
    assert len(audio) == tokens.shape[1] * engine.codec_cfg.frame_length


def test_reference_crud_and_clone(engine):
    wav_bytes = make_wav_bytes()

    async def fn(client):
        out = {}
        r = await client.post(
            "/v1/references/add",
            json={"id": "alice", "audio": _b64(wav_bytes), "text": "hello ref"},
        )
        out["add"] = r.status
        r = await client.get(
            "/v1/references/list", headers={"Accept": "application/json"}
        )
        out["list"] = await r.json()
        # duplicate -> 409
        r = await client.post(
            "/v1/references/add",
            json={"id": "alice", "audio": _b64(wav_bytes), "text": "x"},
        )
        out["dup"] = r.status
        # synthesize with the reference
        r = await client.post(
            "/v1/tts",
            json={"text": "cloned", "max_new_tokens": 8, "reference_id": "alice"},
        )
        out["tts"] = r.status
        r = await client.delete("/v1/references/delete", json={"id": "alice"})
        out["del"] = r.status
        r = await client.get(
            "/v1/references/list", headers={"Accept": "application/json"}
        )
        out["list2"] = await r.json()
        return out

    out = run_client(engine, fn)
    assert out["add"] == 200
    assert out["list"]["reference_ids"] == ["alice"]
    assert out["dup"] == 409
    assert out["tts"] == 200
    assert out["del"] == 200
    assert out["list2"]["reference_ids"] == []


def test_ui_served(engine):
    async def fn(client):
        r = await client.get("/ui")
        html = await r.text()
        js = await client.get("/ui/static/app.js")
        css = await client.get("/ui/static/style.css")
        fmts = await client.get("/v1/formats")
        return r.status, html, js.status, await js.text(), css.status, \
            fmts.status, await fmts.json()

    status, html, js_status, js, css_status, fmt_status, fmts = \
        run_client(engine, fn)
    assert status == 200 and "fish-speech-tpu" in html
    # all [[label]] tokens substituted through i18n
    assert "[[" not in html
    # product-parity controls: format picker, seed, reference library browser
    for control in ('id="format"', 'id="seed"', 'id="ref_table"',
                    'id="dropzone"', 'id="streaming"'):
        assert control in html, control
    assert js_status == 200 and css_status == 200
    # in-browser streaming playback machinery is present in the app script
    for needle in ("AudioContext", "getReader", "createBufferSource",
                   "/v1/references/list", "/v1/references/delete",
                   "/v1/formats"):
        assert needle in js, needle
    assert fmt_status == 200
    assert {"wav", "pcm", "flac"} <= set(fmts["formats"])
    _assert_js_brackets_balanced(js)


def _assert_js_brackets_balanced(src: str):
    """No JS engine exists in this image, so as a syntax backstop verify
    every brace/paren/bracket balances outside strings and comments."""
    pairs = {")": "(", "]": "[", "}": "{"}
    stack = []
    i, n = 0, len(src)
    state = None  # None | quote char | "line" | "block"
    while i < n:
        c = src[i]
        if state in ("'", '"', "`"):
            if c == "\\":
                i += 2
                continue
            if c == state:
                state = None
        elif state == "line":
            if c == "\n":
                state = None
        elif state == "block":
            if src.startswith("*/", i):
                state = None
                i += 1
        elif c in "'\"`":
            state = c
        elif src.startswith("//", i):
            state = "line"
        elif src.startswith("/*", i):
            state = "block"
        elif c in "([{":
            stack.append(c)
        elif c in ")]}":
            assert stack and stack[-1] == pairs[c], \
                f"unbalanced {c!r} at byte {i}"
            stack.pop()
        i += 1
    assert not stack, f"unclosed {stack!r}"
    assert state is None, f"unterminated {state!r}"


def _b64(b):
    import base64

    return base64.b64encode(b).decode()


def test_metrics_endpoint(engine):
    """/v1/metrics: request counters + in-flight (SURVEY §5.5 serving
    observability; the reference has no metrics endpoint)."""
    async def fn(client):
        before = await (await client.get("/v1/metrics")).json()
        r = await client.post(
            "/v1/tts", json={"text": "metrics probe", "max_new_tokens": 8}
        )
        assert r.status == 200
        await r.read()
        after = await (await client.get("/v1/metrics")).json()
        return before, after

    before, after = run_client(engine, fn)
    for key in ("requests_total", "completed", "cancelled", "errors",
                "rejected", "inflight"):
        assert key in before, key
    assert after["requests_total"] == before["requests_total"] + 1
    assert after["completed"] == before["completed"] + 1
    assert after["inflight"] == 0


def test_metrics_prometheus_format(engine):
    """?format=prometheus (or Accept: text/plain) renders the same counters
    in Prometheus text exposition so a stock scraper works unmodified."""
    async def fn(client):
        r = await client.get("/v1/metrics?format=prometheus")
        assert r.status == 200
        assert "text/plain" in r.headers["Content-Type"]
        body = await r.text()
        r2 = await client.get("/v1/metrics", headers={"Accept": "text/plain"})
        return body, await r2.text()

    body, body2 = run_client(engine, fn)
    for b in (body, body2):
        assert "# TYPE fish_speech_requests_total counter" in b
        assert "# TYPE fish_speech_inflight gauge" in b
        for line in b.strip().splitlines():
            if not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                assert name.startswith("fish_speech_")
                float(value)


def test_backpressure_rejects_over_capacity(engine):
    """--max-inflight: a request over the cap gets an immediate 503 +
    Retry-After instead of queueing unboundedly behind the device."""
    async def fn(client, app):
        app["max_inflight"] = 1
        app["inflight"] = 1  # simulate one in-flight request
        r = await client.post(
            "/v1/tts", json={"text": "over capacity", "max_new_tokens": 4}
        )
        body = await r.json()
        app["inflight"] = 0
        ok = await client.post(
            "/v1/tts", json={"text": "under capacity", "max_new_tokens": 4}
        )
        await ok.read()
        metrics = await (await client.get("/v1/metrics")).json()
        return r.status, r.headers.get("Retry-After"), body, ok.status, metrics

    status, retry_after, body, ok_status, metrics = run_client(engine, fn)
    assert status == 503 and retry_after == "1"
    assert "overloaded" in body["error"]
    assert ok_status == 200
    assert metrics["rejected"] == 1


def test_engine_cancel_check_stops_inference(engine):
    """A cancel_check that trips after the first partial stops generation
    early: no final result, no error result, and far fewer responses than
    the token budget implies (the server wires the client-disconnect event
    here, so a dropped request stops consuming device time)."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    polls = {"n": 0}

    def cancel_after_two():
        polls["n"] += 1
        return polls["n"] > 2

    results = list(engine.inference(TTSRequest(
        text="cancel me mid-generation please",
        max_new_tokens=200, streaming=True,
        cancel_check=cancel_after_two,
    )))
    codes = {r.code for r in results}
    assert "final" not in codes and "error" not in codes
    # header + at most a couple of segments before the trip
    assert sum(1 for r in results if r.code == "segment") <= 2

    # cancelled from the start, non-streaming: nothing at all, no error
    results = list(engine.inference(TTSRequest(
        text="never even starts", max_new_tokens=8,
        cancel_check=lambda: True,
    )))
    assert results == []


def test_malformed_bodies_never_hang_the_server(engine):
    """Garbage request bodies (random bytes, wrong content-types, empty,
    half-valid JSON/msgpack) against every POST endpoint must produce an
    HTTP error response — not a hang or a dead server. Health must still
    answer afterwards."""
    import numpy as np

    rng = np.random.default_rng(0)
    endpoints = ["/v1/tts", "/v1/vqgan/encode", "/v1/vqgan/decode",
                 "/v1/references/add", "/v1/references/update"]
    bodies = [
        b"", b"{", b"\x00\x01\x02\x03", b'{"text": 5}',
        b'{"unexpected": "field"}',
        bytes(rng.integers(0, 256, size=256, dtype=np.uint8)),
        b'"just a string"', b"[1,2,3]",
    ]
    ctypes_ = ["application/json", "application/msgpack",
               "application/octet-stream"]

    async def fn(client):
        n = 0
        for ep in endpoints:
            for body in bodies:
                ct = ctypes_[n % len(ctypes_)]
                n += 1
                r = await client.post(ep, data=body,
                                      headers={"Content-Type": ct})
                assert r.status in (200, 400, 404, 415, 422, 500), \
                    (ep, ct, body[:16], r.status)
                await r.read()
        h = await client.get("/v1/health")
        assert h.status == 200
        return n

    n = run_client(engine, fn)
    assert n == len(endpoints) * len(bodies)


# ---- OpenAI-compatible /v1/audio/speech ----


def test_openai_speech_wav(engine):
    async def fn(client):
        r = await client.post(
            "/v1/audio/speech",
            json={"input": "hello from the openai api", "voice": "alloy",
                  "response_format": "wav", "max_new_tokens": 8},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/wav"
    with wave.open(io.BytesIO(body)) as f:
        assert f.getframerate() == engine.sample_rate
        assert f.getnframes() > 0


def test_openai_speech_pcm_is_24k_and_speed_applies(engine):
    async def fn(client):
        r = await client.post(
            "/v1/audio/speech",
            json={"input": "pcm please", "response_format": "pcm",
                  "speed": 2.0, "max_new_tokens": 8},
        )
        return r.status, await r.read(), r.content_type

    status, body, ctype = run_client(engine, fn)
    assert status == 200 and ctype == "audio/pcm"
    # int16 mono payload, resampled off the model rate onto OpenAI's 24 kHz
    assert len(body) > 0 and len(body) % 2 == 0
    pcm = np.frombuffer(body, dtype="<i2")
    assert np.isfinite(pcm.astype(np.float32)).all()


def test_openai_speech_sse_stream(engine):
    import base64
    import json

    async def fn(client):
        r = await client.post(
            "/v1/audio/speech",
            json={"input": "stream me as sse", "stream_format": "sse",
                  "max_new_tokens": 8},
        )
        assert r.content_type == "text/event-stream"
        raw = await r.read()
        return r.status, raw.decode()

    status, text = run_client(engine, fn)
    assert status == 200
    events = [json.loads(line[len("data: "):])
              for line in text.splitlines() if line.startswith("data: ")]
    deltas = [e for e in events if e["type"] == "speech.audio.delta"]
    dones = [e for e in events if e["type"] == "speech.audio.done"]
    assert deltas and len(dones) == 1
    for d in deltas:
        pcm = base64.b64decode(d["audio"])
        assert len(pcm) > 0 and len(pcm) % 2 == 0
    usage = dones[0]["usage"]
    assert usage["input_tokens"] > 0
    assert usage["total_tokens"] == usage["input_tokens"] + usage["output_tokens"]


def test_openai_speech_unknown_voice_gets_openai_error(engine):
    async def fn(client):
        r = await client.post(
            "/v1/audio/speech",
            json={"input": "hi", "voice": "no-such-voice"},
        )
        return r.status, await r.json()

    status, body = run_client(engine, fn)
    assert status == 400
    assert body["error"]["type"] == "invalid_request_error"
    assert "no-such-voice" in body["error"]["message"]


def test_openai_speech_validation_error_shape(engine):
    async def fn(client):
        r = await client.post(
            "/v1/audio/speech",
            json={"input": "hi", "speed": 9.0},
        )
        return r.status, await r.json()

    status, body = run_client(engine, fn)
    assert status == 400 and body["error"]["type"] == "invalid_request_error"


def test_openai_speech_stored_reference_as_voice(engine):
    wav = make_wav_bytes()

    async def fn(client):
        engine.references.add_reference("openai-voice", wav, "reference text")
        try:
            r = await client.post(
                "/v1/audio/speech",
                json={"input": "cloned voice", "voice": "openai-voice",
                      "response_format": "wav", "max_new_tokens": 8},
            )
            return r.status, await r.read()
        finally:
            engine.references.delete_reference("openai-voice")

    status, body = run_client(engine, fn)
    assert status == 200 and body[:4] == b"RIFF"


# ---- WebSocket live synthesis /v1/tts/live ----


def test_live_ws_session(engine):
    import json

    import aiohttp

    async def fn(client):
        ws = await client.ws_connect("/v1/tts/live")
        await ws.send_json({"event": "start", "max_new_tokens": 8, "seed": 1})
        started = await ws.receive_json()
        assert started["event"] == "started"
        assert started["sample_rate"] == engine.sample_rate

        # fragments crossing a sentence boundary: "Hello world." synthesizes
        # while " And then" keeps buffering
        await ws.send_json({"event": "text", "text": "Hello wor"})
        await ws.send_json({"event": "text", "text": "ld. And then"})
        pcm_bytes = 0
        while True:
            msg = await ws.receive()
            if msg.type == aiohttp.WSMsgType.BINARY:
                pcm_bytes += len(msg.data)
            else:
                data = json.loads(msg.data)
                assert data["event"] == "segment_end", data
                assert data["text"] == "Hello world."
                break
        assert pcm_bytes > 0 and pcm_bytes % 2 == 0

        # stop flushes the remaining buffer, then closes
        await ws.send_json({"event": "stop"})
        pcm2 = 0
        second = None
        done = False
        while True:
            msg = await ws.receive()
            if msg.type == aiohttp.WSMsgType.BINARY:
                pcm2 += len(msg.data)
            elif msg.type == aiohttp.WSMsgType.TEXT:
                data = json.loads(msg.data)
                if data["event"] == "segment_end":
                    second = data["text"]
                elif data["event"] == "done":
                    done = True
                    break
            else:
                break
        assert done and second == "And then" and pcm2 > 0
        await ws.close()

    run_client(engine, fn)


def test_live_ws_flush_and_budget(engine):
    import json

    import aiohttp

    async def fn(client):
        ws = await client.ws_connect("/v1/tts/live")
        # tiny byte budget: terminator-free text force-flushes on its own
        await ws.send_json(
            {"event": "start", "max_new_tokens": 8, "max_buffer": 20}
        )
        assert (await ws.receive_json())["event"] == "started"
        await ws.send_json(
            {"event": "text", "text": "terminator free text that overflows"}
        )
        saw_audio = False
        while True:
            msg = await ws.receive()
            if msg.type == aiohttp.WSMsgType.BINARY:
                saw_audio = True
            else:
                data = json.loads(msg.data)
                assert data["event"] == "segment_end"
                break
        assert saw_audio

        # explicit flush on a short remainder
        await ws.send_json({"event": "text", "text": "tail"})
        await ws.send_json({"event": "flush"})
        events = []
        while True:
            msg = await ws.receive()
            if msg.type == aiohttp.WSMsgType.TEXT:
                events.append(json.loads(msg.data)["event"])
                if events[-1] == "flushed":
                    break
        assert "segment_end" in events
        await ws.close()

    run_client(engine, fn)


def test_live_ws_bad_frames_get_error_events(engine):
    async def fn(client):
        ws = await client.ws_connect("/v1/tts/live")
        await ws.send_str("this is not json")
        err = await ws.receive_json()
        assert err["event"] == "error" and "JSON" in err["message"]
        await ws.send_json({"event": "bogus"})
        err = await ws.receive_json()
        assert err["event"] == "error" and "bogus" in err["message"]
        await ws.send_json({"event": "start", "temperature": 99})
        err = await ws.receive_json()
        assert err["event"] == "error"
        # the session survives bad frames
        await ws.send_json({"event": "stop"})
        done = await ws.receive_json()
        assert done["event"] == "done"
        await ws.close()

    run_client(engine, fn)


def test_vqgan_batch_cache_and_equivalence(engine):
    """The raw-codec surface's LRU + micro-batching (reference
    `tools/server/model_utils.py:31-86`): batched encode == per-item
    encode, repeats hit the cache, batched decode == per-item decode."""
    frame = engine.codec_cfg.frame_length
    # lengths distinct from every other test's make_wav_bytes calls: the
    # module-scoped engine's LRU would otherwise already hold the clip
    wavs = [make_wav_bytes(frame * k) for k in (5, 7, 40)]  # 2 buckets

    m0 = engine.vq_cache_misses
    batch = engine.encode_references_batch(wavs)
    assert engine.vq_cache_misses == m0 + 3
    # batch (rows padded to 4) == single (rows 1): clear the shared LRU so
    # the single path genuinely recomputes instead of returning the cached
    # batch result
    for w, c in zip(wavs, batch):
        engine._vq_cache.clear()
        np.testing.assert_array_equal(c, engine.encode_reference(w))

    engine._vq_cache.clear()
    engine.encode_references_batch(wavs)  # re-prime
    h0 = engine.vq_cache_hits
    again = engine.encode_references_batch([wavs[1], wavs[0]])
    assert engine.vq_cache_hits == h0 + 2
    np.testing.assert_array_equal(again[0], batch[1])
    np.testing.assert_array_equal(again[1], batch[0])

    outs = engine.decode_vq_batch(batch)
    for c, a in zip(batch, outs):
        want = engine.decode_vq_tokens(c)
        assert a.shape == want.shape
        np.testing.assert_allclose(a, want, atol=1e-5)


# ---- the port's own: cancellation, the spec, the entry point ----


def _wav_ok(body: bytes):
    """A valid WAV with whole 16-bit frames of finite samples."""
    with wave.open(io.BytesIO(body), "rb") as f:
        assert f.getnchannels() == 1 and f.getsampwidth() == 2
        n = f.getnframes()
        pcm = np.frombuffer(f.readframes(n), "<i2")
    assert n > 0 and pcm.size == n
    return n


async def _disconnect_mid_stream(client, app, text):
    """Stream a request, read its WAV header and drop the connection; wait
    until the server counts it. Returns the metrics."""
    r = await client.post("/v1/tts", json={"text": text, "streaming": True,
                                           "max_new_tokens": 200})
    assert r.status == 200
    head = await r.content.readexactly(44)
    assert head[:4] == b"RIFF"
    r.close()
    for _ in range(600):
        m = await (await client.get("/v1/metrics")).json()
        if m["cancelled"] + m["completed"] + m["errors"] >= 1 and not m["inflight"]:
            return m
        await asyncio.sleep(0.05)
    raise AssertionError("the dropped request was never counted")


def _run_cancelling(engine, fn):
    async def go():
        app = create_app(engine)
        client = TestClient(TestServer(app, handler_cancellation=True))
        await client.start_server()
        try:
            return await fn(client, app)
        finally:
            await client.close()

    return asyncio.run(go())


def test_client_disconnect_mid_stream_is_cancelled(engine):
    async def fn(client, app):
        m = await _disconnect_mid_stream(client, app, "drop me after the header")
        ok = await client.post("/v1/tts", json={"text": "still serving",
                                                "max_new_tokens": 8})
        return m, ok.status, await ok.read()

    m, status, body = _run_cancelling(engine, fn)
    assert m["cancelled"] == 1 and m["errors"] == 0 and m["inflight"] == 0
    assert status == 200
    _wav_ok(body)


def test_pooled_disconnect_frees_the_row_for_the_next_request(tmp_path):
    from fish_speech_tpu_torch.engine.batcher import (BatcherSession,
                                                      ContinuousBatcher)

    tokenizer = build_test_tokenizer()
    cfg, params, dac_cfg, dac_params = _tiny_models(tokenizer)
    batcher = ContinuousBatcher(params, cfg, SamplingConfig(), pool_size=1,
                                dtype=torch.float32, decode_chunk_size=8,
                                prefix_cache_size=4)
    eng = TTSInferenceEngine(BatcherSession(batcher), tokenizer, dac_params,
                             dac_cfg, references_dir=str(tmp_path))
    try:
        async def fn(client, app):
            m = await _disconnect_mid_stream(client, app, "drop me in the pool")
            for _ in range(600):  # the worker reaps at its next boundary
                if batcher.stats()["active_slots"] == 0:
                    break
                await asyncio.sleep(0.05)
            stats = batcher.stats()
            ok = await client.post("/v1/tts", json={"text": "the freed row",
                                                    "max_new_tokens": 8})
            return m, stats, ok.status, await ok.read()

        m, stats, status, body = _run_cancelling(eng, fn)
    finally:
        batcher.shutdown()
    assert m["cancelled"] == 1 and m["errors"] == 0
    assert stats["active_slots"] == 0 and stats["worker_alive"]
    assert status == 200  # the one row, freed, served the next request
    _wav_ok(body)


def test_openapi_spec_equals_the_jax_servers():
    from fish_speech_tpu.server import openapi as jopenapi
    from fish_speech_tpu_torch.server import openapi as topenapi

    assert topenapi.build_spec() == jopenapi.build_spec()
    assert topenapi.DOCS_HTML == jopenapi.DOCS_HTML


def test_entry_point_flags_follow_the_jax_server():
    from fish_speech_tpu.server import main as jmain
    from fish_speech_tpu_torch.server import main as tmain

    assert vars(tmain.parse_args([])) == vars(jmain.parse_args([]))
    flags = ["--int8", "--kv-int8", "--pool-size", "8", "--prefix-cache", "2",
             "--tiny", "--cpu", "--listen", "0.0.0.0:9000"]
    assert vars(tmain.parse_args(flags)) == vars(jmain.parse_args(flags))
    multi = ["--coordinator", "h:1", "--num-hosts", "2", "--host-id", "0"]
    assert vars(tmain.parse_args(multi)) == vars(jmain.parse_args(multi))
    tmain.check_args(tmain.parse_args(multi), multihost=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        tmain.check_args(tmain.parse_args(multi + ["--int8"]), multihost=True)
    # fp16 is served, alone and under a mesh (tests/test_torch_half.py
    # holds the engine it builds and the int4 refusal)
    tmain.check_args(tmain.parse_args(["--half"]))
    tmain.check_args(tmain.parse_args(multi + ["--half"]), multihost=True)


def test_build_engine_maps_the_flags(tmp_path):
    from fish_speech_tpu_torch.engine.batcher import BatcherSession
    from fish_speech_tpu_torch.server import main as tmain

    base = ["--tiny", "--cpu", "--references-dir", str(tmp_path)]
    eng = tmain.build_engine(tmain.parse_args(base))
    s = eng.session
    assert isinstance(s, GenerationSession) and s.prefix.size == 4
    assert s.first_chunk_size == 8 and s.decode_chunk_size == 64
    assert s.device.type == "cpu" and not s.kv_quant
    eng = tmain.build_engine(tmain.parse_args(
        base + ["--int8", "--kv-int8", "--pool-size", "2", "--prefix-cache", "3"]))
    b = eng.session.batcher
    try:
        assert isinstance(eng.session, BatcherSession)
        assert b.prefix.size == 3 and b.kv_quant and b.pool_size == 2
        assert b.params["layers"]["w13"]["q"].dtype == torch.int8
    finally:
        b.shutdown()
    if not torch.cuda.is_available():  # without --cpu: the card, or a failure
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain.build_engine(tmain.parse_args(["--tiny"]))


def test_warm_up_runs_the_warm_requests(tmp_path):
    from fish_speech_tpu_torch.server import main as tmain

    eng = tmain.build_engine(tmain.parse_args(
        ["--tiny", "--cpu", "--references-dir", str(tmp_path)]))
    tmain.warm_up(eng)
    assert eng.session.eager_runs["decode"] > 0 and eng.codec_eager_runs


def test_the_entry_point_serves_tts_on_the_cpu(tmp_path):
    """`python -m fish_speech_tpu_torch.server.main --tiny --cpu` answers
    /v1/tts over a real socket."""
    import os
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fish_speech_tpu_torch.server.main", "--tiny",
         "--cpu", "--no-warmup", "--listen", f"127.0.0.1:{port}",
         "--references-dir", str(tmp_path)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        url = f"http://127.0.0.1:{port}"
        for _ in range(1800):  # the import of torch can take a while under load
            try:
                urllib.request.urlopen(url + "/v1/health", timeout=1).read()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
                time.sleep(0.1)
        req = urllib.request.Request(
            url + "/v1/tts", data=b'{"text": "hello", "max_new_tokens": 8}',
            headers={"Content-Type": "application/json"})
        body = urllib.request.urlopen(req, timeout=120).read()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    _wav_ok(body)
