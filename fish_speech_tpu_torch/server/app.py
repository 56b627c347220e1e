"""HTTP API server (aiohttp + msgpack): the port's copy of
`fish_speech_tpu/server/app.py`, serving the port's engine
(`engine/tts.py`). Every route is the original's.

Endpoint and wire-format parity with the reference server
(`tools/api_server.py`, `tools/server/views.py`):

  GET/POST /v1/health
  POST /v1/tts                  msgpack|json body -> WAV bytes, or
                                streaming WAV header + int16 PCM chunks
  POST /v1/audio/speech         OpenAI-compatible synthesis (JSON body,
                                OpenAI SDK drop-in: voice names or stored
                                reference ids, pitch-preserving speed,
                                SSE streaming via stream_format="sse")
  GET  /v1/tts/live             WebSocket live synthesis: stream text
                                fragments in (LLM output, typing), get
                                per-utterance PCM streamed back while
                                later text is still arriving
  POST /v1/vqgan/encode         {audios: [wav bytes]} -> {tokens}
  POST /v1/vqgan/decode         {tokens} -> {audios: [float16 pcm bytes]}
  POST /v1/references/add       multipart|msgpack|json
  GET  /v1/references/list
  DELETE /v1/references/delete
  POST /v1/references/update
  GET  /v1/formats              {formats: [...]} actual encoder backends
  GET  /v1/metrics              request counters + in-flight + pool state
  GET  /v1/openapi.json         OpenAPI 3.1 spec built from the pydantic
                                models (open under auth; /docs needs it)
  GET  /docs                    self-contained API docs viewer (no CDN)
  GET  /ui                      built-in web UI (static/, i18n-localized;
                                streams + plays in-browser via WebAudio,
                                reference library browser, format picker)

Bearer-token auth via --api-key. Generation runs in a worker thread (a
single-stream engine serializes device access; a pooled one serves requests
at once); streaming chunks flow through an asyncio queue. A client that
disconnects sets its request's cancel event, which the engine polls
between decode chunks.
"""

from __future__ import annotations

import asyncio
import io
import logging
import threading
from pathlib import Path
from typing import Optional

import msgpack
import numpy as np
import pydantic
from aiohttp import web

from fish_speech_tpu_torch.audio import transcode
from fish_speech_tpu_torch.audio.io import write_wav
from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine, TTSRequest
from fish_speech_tpu_torch.server.schema import (
    AddReferenceRequest,
    AddReferenceResponse,
    DeleteReferenceResponse,
    ListReferencesResponse,
    ServeReferenceAudio,
    ServeTTSRequest,
    ServeVQGANDecodeRequest,
    ServeVQGANEncodeRequest,
    UpdateReferenceResponse,
)

logger = logging.getLogger(__name__)

AMPLITUDE = 32768  # int16 full scale for streamed PCM chunks
OPENAI_PCM_SR = 24000  # the OpenAI audio API's pcm/SSE sample-rate contract


def _msgpack_response(model, status: int = 200) -> web.Response:
    return web.Response(
        body=msgpack.packb(model.model_dump(), use_bin_type=True),
        status=status,
        content_type="application/msgpack",
    )


def _negotiated_response(request: web.Request, model, status: int = 200):
    accept = request.headers.get("Accept", "")
    if "application/json" in accept:
        return web.json_response(_jsonable(model.model_dump()), status=status)
    return _msgpack_response(model, status)


def _jsonable(obj):
    if isinstance(obj, bytes):
        import base64

        return base64.b64encode(obj).decode()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jsonable(v) for v in obj]
    return obj


async def _parse_body(request: web.Request) -> dict:
    ctype = request.content_type
    if ctype == "application/msgpack":
        return msgpack.unpackb(await request.read(), raw=False)
    if ctype == "application/json":
        return await request.json()
    if ctype == "multipart/form-data":
        data = {}
        async for part in await request.multipart():
            if part.name is None:
                continue
            if part.filename:
                data[part.name] = await part.read(decode=False)
            else:
                data[part.name] = (await part.read(decode=False)).decode()
        return data
    raise web.HTTPUnsupportedMediaType(
        headers={"Accept": "application/msgpack, application/json, multipart/form-data"}
    )


@web.middleware
async def error_middleware(request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except (pydantic.ValidationError, ValueError) as e:
        # malformed request body/fields are client errors (the reference's
        # FastAPI layer returns 422 for these; we use 400 consistently)
        return web.json_response({"error": str(e)}, status=400)
    except Exception as e:
        logger.exception("Unhandled error in %s", request.path)
        return web.json_response({"error": str(e)}, status=500)


def make_auth_middleware(api_key: Optional[str]):
    @web.middleware
    async def auth_middleware(request, handler):
        # the spec is static metadata (no secrets) and /docs needs it
        if (api_key and request.path.startswith("/v1/")
                and request.path != "/v1/openapi.json"):
            auth = request.headers.get("Authorization", "")
            if auth != f"Bearer {api_key}":
                return web.json_response({"error": "Unauthorized"}, status=401)
        return await handler(request)

    return auth_middleware


_STATIC_DIR = Path(__file__).parent / "static"


def _render_ui_html() -> str:
    """Load the static single-page UI and substitute its [[...]] label
    tokens through the i18n table (the reference localizes its Gradio UI
    the same way, `tools/webui/__init__.py:22-153`)."""
    from fish_speech_tpu_torch.i18n import i18n

    # literal keys so `python -m fish_speech_tpu_torch.i18n.scan` finds them
    labels = {
        "TPU-native text-to-speech": i18n("TPU-native text-to-speech"),
        "Synthesize": i18n("Synthesize"),
        "Stop": i18n("Stop"),
        "Text": i18n("Text"),
        "Temperature": i18n("Temperature"),
        "Top-P": i18n("Top-P"),
        "Repetition Penalty": i18n("Repetition Penalty"),
        "Max new tokens": i18n("Max new tokens"),
        "Chunk length (bytes)": i18n("Chunk length (bytes)"),
        "Seed": i18n("Seed"),
        "Format": i18n("Format"),
        "Reference ID": i18n("Reference ID"),
        "Stream & play as it generates": i18n("Stream & play as it generates"),
        "Reference Library": i18n("Reference Library"),
        "voice cloning": i18n("voice cloning"),
        "Drop a .wav/.flac file here or click to choose":
            i18n("Drop a .wav/.flac file here or click to choose"),
        "Reference Text": i18n("Reference Text"),
        "Save as ID": i18n("Save as ID"),
        "Save reference": i18n("Save reference"),
    }
    html = (_STATIC_DIR / "index.html").read_text()
    for key, val in labels.items():
        html = html.replace(f"[[{key}]]", val)
    return html


def create_app(engine: TTSInferenceEngine, api_key: Optional[str] = None,
               max_text_length: int = 0,
               max_inflight: int = 0) -> web.Application:
    app = web.Application(
        middlewares=[make_auth_middleware(api_key), error_middleware],
        client_max_size=256 * 1024 * 1024,
    )
    app["engine"] = engine
    app["max_text_length"] = max_text_length
    # backpressure: >0 caps concurrent /v1/tts requests; excess gets 503
    # immediately instead of queueing unboundedly behind the device
    app["max_inflight"] = max_inflight
    app["inflight"] = 0
    app["metrics"] = {
        "requests_total": 0,
        "completed": 0,
        "cancelled": 0,
        "errors": 0,
        "rejected": 0,
    }

    async def health(request):
        return web.json_response({"status": "ok"})

    async def metrics(request):
        """Point-in-time serving observability: request counters, in-flight
        count, and (under a pooled engine) continuous-batcher pool state.
        The reference exposes no metrics endpoint; SGLang-style serving
        stacks do, and operators need it to drive autoscaling/alerting.

        JSON by default; Prometheus text exposition when the client asks
        (`?format=prometheus` or an `Accept: text/plain` header) so a
        standard scraper can point at /v1/metrics unmodified."""
        m = dict(app["metrics"])
        m["inflight"] = app["inflight"]
        batcher = getattr(getattr(engine, "session", None), "batcher", None)
        if batcher is not None:
            m["pool"] = batcher.stats()
        wants_prom = (
            request.query.get("format") == "prometheus"
            or "text/plain" in request.headers.get("Accept", "")
        )
        if not wants_prom:
            return web.json_response(m)
        lines = []
        counters = {"requests_total", "completed", "cancelled", "errors",
                    "rejected"}

        def emit(name, value, kind):
            lines.append(f"# TYPE fish_speech_{name} {kind}")
            lines.append(f"fish_speech_{name} {value}")

        for k, v in m.items():
            if k == "pool":
                continue
            emit(k, v, "counter" if k in counters else "gauge")
        for k, v in m.get("pool", {}).items():
            emit(f"pool_{k}", int(v), "gauge")
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain", charset="utf-8")

    async def ui(request):
        return web.Response(text=_render_ui_html(), content_type="text/html")

    async def formats(request):
        return web.json_response({"formats": transcode.available_formats()})

    async def tts(request):
        data = await _parse_body(request)
        req_model = ServeTTSRequest(**data)
        if max_text_length > 0 and len(req_model.text) > max_text_length:
            return web.json_response(
                {"error": f"Text is too long, max length is {max_text_length}"},
                status=400,
            )
        if req_model.streaming and req_model.format != "wav":
            return web.json_response(
                {"error": "Streaming only supports WAV format"}, status=400
            )
        if req_model.format not in ("wav", "pcm") and (
            req_model.format not in transcode.available_formats()
        ):
            return web.json_response(
                {
                    "error": (
                        f"Format {req_model.format!r} has no encoder backend; "
                        f"available: {transcode.available_formats()}"
                    )
                },
                status=400,
            )

        ereq = TTSRequest(
            text=req_model.text,
            chunk_length=req_model.chunk_length,
            format=req_model.format,
            references=[
                ServeReferenceAudio(audio=r.audio, text=r.text)
                if not isinstance(r, ServeReferenceAudio)
                else r
                for r in req_model.references
            ],
            reference_id=req_model.reference_id,
            seed=req_model.seed,
            use_memory_cache=req_model.use_memory_cache,
            normalize=req_model.normalize,
            streaming=req_model.streaming,
            max_new_tokens=req_model.max_new_tokens,
            top_p=req_model.top_p,
            repetition_penalty=req_model.repetition_penalty,
            temperature=req_model.temperature,
        )

        if app["max_inflight"] > 0 and app["inflight"] >= app["max_inflight"]:
            app["metrics"]["rejected"] += 1
            return web.json_response(
                {"error": "server overloaded, retry later"},
                status=503,
                headers={"Retry-After": "1"},
            )

        # Client-disconnect cancellation: aiohttp cancels this handler task
        # when the peer drops, raising CancelledError at the next await; the
        # finally sets the event, the worker loop stops forwarding, and the
        # engine/batcher poll the event between decode chunks — an abandoned
        # request stops consuming device time at chunk granularity instead
        # of decoding its whole budget for nobody.
        cancel_ev = threading.Event()
        ereq.cancel_check = cancel_ev.is_set

        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def worker():
            try:
                for result in engine.inference(ereq):
                    if cancel_ev.is_set():
                        break
                    loop.call_soon_threadsafe(queue.put_nowait, result)
            finally:
                loop.call_soon_threadsafe(queue.put_nowait, None)

        app["metrics"]["requests_total"] += 1
        app["inflight"] += 1
        outcome = "cancelled"  # overwritten unless the handler is abandoned
        try:
            fut = loop.run_in_executor(None, worker)

            if ereq.streaming:
                response = web.StreamResponse(
                    headers={
                        "Content-Type": "audio/wav",
                        "Content-Disposition": "attachment; filename=audio.wav",
                    }
                )
                await response.prepare(request)
                while True:
                    result = await queue.get()
                    if result is None:
                        break
                    if result.code == "header":
                        await response.write(result.audio[1].tobytes())
                    elif result.code == "segment":
                        pcm = (result.audio[1] * AMPLITUDE).astype(np.int16)
                        await response.write(pcm.tobytes())
                    elif result.code == "error":
                        logger.error("stream error: %s", result.error)
                        outcome = "errors"
                        break
                await fut
                await response.write_eof()
                if outcome != "errors":
                    outcome = "completed"
                return response

            final = None
            error = None
            while True:
                result = await queue.get()
                if result is None:
                    break
                if result.code == "final":
                    final = result
                elif result.code == "error":
                    error = result
            await fut
            if final is None:
                msg = str(error.error) if error else "No audio generated"
                outcome = "errors"
                return web.json_response({"error": msg}, status=500)
            outcome = "completed"
        except asyncio.CancelledError:
            raise  # genuine client disconnect — stays "cancelled"
        except Exception:
            # an unexpected server fault (e.g. the worker future re-raising)
            # must count as an error, not a client cancellation
            outcome = "errors"
            raise
        finally:
            app["inflight"] -= 1
            app["metrics"][outcome] += 1
            if outcome != "completed":
                # abandoned OR faulted: stop the worker forwarding loop so the
                # engine/batcher cancel poll fires at the next decode chunk
                cancel_ev.set()

        sr, audio = final.audio
        if ereq.format == "pcm":
            body = (np.clip(audio, -1, 1) * AMPLITUDE).astype(np.int16).tobytes()
            ctype = "audio/pcm"
        elif ereq.format == "wav":
            buf = io.BytesIO()
            _write_wav_buffer(buf, audio, sr)
            body = buf.getvalue()
            ctype = "audio/wav"
        else:
            try:
                body = transcode.encode_audio(audio, sr, ereq.format)
            except transcode.TranscodeUnavailable as e:
                return web.json_response({"error": str(e)}, status=400)
            ctype = {
                "flac": "audio/flac", "mp3": "audio/mpeg", "opus": "audio/opus"
            }[ereq.format]
        return web.Response(
            body=body,
            content_type=ctype,
            headers={
                "Content-Disposition": f"attachment; filename=audio.{ereq.format}"
            },
        )

    def _openai_error(message: str, status: int = 400,
                      etype: str = "invalid_request_error") -> web.Response:
        # OpenAI SDKs parse {"error": {"message", "type"}} bodies
        return web.json_response(
            {"error": {"message": message, "type": etype}}, status=status
        )

    async def openai_speech(request):
        """OpenAI-compatible `POST /v1/audio/speech` (drop-in for OpenAI SDK
        clients; the reference has no such route). JSON body per
        `OpenAISpeechRequest`; returns audio bytes, or SSE
        `speech.audio.delta`/`speech.audio.done` events when
        `stream_format == "sse"`. `speed` is applied host-side as a
        pitch-preserving WSOLA tempo change (`audio/stretch.py`). `pcm`
        output and SSE deltas are resampled to OpenAI's 24 kHz contract;
        container formats keep the model's native rate."""
        from fish_speech_tpu_torch.audio.io import resample
        from fish_speech_tpu_torch.audio.stretch import time_stretch
        from fish_speech_tpu_torch.server.schema import OpenAISpeechRequest

        try:
            req = OpenAISpeechRequest(**await _parse_body(request))
        except pydantic.ValidationError as e:
            return _openai_error(str(e))

        reference_id = None
        if req.voice not in OpenAISpeechRequest.BUILTIN_VOICES:
            if req.voice in engine.references.list_references():
                reference_id = req.voice
            else:
                return _openai_error(
                    f"voice {req.voice!r} is neither an OpenAI built-in "
                    f"voice name nor a stored reference id"
                )
        fmt = req.response_format
        if fmt not in ("wav", "pcm") and fmt not in transcode.available_formats():
            return _openai_error(
                f"response_format {fmt!r} has no encoder backend; available: "
                f"{['wav', 'pcm'] + transcode.available_formats()}"
            )
        if max_text_length > 0 and len(req.input) > max_text_length:
            return _openai_error(
                f"input is too long, max length is {max_text_length}"
            )

        if app["max_inflight"] > 0 and app["inflight"] >= app["max_inflight"]:
            app["metrics"]["rejected"] += 1
            return _openai_error(
                "server overloaded, retry later", status=503,
                etype="server_error",
            )

        sse = req.stream_format == "sse"
        ereq = TTSRequest(
            text=req.input,
            reference_id=reference_id,
            use_memory_cache="on" if reference_id else "off",
            streaming=sse,
            max_new_tokens=req.max_new_tokens,
        )
        cancel_ev = threading.Event()
        ereq.cancel_check = cancel_ev.is_set

        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def worker():
            try:
                for result in engine.inference(ereq):
                    if cancel_ev.is_set():
                        break
                    loop.call_soon_threadsafe(queue.put_nowait, result)
            finally:
                loop.call_soon_threadsafe(queue.put_nowait, None)

        app["metrics"]["requests_total"] += 1
        app["inflight"] += 1
        outcome = "cancelled"
        try:
            fut = loop.run_in_executor(None, worker)

            if sse:
                import base64
                import json as _json

                response = web.StreamResponse(
                    headers={
                        "Content-Type": "text/event-stream",
                        "Cache-Control": "no-cache",
                    }
                )
                await response.prepare(request)
                n_samples = 0
                while True:
                    result = await queue.get()
                    if result is None:
                        break
                    if result.code == "segment":
                        seg = result.audio[1]
                        n_samples += len(seg)
                        if req.speed != 1.0:
                            seg = time_stretch(seg, req.speed)
                        seg = resample(seg, engine.sample_rate, OPENAI_PCM_SR)
                        pcm = (np.clip(seg, -1, 1) * AMPLITUDE).astype(np.int16)
                        event = {
                            "type": "speech.audio.delta",
                            "audio": base64.b64encode(pcm.tobytes()).decode(),
                        }
                        await response.write(
                            f"data: {_json.dumps(event)}\n\n".encode()
                        )
                    elif result.code == "error":
                        logger.error("sse error: %s", result.error)
                        outcome = "errors"
                        event = {
                            "type": "error",
                            "error": {"message": str(result.error),
                                      "type": "server_error"},
                        }
                        await response.write(
                            f"data: {_json.dumps(event)}\n\n".encode()
                        )
                        break
                await fut
                if outcome != "errors":
                    done = {
                        "type": "speech.audio.done",
                        "usage": {
                            "input_tokens": len(
                                engine.tokenizer.encode(req.input)
                            ),
                            "output_tokens": n_samples
                            // engine.codec_cfg.frame_length,
                            "total_tokens": 0,
                        },
                    }
                    done["usage"]["total_tokens"] = (
                        done["usage"]["input_tokens"]
                        + done["usage"]["output_tokens"]
                    )
                    await response.write(
                        f"data: {_json.dumps(done)}\n\n".encode()
                    )
                    outcome = "completed"
                await response.write_eof()
                return response

            final = None
            error = None
            while True:
                result = await queue.get()
                if result is None:
                    break
                if result.code == "final":
                    final = result
                elif result.code == "error":
                    error = result
            await fut
            if final is None:
                outcome = "errors"
                msg = str(error.error) if error else "No audio generated"
                return _openai_error(msg, status=500, etype="server_error")
            outcome = "completed"
        except asyncio.CancelledError:
            raise
        except Exception:
            outcome = "errors"
            raise
        finally:
            app["inflight"] -= 1
            app["metrics"][outcome] += 1
            if outcome != "completed":
                cancel_ev.set()

        sr, audio = final.audio
        if req.speed != 1.0:
            audio = time_stretch(audio, req.speed)
        if fmt == "pcm":
            audio = resample(audio, sr, OPENAI_PCM_SR)
            body = (np.clip(audio, -1, 1) * AMPLITUDE).astype(np.int16).tobytes()
            ctype = "audio/pcm"
        elif fmt == "wav":
            buf = io.BytesIO()
            _write_wav_buffer(buf, audio, sr)
            body = buf.getvalue()
            ctype = "audio/wav"
        else:
            try:
                body = transcode.encode_audio(audio, sr, fmt)
            except transcode.TranscodeUnavailable as e:
                return _openai_error(str(e))
            ctype = {
                "flac": "audio/flac", "mp3": "audio/mpeg", "opus": "audio/opus"
            }[fmt]
        return web.Response(body=body, content_type=ctype)

    async def tts_live(request):
        """WebSocket live synthesis: text fragments in, PCM out.

        The shape LLM→TTS pipelines need (neither the reference nor its
        SGLang integration serves it): the client streams text as it is
        produced, the server cuts at sentence boundaries
        (`utils/textseg.split_ready`) and streams each utterance's audio
        back while later text is still arriving.

        Client → server (JSON text frames):
          {"event": "start", ...LiveStartEvent}   optional, first
          {"event": "text", "text": "..."}        append a fragment
          {"event": "flush"}                      synthesize the buffer now
          {"event": "stop"}                       flush, finish, close

        Server → client: binary frames of int16 PCM at the model's native
        rate, interleaved with JSON markers — {"event": "started",
        "sample_rate": N}, {"event": "segment_end", "text": t} after each
        utterance, {"event": "flushed"}, {"event": "done"},
        {"event": "error", "message": m}.

        Utterances synthesize sequentially in arrival order; a dropped
        socket cancels the in-flight generation at the next decode chunk.
        Each utterance is an independent request sharing the session's
        voice/seed — prosody does not carry across utterance boundaries
        (the offline `/v1/tts` route carries conversation context across
        its internal chunks; live input trades that for latency).
        """
        import json

        from fish_speech_tpu_torch.server.schema import LiveStartEvent
        from fish_speech_tpu_torch.utils.textseg import split_ready

        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)

        if app["max_inflight"] > 0 and app["inflight"] >= app["max_inflight"]:
            app["metrics"]["rejected"] += 1
            await ws.send_json(
                {"event": "error", "message": "server overloaded, retry later"}
            )
            await ws.close()
            return ws

        opts = LiveStartEvent()
        buf = ""
        loop = asyncio.get_running_loop()
        cancel_ev = threading.Event()
        app["metrics"]["requests_total"] += 1
        app["inflight"] += 1
        outcome = "cancelled"

        async def synth(text: str) -> bool:
            ereq = TTSRequest(
                text=text,
                streaming=True,
                reference_id=opts.reference_id,
                use_memory_cache="on" if opts.reference_id else "off",
                temperature=opts.temperature,
                top_p=opts.top_p,
                seed=opts.seed,
                max_new_tokens=opts.max_new_tokens,
            )
            ereq.cancel_check = cancel_ev.is_set
            queue: asyncio.Queue = asyncio.Queue()

            def worker():
                try:
                    for result in engine.inference(ereq):
                        if cancel_ev.is_set():
                            break
                        loop.call_soon_threadsafe(queue.put_nowait, result)
                finally:
                    loop.call_soon_threadsafe(queue.put_nowait, None)

            fut = loop.run_in_executor(None, worker)
            ok = True
            while True:
                result = await queue.get()
                if result is None:
                    break
                if result.code == "segment":
                    pcm = (
                        np.clip(result.audio[1], -1, 1) * AMPLITUDE
                    ).astype(np.int16)
                    await ws.send_bytes(pcm.tobytes())
                elif result.code == "error":
                    logger.error("live synth error: %s", result.error)
                    await ws.send_json(
                        {"event": "error", "message": str(result.error)}
                    )
                    ok = False
            await fut
            if ok:
                await ws.send_json({"event": "segment_end", "text": text})
            return ok

        try:
            async for msg in ws:
                if msg.type != web.WSMsgType.TEXT:
                    if msg.type == web.WSMsgType.ERROR:
                        break
                    continue
                try:
                    data = json.loads(msg.data)
                    event = data.get("event")
                except (ValueError, AttributeError):
                    await ws.send_json(
                        {"event": "error", "message": "frames must be JSON"}
                    )
                    continue
                if event == "start":
                    try:
                        opts = LiveStartEvent(
                            **{k: v for k, v in data.items() if k != "event"}
                        )
                    except pydantic.ValidationError as e:
                        await ws.send_json(
                            {"event": "error", "message": str(e)}
                        )
                        continue
                    await ws.send_json(
                        {"event": "started", "sample_rate": engine.sample_rate}
                    )
                elif event == "text":
                    buf += str(data.get("text", ""))
                    ready, buf = split_ready(buf, max_buffer=opts.max_buffer)
                    if ready and not await synth(ready):
                        outcome = "errors"
                        break
                elif event in ("flush", "stop"):
                    ready, buf = split_ready(buf, force=True)
                    if ready and not await synth(ready):
                        outcome = "errors"
                        break
                    if event == "stop":
                        await ws.send_json({"event": "done"})
                        outcome = "completed"
                        break
                    await ws.send_json({"event": "flushed"})
                else:
                    await ws.send_json(
                        {"event": "error",
                         "message": f"unknown event {event!r}"}
                    )
        finally:
            cancel_ev.set()
            app["inflight"] -= 1
            app["metrics"][outcome] += 1
            if not ws.closed:
                await ws.close()
        return ws

    async def vqgan_encode(request):
        # LRU-cached + micro-batched (engine.encode_references_batch;
        # reference `tools/server/model_utils.py:51-66`): repeated clips
        # skip the codec entirely, fresh ones share batched encodes.
        data = await _parse_body(request)
        req_model = ServeVQGANEncodeRequest(**data)
        loop = asyncio.get_running_loop()
        codes = await loop.run_in_executor(
            None, lambda: engine.encode_references_batch(req_model.audios)
        )
        from fish_speech_tpu_torch.server.schema import ServeVQGANEncodeResponse

        return _msgpack_response(
            ServeVQGANEncodeResponse(tokens=[c.tolist() for c in codes])
        )

    async def vqgan_decode(request):
        data = await _parse_body(request)
        req_model = ServeVQGANDecodeRequest(**data)
        loop = asyncio.get_running_loop()

        def run():
            toks = [np.asarray(t, dtype=np.int32) for t in req_model.tokens]
            return [a.astype(np.float16).tobytes()
                    for a in engine.decode_vq_batch(toks)]

        audios = await loop.run_in_executor(None, run)
        from fish_speech_tpu_torch.server.schema import ServeVQGANDecodeResponse

        return _msgpack_response(ServeVQGANDecodeResponse(audios=audios))

    async def references_add(request):
        data = await _parse_body(request)
        try:
            req_model = AddReferenceRequest(**data)
            engine.references.add_reference(
                req_model.id, req_model.audio, req_model.text
            )
            resp = AddReferenceResponse(
                success=True,
                message=f"Reference voice '{req_model.id}' added successfully",
                reference_id=req_model.id,
            )
            return _negotiated_response(request, resp)
        except FileExistsError:
            resp = AddReferenceResponse(
                success=False,
                message=f"Reference ID '{data.get('id')}' already exists",
                reference_id=str(data.get("id")),
            )
            return _negotiated_response(request, resp, status=409)
        except (ValueError, KeyError) as e:
            resp = AddReferenceResponse(
                success=False, message=str(e), reference_id=str(data.get("id"))
            )
            return _negotiated_response(request, resp, status=400)

    async def references_list(request):
        ids = engine.references.list_references()
        return _negotiated_response(
            request, ListReferencesResponse(success=True, reference_ids=ids)
        )

    async def references_delete(request):
        data = await _parse_body(request)
        ref_id = str(data.get("id", ""))
        try:
            engine.references.delete_reference(ref_id)
            resp = DeleteReferenceResponse(
                success=True,
                message=f"Reference voice '{ref_id}' deleted successfully",
                reference_id=ref_id,
            )
            return _negotiated_response(request, resp)
        except FileNotFoundError:
            resp = DeleteReferenceResponse(
                success=False,
                message=f"Reference ID '{ref_id}' not found",
                reference_id=ref_id,
            )
            return _negotiated_response(request, resp, status=404)

    async def references_update(request):
        data = await _parse_body(request)
        old_id = str(data.get("old_id", data.get("id", "")))
        new_id = str(data.get("new_id", old_id))
        try:
            engine.references.update_reference(
                old_id, new_id, data.get("audio"), data.get("text")
            )
            resp = UpdateReferenceResponse(
                success=True,
                message="Reference updated",
                old_reference_id=old_id,
                new_reference_id=new_id,
            )
            return _negotiated_response(request, resp)
        except FileNotFoundError:
            resp = UpdateReferenceResponse(
                success=False,
                message=f"Reference ID '{old_id}' not found",
                old_reference_id=old_id,
                new_reference_id=new_id,
            )
            return _negotiated_response(request, resp, status=404)

    # built lazily in a closure (NOT stored on `app`: aiohttp forbids
    # mutating application state after startup freezes it)
    _spec_cache = []

    async def openapi_json(request):
        from fish_speech_tpu_torch.server.openapi import build_spec

        if not _spec_cache:
            _spec_cache.append(build_spec())
        return web.json_response(_spec_cache[0])

    async def docs(request):
        from fish_speech_tpu_torch.server.openapi import DOCS_HTML

        return web.Response(text=DOCS_HTML, content_type="text/html")

    app.router.add_get("/v1/health", health)
    app.router.add_post("/v1/health", health)
    app.router.add_get("/v1/metrics", metrics)
    app.router.add_get("/v1/openapi.json", openapi_json)
    app.router.add_get("/docs", docs)
    app.router.add_get("/ui", ui)
    app.router.add_static("/ui/static/", _STATIC_DIR)
    app.router.add_get("/v1/formats", formats)
    app.router.add_post("/v1/tts", tts)
    app.router.add_post("/v1/audio/speech", openai_speech)
    app.router.add_get("/v1/tts/live", tts_live)
    app.router.add_post("/v1/vqgan/encode", vqgan_encode)
    app.router.add_post("/v1/vqgan/decode", vqgan_decode)
    app.router.add_post("/v1/references/add", references_add)
    app.router.add_get("/v1/references/list", references_list)
    app.router.add_delete("/v1/references/delete", references_delete)
    app.router.add_post("/v1/references/update", references_update)
    return app


def _write_wav_buffer(buf, audio: np.ndarray, sr: int):
    import wave

    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
