"""OpenAPI 3.1 spec + self-contained docs page for the HTTP API.
(The port's copy of `fish_speech_tpu/server/openapi.py`.)

The reference server mounts kui's auto-generated OpenAPI routes
(`tools/api_server.py:59-66`: spec + docs UI). Here the spec is built from
the SAME pydantic models the handlers validate with
(`model_json_schema(ref_template=...)`), so it cannot drift from the wire
format, and `/docs` serves a zero-dependency vanilla-JS renderer (no CDN —
the server works in egress-free deployments).

Routes (`server/app.py`):
  GET /v1/openapi.json   the spec
  GET /docs              human-readable API docs rendered from the spec
"""

from __future__ import annotations

from fish_speech_tpu_torch.server import schema as S

_REF_TEMPLATE = "#/components/schemas/{model}"

_MODELS = [
    S.ServeReferenceAudio,
    S.ServeTTSRequest,
    S.OpenAISpeechRequest,
    S.ServeVQGANEncodeRequest,
    S.ServeVQGANEncodeResponse,
    S.ServeVQGANDecodeRequest,
    S.ServeVQGANDecodeResponse,
    S.AddReferenceRequest,
    S.AddReferenceResponse,
    S.ListReferencesResponse,
    S.DeleteReferenceResponse,
    S.UpdateReferenceResponse,
]


def _ref(model) -> dict:
    return {"$ref": _REF_TEMPLATE.format(model=model.__name__)}


def _json_body(model, also_msgpack=True) -> dict:
    content = {"application/json": {"schema": _ref(model)}}
    if also_msgpack:
        content["application/msgpack"] = {"schema": _ref(model)}
    return {"required": True, "content": content}


def _json_resp(desc, model=None, media="application/json") -> dict:
    out = {"description": desc}
    if model is not None:
        out["content"] = {media: {"schema": _ref(model)}}
    return out


def build_spec(version: str = "1.0.0") -> dict:
    """Assemble the OpenAPI document from the live pydantic models."""
    components = {}
    for m in _MODELS:
        js = m.model_json_schema(ref_template=_REF_TEMPLATE)
        # pydantic inlines nested defs under $defs; lift them to components
        for name, sub in js.pop("$defs", {}).items():
            components.setdefault(name, sub)
        components[m.__name__] = js

    audio_response = {
        "description": "Encoded audio (non-streaming), or a WAV header "
        "followed by int16 PCM chunks when streaming=true.",
        "content": {
            "audio/wav": {"schema": {"type": "string", "format": "binary"}},
            "audio/mpeg": {"schema": {"type": "string", "format": "binary"}},
            "audio/ogg": {"schema": {"type": "string", "format": "binary"}},
            "audio/flac": {"schema": {"type": "string", "format": "binary"}},
        },
    }

    paths = {
        "/v1/health": {
            "get": {
                "summary": "Liveness probe",
                "responses": {"200": _json_resp("status: ok")},
            },
            "post": {
                "summary": "Liveness probe",
                "responses": {"200": _json_resp("status: ok")},
            },
        },
        "/v1/tts": {
            "post": {
                "summary": "Synthesize speech",
                "description": "Text (+ optional voice-clone references or a "
                "stored reference_id) to audio. streaming=true "
                "delivers a WAV header then raw PCM per decode "
                "chunk (wav format only).",
                "requestBody": _json_body(S.ServeTTSRequest),
                "responses": {
                    "200": audio_response,
                    "400": _json_resp("Validation error"),
                    "503": _json_resp("Over --max-inflight capacity "
                                      "(Retry-After: 1)"),
                },
            }
        },
        "/v1/audio/speech": {
            "post": {
                "summary": "OpenAI-compatible speech synthesis",
                "description": "Drop-in for OpenAI SDK audio.speech clients. "
                "voice is an OpenAI built-in name (default voice) or a "
                "stored reference id (voice clone); speed is a "
                "pitch-preserving tempo change; stream_format=sse delivers "
                "speech.audio.delta events with base64 24 kHz int16 PCM "
                "then speech.audio.done.",
                "requestBody": _json_body(S.OpenAISpeechRequest,
                                          also_msgpack=False),
                "responses": {
                    "200": {
                        "description": "Audio bytes (audio stream_format) "
                        "or an SSE event stream (sse).",
                        "content": {
                            "audio/mpeg": {"schema": {"type": "string",
                                                      "format": "binary"}},
                            "text/event-stream": {"schema":
                                                  {"type": "string"}},
                        },
                    },
                    "400": _json_resp("OpenAI-style error envelope"),
                    "503": _json_resp("Over --max-inflight capacity"),
                },
            }
        },
        "/v1/vqgan/encode": {
            "post": {
                "summary": "Audio -> codec token matrix",
                "requestBody": _json_body(S.ServeVQGANEncodeRequest),
                "responses": {
                    "200": _json_resp("Tokens", S.ServeVQGANEncodeResponse,
                                      "application/msgpack")
                },
            }
        },
        "/v1/vqgan/decode": {
            "post": {
                "summary": "Codec token matrix -> audio",
                "requestBody": _json_body(S.ServeVQGANDecodeRequest),
                "responses": {
                    "200": _json_resp("float16 PCM payloads",
                                      S.ServeVQGANDecodeResponse,
                                      "application/msgpack")
                },
            }
        },
        "/v1/references/add": {
            "post": {
                "summary": "Store a named voice reference",
                "description": "multipart/form-data (id, text, audio file), "
                "msgpack, or JSON (base64 audio).",
                "requestBody": _json_body(S.AddReferenceRequest),
                "responses": {
                    "200": _json_resp("Stored", S.AddReferenceResponse)
                },
            }
        },
        "/v1/references/list": {
            "get": {
                "summary": "List stored reference ids",
                "responses": {
                    "200": _json_resp("Ids", S.ListReferencesResponse)
                },
            }
        },
        "/v1/references/delete": {
            "delete": {
                "summary": "Delete a stored reference",
                "parameters": [
                    {"name": "reference_id", "in": "query", "required": True,
                     "schema": {"type": "string"}}
                ],
                "responses": {
                    "200": _json_resp("Deleted", S.DeleteReferenceResponse)
                },
            }
        },
        "/v1/references/update": {
            "post": {
                "summary": "Rename a stored reference",
                "parameters": [
                    {"name": "old_id", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "new_id", "in": "query", "required": True,
                     "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": _json_resp("Renamed", S.UpdateReferenceResponse)
                },
            }
        },
        "/v1/formats": {
            "get": {
                "summary": "Audio formats with a live encoder backend",
                "responses": {"200": _json_resp("formats: [...]")},
            }
        },
        "/v1/metrics": {
            "get": {
                "summary": "Serving metrics",
                "description": "Request counters (total/completed/cancelled/"
                "errors/rejected), in-flight count, and continuous-batcher "
                "pool state (active slots, queued, parked rows) when the "
                "server runs with --pool-size > 1. JSON by default; "
                "?format=prometheus (or Accept: text/plain) renders "
                "Prometheus text exposition.",
                "responses": {"200": _json_resp("Metrics snapshot")},
            }
        },
        "/v1/openapi.json": {
            "get": {
                "summary": "This document",
                "security": [],  # served without auth so /docs can load it
                "responses": {"200": _json_resp("OpenAPI 3.1 spec")},
            }
        },
    }

    return {
        "openapi": "3.1.0",
        "info": {
            "title": "fish-speech-tpu API",
            "version": version,
            "description": "TPU-native TTS serving API (wire-compatible "
            "with the reference Fish Speech API).",
        },
        # every /v1 operation (except openapi.json, overridden above)
        # requires the bearer token WHEN the server runs with --api-key;
        # generated clients must send Authorization to avoid 401s
        "security": [{"bearerAuth": []}],
        "paths": paths,
        "components": {
            "schemas": components,
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer"}
            },
        },
    }


DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>fish-speech-tpu API docs</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#fafafa;color:#1a1a1a}
main{max-width:960px;margin:0 auto;padding:2rem 1rem}
h1{font-size:1.5rem} .desc{color:#555}
.op{background:#fff;border:1px solid #ddd;border-radius:8px;margin:1rem 0;padding:.75rem 1rem}
.m{display:inline-block;min-width:4.5em;text-align:center;font-weight:700;
   border-radius:4px;padding:.1em .5em;margin-right:.6em;color:#fff}
.m.get{background:#2e7d32}.m.post{background:#1565c0}.m.delete{background:#c62828}
code.path{font-size:1.05em}
details{margin:.5rem 0} summary{cursor:pointer;color:#333}
pre{background:#f4f4f4;border-radius:6px;padding:.75rem;overflow-x:auto;font-size:.85em}
</style></head><body><main id="root"><h1>fish-speech-tpu API</h1>
<p class="desc">Loading spec from <code>/v1/openapi.json</code>…</p></main>
<script>
fetch('/v1/openapi.json').then(r=>r.json()).then(spec=>{
  const root=document.getElementById('root');
  root.innerHTML='<h1>'+spec.info.title+' <small>v'+spec.info.version+
    '</small></h1><p class="desc">'+(spec.info.description||'')+'</p>';
  for(const [path,ops] of Object.entries(spec.paths)){
    for(const [method,op] of Object.entries(ops)){
      const div=document.createElement('div');div.className='op';
      let html='<span class="m '+method+'">'+method.toUpperCase()+
        '</span><code class="path">'+path+'</code> — '+(op.summary||'');
      if(op.description)html+='<p class="desc">'+op.description+'</p>';
      const dump=o=>'<pre>'+JSON.stringify(o,null,2)
        .replace(/&/g,'&amp;').replace(/</g,'&lt;')+'</pre>';
      if(op.requestBody)html+='<details><summary>Request body</summary>'+
        dump(op.requestBody)+'</details>';
      if(op.parameters)html+='<details><summary>Parameters</summary>'+
        dump(op.parameters)+'</details>';
      html+='<details><summary>Responses</summary>'+dump(op.responses)+
        '</details>';
      div.innerHTML=html;root.appendChild(div);
    }
  }
  const sch=document.createElement('div');
  sch.innerHTML='<h2>Schemas</h2>';
  for(const [name,s] of Object.entries(spec.components.schemas)){
    sch.innerHTML+='<details><summary><code>'+name+
      '</code></summary><pre>'+JSON.stringify(s,null,2)
      .replace(/&/g,'&amp;').replace(/</g,'&lt;')+'</pre></details>';
  }
  root.appendChild(sch);
});
</script></body></html>
"""
