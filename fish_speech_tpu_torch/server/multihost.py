"""Multi-card serving: one server process per card, the LM split over the
(dp=1, tp=all ranks) mesh.

Port of `fish_speech_tpu/server/multihost.py`. Every rank holds its shard of
the same weights (`parallel/mesh.py:shard_params`) and runs every prefill,
decode step and collective of every request in the same order, so each
generation request must be replayed on every rank:

  - Rank 0 (the leader) faces HTTP. `wrap_leader(session, cfg)` intercepts
    `generate_stream`: before the first chunk it broadcasts a fixed-shape
    request descriptor (the prompt, the sampling arguments, the request's
    seed and the streaming-path arguments) to every rank, then delegates to
    the real stream, and if the stream is abandoned (a client disconnect, a
    cancel) it DRAINS the rest of it, so the leader never falls out of
    lockstep with followers that run every request to its end.
  - The other ranks run `follower_loop(session, cfg)`: receive descriptors
    and replay `session.generate_stream(...)` to exhaustion with the same
    arguments, so they walk the same sequence of steps, until the stop
    descriptor (`broadcast_stop`, from the leader's shutdown).

A request the session refuses (`GenerationSession.check_request`) is
refused on the leader before its broadcast, so no rank runs a step of it.
A failure after the broadcast leaves the ranks at different collectives:
a follower lets it end its process, and the leader refuses every later
request without broadcasting, so the process group's timeout ends the
ranks loudly instead of pairing one request's collectives with another's.

Everything after the LM (the codec, transcoding, HTTP) runs on the leader
only: it is local to a rank. The prefix caches stay in step because each
rank's store sees the same request sequence.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fish_speech_tpu_torch.generate import request_seed

logger = logging.getLogger(__name__)

_STOP, _GENERATE = 0, 1
# the descriptor's scalar slots, then the (C+1, max_seq_len) prompt; the
# floats ride as the bits of a float64
_FIELDS = ("kind", "plen", "max_new_tokens", "seed", "top_k", "lookahead",
           "device_partials", "temperature", "top_p")
_FLOATS = ("temperature", "top_p")


def _schema(cfg) -> np.ndarray:
    """The fixed-shape descriptor every rank agrees on (int64)."""
    return np.zeros(len(_FIELDS) + (cfg.num_codebooks + 1) * cfg.max_seq_len,
                    np.int64)


def _broadcast(desc: Optional[np.ndarray], session, cfg) -> dict:
    """The leader's descriptor on every rank (followers pass None)."""
    mesh = session.mesh
    buf = torch.from_numpy(desc if desc is not None else _schema(cfg))
    buf = mesh.tp.broadcast(buf.to(mesh.device), 0).cpu().numpy()
    out = {}
    for i, name in enumerate(_FIELDS):
        out[name] = (buf[i:i + 1].view(np.float64)[0] if name in _FLOATS
                     else int(buf[i]))
    out["prompt"] = buf[len(_FIELDS):].reshape(cfg.num_codebooks + 1,
                                               cfg.max_seq_len)
    return out


def _describe(cfg, prompt, seed, max_new_tokens, temperature, top_p, top_k,
              lookahead, device_partials) -> np.ndarray:
    desc = _schema(cfg)
    values = {"kind": _GENERATE, "plen": prompt.shape[1],
              "max_new_tokens": int(max_new_tokens), "seed": int(seed),
              "top_k": int(top_k), "lookahead": int(lookahead),
              "device_partials": int(bool(device_partials)),
              "temperature": float(temperature), "top_p": float(top_p)}
    for i, name in enumerate(_FIELDS):
        if name in _FLOATS:
            desc[i:i + 1] = np.array([values[name]], np.float64).view(np.int64)
        else:
            desc[i] = values[name]
    body = desc[len(_FIELDS):].reshape(cfg.num_codebooks + 1, cfg.max_seq_len)
    body[:, : prompt.shape[1]] = prompt
    return desc


def _guarded(session, gen):
    """`gen`, marking `session` out of lockstep if one of its steps fails
    (while streamed or drained): the followers run on into collectives
    this rank will not issue."""
    try:
        yield from gen
    except Exception:
        session._lockstep_lost = True
        raise


def wrap_leader(session, cfg) -> None:
    """Instrument `session.generate_stream` (rank 0 only) to broadcast each
    request before streaming and to drain abandoned streams."""
    orig = session.generate_stream

    def generate_stream(prompt, generator, max_new_tokens=0, temperature=1.0,
                        top_p=0.9, top_k=30, audio_features=None,
                        audio_mask=None, pipeline_lookahead=0,
                        device_partials=False):
        if audio_features is not None:  # as JAX's leader
            raise NotImplementedError(
                "audio-feature conditioning is not broadcast to follower "
                "hosts; run conditioned models on one card")
        if getattr(session, "_lockstep_lost", False):
            raise RuntimeError("multi-card serving: an earlier request failed "
                               "after its broadcast and the ranks are out of "
                               "lockstep; restart every rank")
        prompt = np.asarray(prompt, np.int32)
        session.check_request(prompt, max_new_tokens, top_k)  # before any rank
        seed = request_seed(generator)
        _broadcast(_describe(cfg, prompt, seed, max_new_tokens, temperature,
                             top_p, top_k, pipeline_lookahead, device_partials),
                   session, cfg)
        gen = _guarded(session, orig(
            prompt, seed, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, top_k=top_k, pipeline_lookahead=pipeline_lookahead,
            device_partials=device_partials))
        try:
            # NOT `yield from`: a consumer close() (disconnect / cancel)
            # would propagate GeneratorExit THROUGH the delegation and
            # close `gen` before the finally ran, making the drain a no-op
            # — the exact lockstep bug this wrapper exists to prevent
            for item in gen:
                yield item
        finally:
            # keep lockstep: followers run every request to completion, so
            # an abandoned leader stream (disconnect, cancel) must still
            # run its remaining decode chunks
            for _ in gen:
                pass

    session.generate_stream = generate_stream
    session._multihost_leader = True


def broadcast_stop(session, cfg) -> None:
    """Leader shutdown: release the followers' receive."""
    if getattr(session, "_multihost_leader", False) and not getattr(
            session, "_lockstep_lost", False):
        _broadcast(_schema(cfg), session, cfg)  # kind stays _STOP
        session._multihost_leader = False


def follower_loop(session, cfg) -> int:
    """Replay the leader's request stream until the stop descriptor.
    Returns the number of requests served. A failed replay raises: the
    leader refused every invalid request before broadcasting it, so a
    failure here is a fault that has put the ranks out of lockstep."""
    served = 0
    while True:
        desc = _broadcast(None, session, cfg)
        if desc["kind"] == _STOP:
            logger.info("follower: stop received after %d requests", served)
            return served
        prompt = np.ascontiguousarray(desc["prompt"][:, : desc["plen"]],
                                      dtype=np.int32)
        for _ in session.generate_stream(
                prompt, desc["seed"], max_new_tokens=desc["max_new_tokens"],
                temperature=desc["temperature"], top_p=desc["top_p"],
                top_k=desc["top_k"], pipeline_lookahead=desc["lookahead"],
                device_partials=bool(desc["device_partials"])):
            pass
        served += 1
