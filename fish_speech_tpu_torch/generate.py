"""Token-level generation runtime for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/generate.py` for the single-stream path. Where the
JAX package jits `prefill_step` per prompt bucket and a decode chunk as one
`lax.scan` program, here each is a CUDA graph: one per bucket for the
prefill with its first column, and one of the decode step, replayed n
times per chunk (`GenerationSession`; `precompile` captures them ahead of
the first request, as JAX's compiles them). The step bodies
(`prefill_body`, `decode_step`) read and write fixed buffers
(`StepState`): the position, token, RAS window and step index live on the
device. The host syncs once per chunk, when it reads the chunk's columns,
as in JAX. Steps run past `<|im_end|>` and are cut on the host. On the
CPU the same bodies run eagerly.

The decode attention kernel reads exactly `pos + 1` cache positions, with
`pos` read on the device: the JAX package's fixed kv-length buckets are
not needed. Sampling reads its uniforms from a block that one eager call
fills per chunk from the request's `torch.Generator` (seeded from the
request's seed), on the model's device (`ops/sampling.py`).

The continuous batcher's device steps (`engine/batcher.py`) are here too:
`pool_decode_step` (JAX's `decode_chunk_multi`, one step of every row of
the pool, each at its own position) over `PoolState`, the group admission
prefill `prefill_group_body` (JAX's `prefill_group_parked`) over
`GroupState`, and the host-driven `apply_admission` and
`scatter_parked_rows`. A pool row's uniforms are `counter_uniforms` of its
request's seed and draw index, computed inside the step.

Every graph capture in the process goes through `capture_graph`, which
holds `GUARD` alone; every thread's other device work holds it shared
(`GUARD.launching()`), so no launch from another thread lands inside a
capture.

Not ported yet (ROADMAP): prefix caching (`prefill_suffix`), device
partials (`StreamPartial`), batched lockstep generation
(`generate_batch`) and its pool-insert prefills.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import re
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, SamplingConfig
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8)
from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
from fish_speech_tpu_torch.ops.int4 import int4_matmul
from fish_speech_tpu_torch.ops.int8 import int8_matmul
from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
from fish_speech_tpu_torch.ops.quant import fp32_scales, mm
from fish_speech_tpu_torch.ops.sampling import (TOP_K_CAP, UNIFORM_FAST,
                                                 UNIFORM_RAS, UNIFORM_SLOW,
                                                 check_top_k, counter_uniforms,
                                                 fill_uniforms, ras_select,
                                                 sample_topk, topk_state,
                                                 uniform_rows)

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(t: int, max_seq: int) -> int:
    for b in PROMPT_BUCKETS:
        if t <= b and b <= max_seq:
            return b
    if t <= max_seq:
        return max_seq
    raise ValueError(f"Prompt length {t} exceeds max_seq_len {max_seq}")


# ---------------------------------------------------------------------------
# Device-side steps
# ---------------------------------------------------------------------------


def _sample_column(params, cfg: DualARConfig, scfg: SamplingConfig, logits,
                   hidden, window, u, sampling, fast_cache):
    """Sample one (B, C+1) token column from the slow-head logits: the main
    token (top-k/top-p, RAS when `window` is given) and then codebooks
    1..C-1 through the fast stack.

    u: one step's uniforms, (`uniform_rows(C)`, >= k) in the rows of
    `ops/sampling.py`, or (`uniform_rows(C)`, B, >= k) with a block per
    row; sampling: (temperature, top_p, top_k), numbers, 0-d tensors or
    (B,) tensors of per-row values; fast_cache: the fast stack's cache,
    zeroed and refilled."""
    temperature, top_p, top_k = sampling
    if scfg.mask_im_end:  # benchmark-only, see SamplingConfig
        logits = logits.clone()
        logits[:, -1] = float("-inf")

    state = topk_state(logits)
    idx_normal = sample_topk(state, temperature, top_p, top_k,
                             u=u[UNIFORM_SLOW])
    tok_normal = dual_ar.semantic_index_to_token(cfg, idx_normal)
    if window is not None:
        idx_high = sample_topk(state, scfg.ras_high_temp, scfg.ras_high_top_p,
                               top_k, u=u[UNIFORM_RAS])
        tok_high = dual_ar.semantic_index_to_token(cfg, idx_high)
        main = ras_select(tok_normal, tok_high, window, cfg.semantic_begin_id,
                          cfg.semantic_end_id)
    else:
        main = tok_normal

    code = torch.clamp(main - cfg.semantic_begin_id, 0, cfg.codebook_size - 1)
    codes = [main, code]
    for t in fast_cache.values():
        t.zero_()
    h0 = dual_ar.fast_project_in(params, cfg, hidden)
    _, fast_cache = dual_ar.fast_decode_step(params, cfg, h0, fast_cache, 0,
                                             with_logits=False)
    for i in range(1, cfg.num_codebooks):
        x = dual_ar.fast_embed(params, cfg, code)
        logits_i, fast_cache = dual_ar.fast_decode_step(params, cfg, x,
                                                        fast_cache, i)
        code = sample_topk(topk_state(logits_i), temperature, top_p, top_k,
                           u=u[UNIFORM_FAST + i - 1])
        codes.append(code)
    return torch.stack(codes, dim=1).to(torch.int32)  # (B, C+1)


def _restricted_logits(cfg: DualARConfig, logits_full):
    """Full-vocab logits -> the constrained head layout (semantic ids +
    im_end; see `dual_ar.semantic_head_logits`)."""
    sb, se = cfg.semantic_begin_id, cfg.semantic_end_id
    return torch.cat([logits_full[:, sb : se + 1],
                      logits_full[:, cfg.im_end_id][:, None]], dim=1)


def prefill_step(params, cfg: DualARConfig, scfg: SamplingConfig, inp, cache,
                 offsets, t_end, u, sampling, fast_cache):
    """Prefill the cache from the prompt and sample the first column (no
    RAS), from the uniforms `u` of one step."""
    logits_full, hidden, cache = dual_ar.prefill(params, cfg, inp, cache,
                                                 offsets, t_end)
    column = _sample_column(params, cfg, scfg,
                            _restricted_logits(cfg, logits_full), hidden,
                            None, u, sampling, fast_cache)
    return column, cache


class StepState:
    """The fixed buffers of one stream's prefill and decode steps, which a
    captured CUDA graph reads and writes at the addresses it was captured
    with. The host writes a request's inputs in place (the prompt,
    `t_end`, `sampling`, the uniform block `u`, `step`); the bodies
    (`prefill_body`, `decode_step`) carry the rest on the device.

    token (1, C+1) int32: the last column; pos (1,) int64: the next step's
    position; window (1, W) int32: the RAS window; step (1,) int64: the
    step's row in `u` and `cols`; u (n_steps, uniform_rows(C), TOP_K_CAP)
    fp32; cols (n_steps, 1, C+1) int32: a chunk's columns; sampling (3,)
    fp32: temperature, top_p, top_k; offsets (1,) int32 and t_end (1,)
    int64: the prompt's rows [offsets, t_end); inp: the padded prompt of
    each bucket, (1, C+1, bucket) int32."""

    def __init__(self, cfg: DualARConfig, scfg: SamplingConfig, cache_len: int,
                 n_steps: int, dtype, act_dtype, device, kv_quant: bool):
        c1 = cfg.num_codebooks + 1
        i32 = dict(dtype=torch.int32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.device = device
        self.cache = dual_ar.init_kv_cache(cfg, 1, cache_len, dtype, device,
                                           quant=kv_quant)
        self.fast_cache = dual_ar.init_fast_kv_cache(cfg, 1, act_dtype, device)
        self.token = torch.zeros((1, c1), **i32)
        self.pos = torch.zeros((1,), **i64)
        self.window = torch.zeros((1, scfg.ras_win_size), **i32)
        self.step = torch.zeros((1,), **i64)
        self.u = torch.zeros((n_steps, uniform_rows(cfg.num_codebooks),
                              TOP_K_CAP), dtype=torch.float32, device=device)
        self.cols = torch.zeros((n_steps, 1, c1), **i32)
        self.sampling = torch.zeros((3,), dtype=torch.float32, device=device)
        self.offsets = torch.zeros((1,), **i32)
        self.t_end = torch.zeros((1,), **i64)
        self.inp = {}

    def prompt(self, bucket: int):
        """The prompt buffer of `bucket`, made at its first use."""
        if bucket not in self.inp:
            self.inp[bucket] = torch.zeros(
                (1, self.token.shape[1], bucket), dtype=torch.int32,
                device=self.device)
        return self.inp[bucket]

    def carry(self):
        """The tensors a body carries from one run to the next."""
        return self.token, self.pos, self.window, self.step

    def sampling_args(self):
        return self.sampling[0], self.sampling[1], self.sampling[2]


def prefill_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                 st: StepState, bucket: int):
    """`prefill_step` of the prompt in `st.prompt(bucket)` on the fixed
    buffers: the first column (from row 0 of `st.u`) goes to `st.token`,
    `st.pos` becomes `t_end` and the RAS window is cleared."""
    column, _ = prefill_step(params, cfg, scfg, st.prompt(bucket), st.cache,
                             st.offsets, st.t_end, st.u[0], st.sampling_args(),
                             st.fast_cache)
    st.token.copy_(column)
    st.pos.copy_(st.t_end)
    st.window.zero_()


def decode_step(params, cfg: DualARConfig, scfg: SamplingConfig,
                st: StepState):
    """One decode step on the fixed buffers: the slow step at `st.pos` on
    `st.token`, the head, sampling with RAS from `st.u[st.step]` and the
    fast column. The column goes to `st.cols[st.step]` and `st.token`, the
    window rolls, and `pos` and `step` advance, all on the device: a CUDA
    graph of this body replayed n times runs n steps (JAX's `decode_chunk`
    scan). Steps run past `<|im_end|>`; the host cuts them."""
    hidden, slow_out, _ = dual_ar.decode_slow_step(params, cfg, st.token,
                                                   st.cache, st.pos)
    logits = dual_ar.semantic_head_logits(params, cfg, slow_out)
    column = _sample_column(params, cfg, scfg, logits, hidden, st.window,
                            st.u.index_select(0, st.step)[0],
                            st.sampling_args(), st.fast_cache)
    st.cols.index_copy_(0, st.step, column[None])
    st.token.copy_(column)
    st.window.copy_(torch.cat([st.window[:, 1:], column[:, :1]], dim=1))
    st.pos.add_(1)
    st.step.add_(1)


class PoolState:
    """The fixed buffers of the decode pool's step (`pool_decode_step`): one
    row per slot of the continuous batcher, each its own sequence. A CUDA
    graph of the step reads and writes them at the addresses it was
    captured with; the host writes admitted rows in place
    (`apply_admission`, `scatter_parked_rows`) and clears `active` of a
    row it retires.

    cache: the pool's slow cache (L, P, S, Hkv, Dh); token (P, C+1) int32:
    each row's last column; pos (P,) int64: its next position; window (P,
    W) int32: its RAS window; active (P,) bool; seed (P,) int64: its
    request's seed; draw (P,) int64: its next draw of uniforms
    (`counter_uniforms`; the prefill's column is draw 0); sampling (3, P)
    fp32: temperature, top_p, top_k; step (1,) int64: the step's row of
    `cols`; cols (n_steps, P, C+1) int32: a sub-chunk's columns."""

    def __init__(self, cfg: DualARConfig, scfg: SamplingConfig, pool_size: int,
                 cache_len: int, n_steps: int, dtype, act_dtype, device,
                 kv_quant: bool):
        p, c1 = pool_size, cfg.num_codebooks + 1
        i32 = dict(dtype=torch.int32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.cache = dual_ar.init_kv_cache(cfg, p, cache_len, dtype, device,
                                           quant=kv_quant)
        self.fast_cache = dual_ar.init_fast_kv_cache(cfg, p, act_dtype, device)
        self.token = torch.zeros((p, c1), **i32)
        self.pos = torch.zeros((p,), **i64)
        self.window = torch.zeros((p, scfg.ras_win_size), **i32)
        self.active = torch.zeros((p,), dtype=torch.bool, device=device)
        self.seed = torch.zeros((p,), **i64)
        self.draw = torch.zeros((p,), **i64)
        self.sampling = torch.ones((3, p), dtype=torch.float32, device=device)
        self.step = torch.zeros((1,), **i64)
        self.cols = torch.zeros((n_steps, p, c1), **i32)

    def carry(self):
        """The tensors a step carries from one run to the next."""
        return self.token, self.pos, self.window, self.active, self.draw, self.step

    def sampling_args(self):
        return self.sampling[0], self.sampling[1], self.sampling[2]


def pool_decode_step(params, cfg: DualARConfig, scfg: SamplingConfig,
                     ps: PoolState):
    """One step of every pool row on the fixed buffers (a step of JAX's
    `decode_chunk_multi`): the slow step at each row's own position, the
    head, sampling with each row's parameters and uniforms (`counter_uniforms`
    of its seed and draw) with RAS, and the fast column. An active row
    emits its column into `cols[step]`, rolls its window, advances pos and
    draw, and turns itself inactive on `<|im_end|>`; an inactive row's
    token, window, pos and cache stay as they are (its emitted column is
    its old token). All on the device: a CUDA graph of this body replayed n
    times runs n steps."""
    hidden, slow_out, _ = dual_ar.decode_slow_step_multi(
        params, cfg, ps.token, ps.cache, ps.pos, ps.active)
    logits = dual_ar.semantic_head_logits(params, cfg, slow_out)
    u = counter_uniforms(ps.seed, ps.draw, uniform_rows(cfg.num_codebooks))
    column = _sample_column(params, cfg, scfg, logits, hidden, ps.window,
                            u.transpose(0, 1), ps.sampling_args(),
                            ps.fast_cache)
    act = ps.active[:, None]
    emitted = torch.where(act, column, ps.token)
    ps.cols.index_copy_(0, ps.step, emitted[None])
    ps.window.copy_(torch.where(
        act, torch.cat([ps.window[:, 1:], column[:, :1]], dim=1), ps.window))
    ps.token.copy_(emitted)
    advance = ps.active.long()
    ps.pos.add_(advance)
    ps.draw.add_(advance)
    ps.active.logical_and_(column[:, 0] != cfg.im_end_id)
    ps.step.add_(1)


def apply_admission(ps: PoolState, rows, ints, floats):
    """Fold admitted rows into the pool's buffers in place (JAX's
    `_apply_admission`, `fish_speech_tpu/engine/batcher.py:90-115`): rows
    (m,) int64 pool rows; ints (m, 2 + C+1) int64: each row's position,
    seed and first column; floats (3, m) fp32: its temperature, top_p and
    top_k. The window is cleared, the next draw is 1 and the row turns
    active. Device tensors in, no host read."""
    ps.pos.index_copy_(0, rows, ints[:, 0])
    ps.seed.index_copy_(0, rows, ints[:, 1])
    ps.token.index_copy_(0, rows, ints[:, 2:].to(ps.token.dtype))
    ps.window.index_fill_(0, rows, 0)
    ps.draw.index_fill_(0, rows, 1)
    ps.active.index_fill_(0, rows, True)
    ps.sampling.index_copy_(1, rows, floats)


def scatter_parked_rows(pool, parked, src, rows):
    """Copy rows `src` (m,) of a parked group's cache (L, k, bucket, ...) to
    pool rows `rows` (m,), positions [0, bucket), for every tensor of the
    cache layout (plain {k, v} or int8 {k, v, ks, vs}): the rows JAX's
    `scatter_parked_rows` takes, copied eagerly (its fixed pool-sized
    signature only bounds XLA's compiles)."""
    s = parked["k"].shape[2]
    for name, dst in pool.items():
        dst[:, :, :s].index_copy_(
            1, rows, parked[name].index_select(1, src).to(dst.dtype))


class GroupState:
    """The fixed buffers of one admission signature's group prefill
    (`prefill_group_body`): k rows of prompts right-aligned at [0,
    t_end[i]) in a bucket. One scratch cache at the largest bucket serves
    every bucket's graph (the graphs replay one at a time, and each group's
    rows are copied out before the next replay).

    cache (L, k, max_bucket, Hkv, Dh); offsets (k,) int32 zeros; t_end (k,)
    int64; seed (k,) int64; sampling (3, k) fp32; column (k, C+1) int32:
    the first columns; inp: the padded prompts of each bucket, (k, C+1,
    bucket) int32."""

    def __init__(self, cfg: DualARConfig, scfg: SamplingConfig, k: int,
                 max_bucket: int, dtype, act_dtype, device, kv_quant: bool):
        self.k, self.max_bucket, self.device = k, max_bucket, device
        self.cache = dual_ar.init_kv_cache(cfg, k, max_bucket, dtype, device,
                                           quant=kv_quant)
        self.fast_cache = dual_ar.init_fast_kv_cache(cfg, k, act_dtype, device)
        self.offsets = torch.zeros((k,), dtype=torch.int32, device=device)
        self.t_end = torch.ones((k,), dtype=torch.int64, device=device)
        self.seed = torch.zeros((k,), dtype=torch.int64, device=device)
        self.sampling = torch.ones((3, k), dtype=torch.float32, device=device)
        self.column = torch.zeros((k, cfg.num_codebooks + 1), dtype=torch.int32,
                                  device=device)
        self.inp = {}

    def prompt(self, bucket: int):
        """The prompt buffer of `bucket`, made at its first use."""
        if bucket not in self.inp:
            self.inp[bucket] = torch.zeros(
                (self.k, self.column.shape[1], bucket), dtype=torch.int32,
                device=self.device)
        return self.inp[bucket]

    def sampling_args(self):
        return self.sampling[0], self.sampling[1], self.sampling[2]


def prefill_group_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                       gs: GroupState, bucket: int):
    """JAX's `prefill_group_parked` on the fixed buffers: the k prompts of
    `gs.prompt(bucket)` (offsets 0, per-row t_end) prefilled into the
    scratch cache, and each row's first column sampled with its own
    parameters from draw 0 of its seed (no RAS) into `gs.column`."""
    logits_full, hidden, _ = dual_ar.prefill(params, cfg, gs.prompt(bucket),
                                             gs.cache, gs.offsets, gs.t_end)
    u = counter_uniforms(gs.seed, torch.zeros_like(gs.seed),
                         uniform_rows(cfg.num_codebooks))
    gs.column.copy_(_sample_column(
        params, cfg, scfg, _restricted_logits(cfg, logits_full), hidden, None,
        u.transpose(0, 1), gs.sampling_args(), gs.fast_cache))


# the wrappers whose launch counters a captured graph's replays add to
# (`mm`'s count the int8 products by route: the kernel, or torch's cast)
_WRAPPERS = (flash_decode_attention, flash_decode_attention_kv8,
             flash_prefill_attention, int4_matmul, int8_matmul, int8_ffn, mm)


def _launch_counts():
    """Every launch counter of the serving path's kernel wrappers
    (`.launches` and the per-route `.launches_<route>`)."""
    return {(f, name): n for f in _WRAPPERS for name, n in vars(f).items()
            if name.startswith("launches")}


class LaunchGuard:
    """Keeps CUDA graph captures apart from every other device call.

    `torch.cuda.graph` captures in CUDA's "global" mode: a launch, copy or
    synchronisation from another thread while a capture is open fails the
    capture or spoils it. The batcher's worker, the engine's request
    threads (the codec) and a single-stream session may all call the
    device at once, so each holds `launching()` around its device work
    (shared: any number at once; re-entrant in a thread) and
    `capture_graph` holds `capturing()` (alone: it waits for the shared
    holders to leave and keeps new ones out until it is done). A CUDA
    capture is process-wide, hence one guard per process (`GUARD`)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._launching = 0
        self._capturing = False
        self._waiting = 0  # captures waiting: new launching sections wait too
        self._held = threading.local()

    @contextlib.contextmanager
    def launching(self):
        depth = getattr(self._held, "depth", 0)
        outer = depth == 0 and not getattr(self._held, "capturing", False)
        if outer:
            with self._cond:
                while self._capturing or self._waiting:
                    self._cond.wait()
                self._launching += 1
        self._held.depth = depth + 1
        try:
            yield
        finally:
            self._held.depth = depth
            if outer:
                with self._cond:
                    self._launching -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def capturing(self):
        if getattr(self._held, "depth", 0):
            raise RuntimeError("a CUDA graph capture inside a launching section "
                               "would wait for itself")
        with self._cond:
            self._waiting += 1
            try:
                while self._capturing or self._launching:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._capturing = True
        self._held.capturing = True
        try:
            yield
        finally:
            self._held.capturing = False
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


GUARD = LaunchGuard()


def capture_graph(body, pool, device):
    """Capture `body()` into a CUDA graph drawing on the memory pool `pool`,
    after the caller's eager run of it (which builds the kernels' plans,
    workspaces and cached tables outside the pool), holding `GUARD` alone.
    A capture launches nothing, so the launch counts it added are taken
    back. Returns (graph, {(wrapper, counter): launches one replay makes},
    bytes the pool grew by)."""
    with GUARD.capturing():
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            body()
        after = _launch_counts()
        for (f, attr), n in before.items():
            setattr(f, attr, n)
        torch.cuda.synchronize(device)
        grown = torch.cuda.memory_reserved(device) - reserved
    launches = {k: after[k] - n for k, n in before.items() if after[k] != n}
    return graph, launches, grown


def replay_graph(graph, launches):
    """Replay `graph` on the current stream and add the launches its
    capture recorded to the wrappers' counters."""
    with GUARD.launching():
        graph.replay()
    for (f, attr), n in launches.items():
        setattr(f, attr, getattr(f, attr) + n)


# ---------------------------------------------------------------------------
# Host-side generation driver
# ---------------------------------------------------------------------------


@dataclass
class GenerateResponse:
    action: str  # "sample" | "next" | "partial"
    codes: Optional[np.ndarray] = None
    text: Optional[str] = None


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


class GenerationSession:
    """Owns the KV cache, the step buffers (`StepState`) and the
    inference-prepared weights of one model, for one stream at a time
    (`max_batch` must be 1; concurrent streams share the decode pool of
    `engine/batcher.py`).

    The session re-uses one cache for every request (each prefill writes
    the positions it reads); `params` (plain or quantized, `ops/quant.py`)
    are augmented with the restricted LM head and the fused w1|w3 FFN
    weight (the JAX package fuses at batch 1, the only batch here). Fusing
    copies the FFN weights: the caller should drop its own reference to
    `params`, and must not change the session's. `kv_quant` keeps the slow
    cache in int8 with per-(position, head) scales
    (`dual_ar.init_kv_cache(quant=True)`).

    On CUDA every step is a replay of a CUDA graph: one graph per prompt
    bucket for the prefill and its first column (`prefill_{bucket}`) and
    one for the decode step (`decode`), replayed n times per chunk. A graph
    is captured at the first use of its name, or ahead of time by
    `precompile`, after one eager run of its body that builds the kernels'
    plans and workspaces; a failed capture raises. The graphs share one
    memory pool: they replay on one stream, one at a time, and keep no
    output in it (every result goes to a `StepState` buffer). The weights
    and the cache must stay where they were captured. A capture launches
    no kernel, so it takes back the launch counts its body added; each
    replay adds them again. On the CPU the bodies run eagerly.
    `replays` and `eager_runs` count graph replays and eager body runs by
    name; `capture_seconds` and `pool_bytes` what the captures took."""

    def __init__(self, params, cfg: DualARConfig, scfg: SamplingConfig = None,
                 max_batch: int = 1, dtype=torch.bfloat16,
                 decode_chunk_size: int = 32, first_chunk_size: int = 0,
                 pipeline_lookahead: int = 1, kv_quant: bool = False):
        if max_batch != 1:
            raise NotImplementedError(
                "lockstep batched sessions (generate_batch) are not ported "
                "yet (ROADMAP); the decode pool is engine/batcher.py's "
                "ContinuousBatcher")
        # detached views: a tree fresh from training (LoRA tensors that
        # require grad) must not make decoding record an autograd graph
        params = _detached(params)
        self.params = fp32_scales(dual_ar.fuse_ffn_weights(
            dual_ar.precompute_semantic_head(params, cfg)))
        self.cfg = cfg.resolve()
        self.scfg = scfg or SamplingConfig()
        self.device = params["embeddings"].device
        self.decode_chunk_size = decode_chunk_size
        self.first_chunk_size = first_chunk_size or decode_chunk_size
        # chunks dispatched ahead of the one being read in generate()
        self.pipeline_lookahead = pipeline_lookahead
        # headroom so a chunk's overshoot never writes past the buffer
        self.cache_len = self.cfg.max_seq_len + decode_chunk_size
        self.kv_quant = kv_quant
        self.state = StepState(
            self.cfg, self.scfg, self.cache_len,
            max(self.first_chunk_size, decode_chunk_size), dtype,
            params["embeddings"].dtype, self.device, kv_quant)
        self.cache = self.state.cache
        self._graphs = {}  # name -> (CUDAGraph, launch counts per replay)
        self._pool = None
        self.capture_seconds = {}
        self.pool_bytes = 0
        self.replays = collections.Counter()
        self.eager_runs = collections.Counter()

    def new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _bucket(self, t: int) -> int:
        return min(pick_bucket(t, self.cache_len), self.cfg.max_seq_len)

    def _body(self, name: str):
        if name == "decode":
            return functools.partial(decode_step, self.params, self.cfg,
                                     self.scfg, self.state)
        return functools.partial(prefill_body, self.params, self.cfg,
                                 self.scfg, self.state,
                                 int(name.split("_")[1]))

    def _capture(self, name: str):
        """Capture graph `name`: one eager run of its body (the carried
        buffers put back after it), then the capture into the shared pool."""
        t0 = time.perf_counter()
        body = self._body(name)
        with GUARD.launching():
            saved = [t.clone() for t in self.state.carry()]
            body()
            self.eager_runs[name] += 1
            for t, s in zip(self.state.carry(), saved):
                t.copy_(s)
            del saved
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, launches, grown = capture_graph(body, self._pool, self.device)
        self.pool_bytes += grown
        self.capture_seconds[name] = time.perf_counter() - t0
        self._graphs[name] = (graph, launches)
        return self._graphs[name]

    def _run(self, name: str):
        """Run step `name` once: a replay of its graph on CUDA (captured at
        its first use), its body on the CPU."""
        if self.device.type != "cuda":
            self._body(name)()
            self.eager_runs[name] += 1
            return
        replay_graph(*(self._graphs.get(name) or self._capture(name)))
        self.replays[name] += 1

    def _graphs_for(self, *names):
        """Capture the graphs `names` not captured yet (on CUDA): before a
        launching section, which a capture may not sit in."""
        if self.device.type == "cuda":
            for name in names:
                if name not in self._graphs:
                    self._capture(name)

    def launches_per_replay(self, name: str) -> dict:
        """{counter: launches} one replay of graph `name` adds."""
        return {f"{f.__name__}.{attr}": n
                for (f, attr), n in self._graphs[name][1].items()}

    def precompile(self, prompt_len: int, max_new_tokens: int = 0,
                   first_chunk: Optional[int] = None) -> dict:
        """Capture, ahead of the first request, the graphs a request of
        `prompt_len` tokens and `max_new_tokens` replays: its bucket's
        prefill (`prefill_{bucket}`) and, unless its budget ends with the
        prefill, the decode step (`decode`), the counterpart of the JAX
        session's `precompile`. One decode graph serves every chunk size,
        so `first_chunk` has only to fit the step buffers. Call it between
        requests: the eager runs write the cache. Returns {name: seconds}
        of the graphs captured by this call (each with its eager run); on
        the CPU nothing is captured and it returns {}."""
        cfg = self.cfg
        n_steps = self.state.u.shape[0]
        if first_chunk is not None and not 0 < first_chunk <= n_steps:
            raise ValueError(f"first_chunk={first_chunk} outside the step "
                             f"buffers' 1..{n_steps}")
        if not 0 < prompt_len < cfg.max_seq_len:
            raise ValueError(f"prompt_len {prompt_len} outside 1.."
                             f"{cfg.max_seq_len - 1}")
        if self.device.type != "cuda":
            return {}
        budget = (max_new_tokens
                  if max_new_tokens and prompt_len + max_new_tokens <= cfg.max_seq_len
                  else cfg.max_seq_len - prompt_len)
        names = [f"prefill_{self._bucket(prompt_len)}"]
        if budget > 1:
            names.append("decode")
        with GUARD.launching():
            self._set_request(prompt_len, self.scfg.temperature,
                              self.scfg.top_p, self.scfg.top_k)
        out = {}
        for name in names:
            if name not in self._graphs:
                self._capture(name)
                out[name] = self.capture_seconds[name]
        return out

    def _set_request(self, t: int, temperature, top_p, top_k):
        st = self.state
        st.t_end.fill_(t)
        for i, v in enumerate((temperature, top_p, top_k)):
            st.sampling[i].fill_(float(v))

    def decode_chunk(self, n: int, generator):
        """Enqueue n decode steps (on CUDA n replays of the step graph) after
        filling their uniforms; returns a copy of their columns (n, 1, C+1).
        Nothing here waits on the device, so chunks can queue."""
        st = self.state
        self._graphs_for("decode")
        with GUARD.launching():
            fill_uniforms(st.u[:n], generator)
            st.step.zero_()
            for _ in range(n):
                self._run("decode")
            return st.cols[:n].clone()

    def generate(self, prompt: np.ndarray, generator, max_new_tokens: int = 0,
                 temperature: float = 1.0, top_p: float = 0.9,
                 top_k: int = 30) -> np.ndarray:
        """Generate until im_end or the budget; returns (C+1, N) columns
        including the final im_end column."""
        last = None
        for last in self.generate_stream(
            prompt, generator, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p, top_k=top_k,
            pipeline_lookahead=self.pipeline_lookahead,
        ):
            pass
        return last

    def generate_stream(self, prompt: np.ndarray, generator,
                        max_new_tokens: int = 0, temperature: float = 1.0,
                        top_p: float = 0.9, top_k: int = 30,
                        pipeline_lookahead: int = 0):
        """Yield the CUMULATIVE (C+1, n) host columns after the prefill frame
        and after every decode chunk; the last yield is the whole sequence.

        pipeline_lookahead > 0 enqueues that many chunks beyond the one
        being read, so the device runs chunks back to back."""
        cfg, st = self.cfg, self.state
        check_top_k(top_k)
        t = prompt.shape[1]
        if t >= cfg.max_seq_len:
            raise ValueError(
                f"Input sequence length {t} exceeds max_seq_len {cfg.max_seq_len}"
            )
        if max_new_tokens and t + max_new_tokens <= cfg.max_seq_len:
            budget = max_new_tokens
        else:
            budget = cfg.max_seq_len - t

        bucket = self._bucket(t)
        inp = np.zeros((1, cfg.num_codebooks + 1, bucket), dtype=np.int32)
        inp[0, :, :t] = prompt
        self._graphs_for(f"prefill_{bucket}")
        with GUARD.launching():
            st.prompt(bucket).copy_(torch.from_numpy(inp))
            self._set_request(t, temperature, top_p, top_k)
            fill_uniforms(st.u[:1], generator)
            self._run(f"prefill_{bucket}")
            # a copy: on the CPU .cpu() returns the buffer the steps overwrite
            columns = [st.token.cpu().numpy().copy()]  # list of (B, C+1)
        yield np.concatenate(columns, axis=0).T
        if int(columns[0][0, 0]) == cfg.im_end_id:
            return

        dispatch_left = budget - 1  # steps not yet enqueued
        emit_left = budget - 1  # steps not yet yielded
        first = True
        inflight = []  # FIFO of (cols_device, n)
        while dispatch_left > 0 or inflight:
            while dispatch_left > 0 and len(inflight) <= pipeline_lookahead:
                # always a FULL chunk, cut on the host; the cache has
                # decode_chunk_size positions of headroom for the overshoot
                n = self.first_chunk_size if first else self.decode_chunk_size
                first = False
                inflight.append((self.decode_chunk(n, generator), n))
                dispatch_left -= n
            cols_dev, n = inflight.pop(0)
            with GUARD.launching():
                cols = cols_dev.cpu().numpy()[:, 0][: max(emit_left, 0)]
            emit_left -= n
            ends = cols[:, 0] == cfg.im_end_id
            if ends.any():
                stop = int(np.argmax(ends))
                columns.append(cols[: stop + 1])
                yield np.concatenate(columns, axis=0).T
                return
            columns.append(cols)
            yield np.concatenate(columns, axis=0).T


# ---------------------------------------------------------------------------
# Text chunking and long-form generation
# ---------------------------------------------------------------------------

_SPEAKER_PATTERN = r"(<\|speaker:\d+\|>)"


def split_text_by_speaker(text: str) -> List[str]:
    parts = re.split(_SPEAKER_PATTERN, text)
    turns = []
    i = 0
    while i < len(parts):
        part = parts[i].strip()
        if re.match(_SPEAKER_PATTERN, part):
            if i + 1 < len(parts):
                turns.append((part + parts[i + 1]).strip())
                i += 2
            else:
                turns.append(part)
                i += 1
        else:
            i += 1
    return turns


def group_turns_into_batches(turns: List[str], max_speakers: int = 5,
                             max_bytes: int = 300) -> List[str]:
    batches: List[str] = []
    current: List[str] = []
    current_bytes = 0
    for turn in turns:
        turn_bytes = len(turn.encode("utf-8"))
        if len(current) >= max_speakers or (
            current and current_bytes + turn_bytes > max_bytes
        ):
            batches.append("\n".join(current))
            current = [turn]
            current_bytes = turn_bytes
        else:
            current.append(turn)
            current_bytes += turn_bytes
    if current:
        batches.append("\n".join(current))
    return batches


SYSTEM_PROMPT_CLONE = (
    "convert the provided text to speech reference to the following:\n\nText:\n"
)
SYSTEM_PROMPT_PLAIN = "convert the provided text to speech"


def build_base_conversation(prompt_text: Optional[List[str]],
                            prompt_tokens: Optional[List[np.ndarray]]):
    """System message for voice cloning (reference texts + VQ codes) or
    plain TTS. Imports the `sequence` module here, not at module import: it
    pulls in the `tokenizers` package."""
    from fish_speech_tpu_torch.sequence import (Conversation, Message,
                                                TextPart, VQPart)

    conv = Conversation()
    use_prompt = (bool(prompt_text) and prompt_tokens is not None
                  and len(prompt_tokens))
    if use_prompt:
        tagged = [t if re.search(_SPEAKER_PATTERN, t) else f"<|speaker:{i}|>{t}"
                  for i, t in enumerate(prompt_text)]
        parts = [
            TextPart(text=SYSTEM_PROMPT_CLONE, cal_loss=False),
            TextPart(text="\n".join(tagged), cal_loss=False),
            TextPart(text="\n\nSpeech:\n", cal_loss=False),
            VQPart(codes=np.concatenate(prompt_tokens, axis=1), cal_loss=False),
        ]
    else:
        parts = [TextPart(text=SYSTEM_PROMPT_PLAIN, cal_loss=False)]
    conv.append(Message(role="system", parts=parts, cal_loss=False,
                        add_im_start=True, add_im_end=True))
    return conv


def encode_turn(conversation, text: str, tokenizer, num_codebooks: int):
    """Append the user's `text` to `conversation` and return the (C+1, T)
    prompt of the assistant's voice turn that answers it."""
    from fish_speech_tpu_torch.sequence import Conversation, Message, TextPart

    conversation.append(Message(role="user", parts=[TextPart(text=text)],
                                cal_loss=False, add_im_start=True,
                                add_im_end=True))
    gen_conv = Conversation(list(conversation.messages))
    gen_conv.append(Message(role="assistant", parts=[], cal_loss=False,
                            modality="voice", add_im_start=True,
                            add_im_end=False))
    encoded, _, _ = gen_conv.encode_for_inference(tokenizer,
                                                  num_codebooks=num_codebooks)
    return encoded


def generate_long(*, session: GenerationSession, tokenizer, text: str,
                  max_new_tokens: int = 0, top_p: float = 0.9, top_k: int = 30,
                  temperature: float = 1.0, chunk_length: int = 300,
                  prompt_text: Optional[Union[str, List[str]]] = None,
                  prompt_tokens: Optional[Union[np.ndarray, List[np.ndarray]]] = None,
                  seed: int = 42, stream_partials: bool = False):
    """Chunked long-form generation: split the text on speaker tags, batch
    the turns, generate each batch in turn with the earlier batches' codes
    as conversation context.

    prompt_text / prompt_tokens: an optional voice-clone prompt (reference
    texts and their (num_codebooks, T) codes) for the system message.
    stream_partials: also yield action="partial" with the cumulative codes
    of the segment in progress after every decode chunk; the closing
    action="sample" repeats the whole segment."""
    from fish_speech_tpu_torch.sequence import Conversation, Message, VQPart

    if not 0 < top_p <= 1:
        raise ValueError("top_p must be in (0, 1]")
    if not 0 < temperature < 2:
        raise ValueError("temperature must be in (0, 2)")

    cfg = session.cfg
    if isinstance(prompt_text, str):
        prompt_text = [prompt_text]
    if isinstance(prompt_tokens, np.ndarray):
        prompt_tokens = [prompt_tokens]
    if prompt_text and prompt_tokens and len(prompt_text) != len(prompt_tokens):
        raise ValueError("Prompt text and tokens must have the same length")

    base_conversation = build_base_conversation(prompt_text, prompt_tokens)
    turns = split_text_by_speaker(text)
    if turns:
        batches = group_turns_into_batches(turns, max_bytes=chunk_length)
    else:
        batches = [text]

    generator = session.new_generator(seed)
    conversation = Conversation(list(base_conversation.messages))
    for batch_text in batches:
        encoded = encode_turn(conversation, batch_text, tokenizer,
                              cfg.num_codebooks)
        if encoded.shape[1] > cfg.max_seq_len - 2048 and cfg.max_seq_len > 2048:
            raise ValueError(f"Prompt is too long: {encoded.shape[1]} > "
                             f"{cfg.max_seq_len - 2048}")

        if stream_partials:
            seq = None
            for seq in session.generate_stream(
                encoded, generator, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
            ):
                n_p = seq.shape[1]
                end_p = (n_p - 1 if n_p and int(seq[0, -1]) == cfg.im_end_id
                         else n_p)
                if end_p > 0:
                    yield GenerateResponse(
                        action="partial",
                        codes=np.ascontiguousarray(seq[1:, :end_p]),
                        text=batch_text,
                    )
        else:
            seq = session.generate(
                encoded, generator, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
            )
        # drop the trailing im_end column; keep the codebook rows
        n = seq.shape[1]
        end = n - 1 if int(seq[0, -1]) == cfg.im_end_id else n
        codes = np.ascontiguousarray(seq[1:, :end])
        if (codes < 0).any():
            raise RuntimeError("negative code generated")
        conversation.append(Message(role="assistant",
                                    parts=[VQPart(codes=codes, cal_loss=False)],
                                    cal_loss=False, modality="voice",
                                    add_im_start=True, add_im_end=True))
        yield GenerateResponse(action="sample", codes=codes, text=batch_text)
    yield GenerateResponse(action="next")
