"""Token-level generation runtime for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/generate.py`. Where the JAX package jits
`prefill_step` per prompt bucket and a decode chunk as one `lax.scan`
program, here each is a CUDA graph: one per bucket for the prefill with its
first column, and one of the decode step, replayed n times per chunk
(`GenerationSession`; `precompile` captures them ahead of the first
request, as JAX's compiles them). The step bodies
(`prefill_body`, `decode_step`) read and write fixed buffers
(`StepState`): the position, token, RAS window and step index live on the
device. The host syncs once per chunk, when it reads the chunk's columns,
as in JAX. Steps run past `<|im_end|>` and are cut on the host. On the
CPU the same bodies run eagerly.

The decode attention kernel reads exactly `pos + 1` cache positions, with
`pos` read on the device: the JAX package's fixed kv-length buckets are
not needed. A step's uniforms are `counter_uniforms` of the request's seed
and the step's draw index, computed inside the step (`ops/sampling.py`),
so the codes of a seed do not depend on how the steps were cut into
chunks, as JAX's, whose key rides in the scan's carry.

Voice-clone prefix caching (`PrefixStore`, JAX's): a request whose prompt
shares at least 64 leading columns with a stored prompt has the stored KV
rows copied back into its cache and prefills only its suffix
(`dual_ar.prefill_suffix`, a graph per suffix bucket, `suffix_{sbucket}`);
the batcher's admission groups do the same (`prefill_group_suffix_body`).

The continuous batcher's device steps (`engine/batcher.py`) are here too:
`pool_decode_step` (JAX's `decode_chunk_multi`, one step of every row of
the pool, each at its own position) over `PoolState`, the group admission
prefill `prefill_group_body` (JAX's `prefill_group_parked`) over
`GroupState`, and the host-driven `apply_admission` and
`scatter_parked_rows`. A pool row's uniforms are `counter_uniforms` of its
request's seed and draw index, computed inside the step.

The lockstep batch (`GenerationSession(max_batch=B).generate_batch`,
JAX's): B prompts left-padded to a common end, prefilled at B rows with
per-row offsets (`prefill_{B}_{bucket}`) and decoded in lockstep at one
position by the same step body on B-row buffers (`decode_{B}`), each row's
pad masked out of decode attention by the kernels' per-row `starts`. The
pool-insert prefills (`prefill_single_into_pool`, `prefill_group_into_pool`)
are plain functions, as nothing in JAX calls them either.

Device partials (`generate_stream(device_partials=True)`, JAX's
`StreamPartial`): each partial holds the cumulative columns on the device,
untrimmed, and is yielded before any host sync; its host copy flies
(pinned, behind an event) while the engine runs the codec on the device
columns.

Every graph capture in the process goes through `capture_graph`, which
holds `GUARD` alone; every thread's other device work holds it shared
(`GUARD.launching()`), so no launch from another thread lands inside a
capture.

Tensor-parallel serving (`GenerationSession(mesh=...)`, JAX's session on a
(1, tp) mesh): the session holds this rank's shard (`parallel/mesh.py:
shard_params`) and every rank runs every prefill, decode step and stream in
lockstep. Each rank samples from the same gathered logits with the same
`counter_uniforms(seed, draw)`, so every rank draws the same codes. Under
nccl the collectives run inside the session's CUDA graphs; under gloo the
bodies run eagerly (gloo cannot be captured), counted by `eager_runs`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, SamplingConfig
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8)
from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                     flash_suffix_attention)
from fish_speech_tpu_torch.ops.int4 import int4_matmul
from fish_speech_tpu_torch.ops.int8 import int8_matmul
from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
from fish_speech_tpu_torch.ops.quant import fp32_scales, mm
from fish_speech_tpu_torch.ops.sampling import (TOP_K_CAP, UNIFORM_FAST,
                                                 UNIFORM_RAS, UNIFORM_SLOW,
                                                 check_top_k, counter_uniforms,
                                                 ras_select, sample_topk,
                                                 topk_state, uniform_rows)
from fish_speech_tpu_torch.parallel.mesh import has_quantized, use_mesh

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(t: int, max_seq: int) -> int:
    for b in PROMPT_BUCKETS:
        if t <= b and b <= max_seq:
            return b
    if t <= max_seq:
        return max_seq
    raise ValueError(f"Prompt length {t} exceeds max_seq_len {max_seq}")


def request_seed(generator) -> int:
    """One request's sampling seed: an int as it is, else the next draw of
    the numpy generator `new_generator` made (`generate_long` passes one
    generator to each of its text segments)."""
    if isinstance(generator, (int, np.integer)):
        return int(generator)
    return int(generator.integers(0, 2**31 - 1))


def batch_seeds(seed: int, rows: int) -> list:
    """The seeds of a lockstep batch's rows: row r draws `counter_uniforms`
    of seed ^ (r * 0x9E3779B1), low 32 bits (the bits the uniforms read),
    so row 0 draws what a single stream of `seed` draws and each row's
    codes depend only on the seed, its row and its prompt."""
    return [(int(seed) ^ (r * 0x9E3779B1)) & 0xFFFFFFFF for r in range(rows)]


class PrefixStore:
    """Host-side LRU of recent prompts' KV rows (the voice-clone prefix
    cache), JAX's `PrefixStore` with the same decisions: prompts of at least
    128 columns are stored, a stored prefix is reused only when at least 64
    leading columns match, the longest match wins, and the least recently
    used entry goes first.

    Shared by `GenerationSession` and `ContinuousBatcher`. An entry holds
    the prompt's columns and its cache rows, (L, 1, bucket, ...) per cache
    tensor. The port writes its caches in place, so the rows a caller
    stores must be its own copies (`.clone()`), never views of a cache the
    next request overwrites."""

    MIN_MATCH = 64  # leading columns a stored prefix must share to be reused

    def __init__(self, size: int):
        self.size = size
        self._store = {}  # key -> {"cols", "rows", "bucket"}
        self._order = []  # LRU
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._store)

    def lookup(self, prompt: np.ndarray):
        """(m, rows) of the longest common prefix of at least 64 columns
        with a stored prompt, or None. m < t, so at least one suffix column
        is left to prefill (it yields the first sample). `rows` is the
        entry's whole bucket: positions >= m hold the other prompt's k/v,
        which the suffix prefill overwrites or no query sees before a
        decode step overwrites it."""
        t = prompt.shape[1]
        best_m, best_key = 0, None
        for key_, e in self._store.items():
            cols = e["cols"]
            n = min(cols.shape[1], t - 1)
            if n < self.MIN_MATCH:
                continue
            eq = (prompt[:, :n] == cols[:, :n]).all(axis=0)
            m = int(np.argmin(eq)) if not eq.all() else n
            if m > best_m:
                best_m, best_key = m, key_
        if best_m < self.MIN_MATCH or best_key is None:
            return None
        self._order.remove(best_key)
        self._order.append(best_key)  # LRU refresh
        return best_m, self._store[best_key]["rows"]

    def accepts(self, prompt: np.ndarray) -> bool:
        """Whether `store` would keep this prompt: check it before copying
        cache rows."""
        return (bool(self.size) and prompt.shape[1] >= 128
                and hash(prompt.tobytes()) not in self._store)

    def store(self, prompt: np.ndarray, rows: dict, bucket: int):
        """rows: the caller's own copies of the cache rows, (L, 1, bucket,
        ...) per cache tensor."""
        if not self.accepts(prompt):
            return
        key_ = hash(prompt.tobytes())
        self._store[key_] = {"cols": prompt.copy(), "rows": rows,
                             "bucket": bucket}
        self._order.append(key_)
        while len(self._order) > self.size:
            del self._store[self._order.pop(0)]


def restore_prefix_rows(cache, rows):
    """Copy stored prefix rows (L, 1, bucket, ...) into positions [0,
    bucket) of every row of `cache`, for each tensor of its layout (JAX's
    `_restore_prefix_rows`): an eager device copy made just before a suffix
    graph's replay, which reads the cache at its own addresses."""
    for name, dst in cache.items():
        src = rows[name]
        dst[:, :, : src.shape[2]].copy_(src.expand(
            -1, dst.shape[1], *src.shape[2:]))


def hit_suffix_buckets(longest: int, room: int) -> list:
    """Every bucket a prefix hit's suffix can take, for prompts of buckets
    up to `longest` and hits whose prefix plus bucketed suffix must fit
    `room` columns: a hit reuses at least `PrefixStore.MIN_MATCH` stored
    columns, so its suffix's bucket is at most its prompt's. The suffix
    graphs `precompile` captures ahead of the hits."""
    return [b for b in PROMPT_BUCKETS
            if b <= longest and b + PrefixStore.MIN_MATCH <= room]


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


class StepState:
    """The fixed buffers of one stream's (or one lockstep batch's) prefill
    and decode steps, which a captured CUDA graph reads and writes at the
    addresses it was captured with. The host writes a request's inputs in
    place (the prompt, `offsets`, `t_end`, `start`, `sampling`, `seed`,
    `step`); the bodies (`prefill_body`, `suffix_body`, `decode_step`)
    carry the rest on the device. `rows` is 1 for a stream and B for a
    lockstep batch, whose rows share the position, draw and step.

    token (rows, C+1) int32: the last column; pos (1,) int64: the next
    step's position; window (rows, W) int32: the RAS window; seed (rows,)
    int64: each row's seed (`batch_seeds`); draw (1,) int64: the next draw
    of `counter_uniforms` (the first column is draw 0); step (1,) int64:
    the step's row in `cols`; cols (n_steps, rows, C+1) int32: a chunk's
    columns; sampling (3,) fp32: temperature, top_p, top_k; offsets (rows,)
    int32 and t_end (1,) int64: each row's prompt at [offsets, t_end) (a
    batch's prompts are left-padded to a common end; a row attends no
    position below its offset), or under a suffix prefill the suffix's
    real length; start (1,) int32: the suffix's first position; inp: the
    padded prompts (or suffix) of each bucket, (rows, C+1, bucket) int32;
    feats: an audio-conditioned prompt's features and mask of each bucket,
    (rows, bucket, cfg.audio_feature_dim) fp32 and (rows, bucket) bool."""

    def __init__(self, cfg: DualARConfig, scfg: SamplingConfig, cache_len: int,
                 n_steps: int, dtype, act_dtype, device, kv_quant: bool,
                 rows: int = 1):
        c1 = cfg.num_codebooks + 1
        i32 = dict(dtype=torch.int32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.device = device
        self.n_steps = n_steps
        self.rows = rows
        self.cache = dual_ar.init_kv_cache(cfg, rows, cache_len, dtype, device,
                                           quant=kv_quant)
        self.fast_cache = dual_ar.init_fast_kv_cache(cfg, rows, act_dtype, device)
        self.token = torch.zeros((rows, c1), **i32)
        self.pos = torch.zeros((1,), **i64)
        self.window = torch.zeros((rows, scfg.ras_win_size), **i32)
        self.seed = torch.zeros((rows,), **i64)
        self.draw = torch.zeros((1,), **i64)
        self.step = torch.zeros((1,), **i64)
        self.cols = torch.zeros((n_steps, rows, c1), **i32)
        self.sampling = torch.zeros((3,), dtype=torch.float32, device=device)
        self.offsets = torch.zeros((rows,), **i32)
        self.t_end = torch.zeros((1,), **i64)
        self.start = torch.zeros((1,), **i32)
        self.inp = {}
        self.feature_dim = cfg.audio_feature_dim
        self.feats = {}

    def prompt(self, bucket: int):
        """The prompt buffer of `bucket`, made at its first use (a suffix
        of that bucket shares it: one body runs at a time)."""
        if bucket not in self.inp:
            self.inp[bucket] = torch.zeros(
                (self.rows, self.token.shape[1], bucket), dtype=torch.int32,
                device=self.device)
        return self.inp[bucket]

    def features(self, bucket: int):
        """The audio features and mask buffers of `bucket`, made at their
        first use."""
        if bucket not in self.feats:
            self.feats[bucket] = (
                torch.zeros((self.rows, bucket, self.feature_dim),
                            dtype=torch.float32, device=self.device),
                torch.zeros((self.rows, bucket), dtype=torch.bool,
                            device=self.device))
        return self.feats[bucket]

    def carry(self):
        """The tensors a body carries from one run to the next."""
        return self.token, self.pos, self.window, self.draw, self.step

    def sampling_args(self):
        return self.sampling[0], self.sampling[1], self.sampling[2]

    def uniforms(self, cfg: DualARConfig, draw):
        """The uniforms of draw `draw` ((1,) int64) of each row's seed:
        (uniform_rows(C), TOP_K_CAP) for one row, (uniform_rows(C), rows,
        TOP_K_CAP) for a batch."""
        u = counter_uniforms(self.seed, draw.expand(self.rows),
                             uniform_rows(cfg.num_codebooks))
        return u[0] if self.rows == 1 else u.transpose(0, 1)

    def kv_valid(self):
        """A batch's per-row first visible positions (its offsets) for the
        decode kernels' `starts`; None for one row, which attends from 0."""
        return self.offsets if self.rows > 1 else None


def _first_column(params, cfg: DualARConfig, scfg: SamplingConfig,
                  st: StepState, logits_full, hidden, pos):
    """The first column, sampled (no RAS) from draw 0, into `st.token`;
    `st.pos` becomes `pos`, the RAS window is cleared and the next draw is
    1."""
    zero = torch.zeros_like(st.draw)
    column = _sample_column(params, cfg, scfg, _restricted_logits(cfg, logits_full),
                            hidden, None, st.uniforms(cfg, zero),
                            st.sampling_args(), st.fast_cache)
    st.token.copy_(column)
    st.pos.copy_(pos)
    st.window.zero_()
    st.draw.fill_(1)


def prefill_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                 st: StepState, bucket: int, audio: bool = False):
    """JAX's `prefill_step` of the prompt in `st.prompt(bucket)` on the fixed
    buffers (with `audio`, conditioned on `st.features(bucket)`): the first
    column goes to `st.token` and `st.pos` becomes `t_end`."""
    feats, mask = st.features(bucket) if audio else (None, None)
    logits_full, hidden, _ = dual_ar.prefill(params, cfg, st.prompt(bucket),
                                             st.cache, st.offsets, st.t_end,
                                             feats, mask)
    _first_column(params, cfg, scfg, st, logits_full, hidden, st.t_end)


def suffix_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                st: StepState, sbucket: int):
    """JAX's `prefill_suffix_step` after its restore, on the fixed buffers:
    the suffix in `st.prompt(sbucket)` (real length `st.t_end`) prefilled
    at positions `st.start` on over the cache's stored prefix, its first
    column to `st.token`; `st.pos` becomes start + t_end. The caller
    restores the prefix rows into the cache before (`restore_prefix_rows`)."""
    logits_full, hidden, _ = dual_ar.prefill_suffix(
        params, cfg, st.prompt(sbucket), st.cache, st.start, st.t_end)
    _first_column(params, cfg, scfg, st, logits_full, hidden,
                  st.start.long() + st.t_end)


def decode_step(params, cfg: DualARConfig, scfg: SamplingConfig,
                st: StepState):
    """One decode step on the fixed buffers: the slow step at `st.pos` on
    `st.token` (a batch's rows attending from their offsets), the head,
    sampling with RAS from draw `st.draw` of each row's seed, and the fast
    column. The column goes to
    `st.cols[st.step]` and `st.token`, the window rolls, and `pos`, `draw`
    and `step` advance, all on the device: a CUDA graph of this body
    replayed n times runs n steps (JAX's `decode_chunk` scan). Steps run
    past `<|im_end|>`; the host cuts them."""
    hidden, slow_out, _ = dual_ar.decode_slow_step(params, cfg, st.token,
                                                   st.cache, st.pos,
                                                   st.kv_valid())
    logits = dual_ar.semantic_head_logits(params, cfg, slow_out)
    column = _sample_column(params, cfg, scfg, logits, hidden, st.window,
                            st.uniforms(cfg, st.draw), st.sampling_args(),
                            st.fast_cache)
    st.cols.index_copy_(0, st.step, column[None])
    st.token.copy_(column)
    st.window.copy_(torch.cat([st.window[:, 1:], column[:, :1]], dim=1))
    st.pos.add_(1)
    st.draw.add_(1)
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
    int64: each row's prompt end, or under a suffix prefill its suffix's
    real length; start (1,) int32: the suffixes' first position; seed (k,)
    int64; sampling (3, k) fp32; column (k, C+1) int32: the first columns;
    inp: the padded prompts (or suffixes) of each bucket, (k, C+1, bucket)
    int32."""

    def __init__(self, cfg: DualARConfig, scfg: SamplingConfig, k: int,
                 max_bucket: int, dtype, act_dtype, device, kv_quant: bool):
        self.k, self.max_bucket, self.device = k, max_bucket, device
        self.cache = dual_ar.init_kv_cache(cfg, k, max_bucket, dtype, device,
                                           quant=kv_quant)
        self.fast_cache = dual_ar.init_fast_kv_cache(cfg, k, act_dtype, device)
        self.offsets = torch.zeros((k,), dtype=torch.int32, device=device)
        self.t_end = torch.ones((k,), dtype=torch.int64, device=device)
        self.start = torch.zeros((1,), dtype=torch.int32, device=device)
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


def _seeded_first_columns(params, cfg: DualARConfig, scfg: SamplingConfig,
                          logits_full, hidden, seeds, sampling, fast_cache):
    """Each row's first column, sampled with `sampling` from draw 0 of its
    seed (`seeds` (k,) int64; no RAS)."""
    u = counter_uniforms(seeds, torch.zeros_like(seeds),
                         uniform_rows(cfg.num_codebooks))
    return _sample_column(params, cfg, scfg, _restricted_logits(cfg, logits_full),
                          hidden, None, u.transpose(0, 1), sampling, fast_cache)


def _group_columns(params, cfg: DualARConfig, scfg: SamplingConfig,
                   gs: GroupState, logits_full, hidden):
    """Each row's first column, sampled with its own parameters from draw 0
    of its seed (no RAS), into `gs.column`."""
    gs.column.copy_(_seeded_first_columns(params, cfg, scfg, logits_full,
                                          hidden, gs.seed, gs.sampling_args(),
                                          gs.fast_cache))


def prefill_group_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                       gs: GroupState, bucket: int):
    """JAX's `prefill_group_parked` on the fixed buffers: the k prompts of
    `gs.prompt(bucket)` (offsets 0, per-row t_end) prefilled into the
    scratch cache, and each row's first column into `gs.column`."""
    logits_full, hidden, _ = dual_ar.prefill(params, cfg, gs.prompt(bucket),
                                             gs.cache, gs.offsets, gs.t_end)
    _group_columns(params, cfg, scfg, gs, logits_full, hidden)


def prefill_group_suffix_body(params, cfg: DualARConfig, scfg: SamplingConfig,
                              gs: GroupState, sbucket: int):
    """JAX's `prefill_group_parked_suffix` after its restore, on the fixed
    buffers: each row's suffix in `gs.prompt(sbucket)` (real lengths
    `gs.t_end`) prefilled at positions `gs.start` on over the shared prefix
    that the caller restored into every scratch row
    (`restore_prefix_rows`), and each row's first column into
    `gs.column`."""
    logits_full, hidden, _ = dual_ar.prefill_suffix(
        params, cfg, gs.prompt(sbucket), gs.cache, gs.start, gs.t_end)
    _group_columns(params, cfg, scfg, gs, logits_full, hidden)


def prefill_single_into_pool(params, cfg: DualARConfig, scfg: SamplingConfig,
                             inp, pool, scratch, slot, length, seed, sampling):
    """JAX's `prefill_single_into_pool`, eager: the one prompt `inp` (1,
    C+1, bucket) prefilled into the one-row cache `scratch` (offset 0, real
    length `length`), its first column sampled from draw 0 of `seed` with
    `sampling` = (temperature, top_p, top_k), then the scratch rows copied
    into row `slot` of the cache `pool` (`dual_ar.insert_cache_slot`, every
    tensor of the layout). Returns (first column (1, C+1), pool, scratch);
    where JAX returns its split key, the next draw of the seed is 1."""
    return _prefill_into_pool(params, cfg, scfg, inp, pool, scratch, length,
                              [seed], sampling, lambda: dual_ar.insert_cache_slot(
                                  pool, scratch, slot))


def prefill_group_into_pool(params, cfg: DualARConfig, scfg: SamplingConfig,
                            inp, pool, scratch, rows, t_ends, seeds, sampling):
    """JAX's `prefill_group_into_pool`, eager: k prompts (k, C+1, bucket),
    right-aligned at [0, t_ends[i]), prefilled at once into the k-row cache
    `scratch`, each row's first column sampled from draw 0 of its seed
    (`seeds`, k ints), then the rows copied into pool rows `rows` ((k,)
    int64; `dual_ar.insert_cache_rows`, every tensor of the layout).
    Returns (first columns (k, C+1), pool, scratch); where JAX returns the
    rows' split keys, each row's next draw is 1."""
    return _prefill_into_pool(params, cfg, scfg, inp, pool, scratch, t_ends,
                              seeds, sampling, lambda: dual_ar.insert_cache_rows(
                                  pool, scratch, rows))


def _prefill_into_pool(params, cfg, scfg, inp, pool, scratch, t_end, seeds,
                       sampling, insert):
    k, dev = inp.shape[0], inp.device
    logits_full, hidden, scratch = dual_ar.prefill(
        params, cfg, inp, scratch, torch.zeros((k,), dtype=torch.int32, device=dev),
        t_end)
    fast_cache = dual_ar.init_fast_kv_cache(cfg, k, hidden.dtype, dev)
    column = _seeded_first_columns(
        params, cfg, scfg, logits_full, hidden,
        torch.tensor(seeds, dtype=torch.int64, device=dev), sampling, fast_cache)
    insert()
    return column, pool, scratch


# the wrappers whose launch counters a captured graph's replays add to
# (`mm`'s count the int8 products by route: the kernel, or torch's cast)
_WRAPPERS = (flash_decode_attention, flash_decode_attention_kv8,
             flash_prefill_attention, flash_suffix_attention, int4_matmul,
             int8_matmul, int8_ffn, mm)


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


class StreamPartial:
    """The cumulative (C+1, n) columns of a stream, still on the device
    (JAX's `StreamPartial`): `generate_stream(device_partials=True)` yields
    it before any host sync, so a consumer can enqueue device work on the
    columns (the engine's codec) before the host learns where the stream
    ends. The tensor is the partial's own (the step buffers are overwritten
    by the next chunk) and holds whole chunks, untrimmed. On CUDA its host
    copy is enqueued at once into pinned memory behind an event; `host()`
    waits for that copy alone and keeps it; `valid_frames()` applies the
    `<|im_end|>` and budget cut the host path applies before it yields.
    Make one inside `GUARD.launching()`: it enqueues a copy."""

    def __init__(self, device_cols, im_end_id: int, max_cols: int):
        self.device_cols = device_cols  # (C+1, n) cumulative, untrimmed
        self._im_end_id = im_end_id
        self.max_cols = max_cols  # the budget: no column past it is real
        self._host = None
        self._pinned = self._event = None
        if device_cols.is_cuda:
            self._pinned = torch.empty(device_cols.shape, dtype=device_cols.dtype,
                                       pin_memory=True)
            self._pinned.copy_(device_cols, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def host(self) -> np.ndarray:
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
                self._host = self._pinned.numpy()
            else:
                self._host = self.device_cols.numpy().copy()
        return self._host

    def valid_frames(self) -> int:
        """Leading columns that are real frames: up to the first im_end
        (excluded) and never past the budget."""
        cols = self.host()
        n = min(cols.shape[1], self.max_cols)
        ends = np.flatnonzero(cols[0, :n] == self._im_end_id)
        return int(ends[0]) if len(ends) else n


@dataclass
class GenerateResponse:
    action: str  # "sample" | "next" | "partial"
    codes: Optional[np.ndarray] = None
    text: Optional[str] = None
    # a device partial (`StreamPartial`): `codes` is its device tensor of
    # codebook rows, untrimmed, and valid_frames() says how many are real
    valid_frames: Optional[Callable[[], int]] = None


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _graph_name(kind: str, rows: int, bucket: Optional[int] = None) -> str:
    """A session graph's name: `prefill_{bucket}`, `audio_{bucket}` (an
    audio-conditioned prefill), `suffix_{bucket}` and `decode` for one row,
    `prefill_{rows}_{bucket}` and `decode_{rows}` for a lockstep batch."""
    parts = [kind] + ([str(rows)] if rows > 1 else []) + (
        [str(bucket)] if bucket is not None else [])
    return "_".join(parts)


def _parse_graph_name(name: str):
    """(kind, rows, bucket or None) of a `_graph_name`."""
    kind, *nums = name.split("_")
    nums = [int(n) for n in nums]
    if kind == "decode":
        return kind, (nums[0] if nums else 1), None
    return kind, (nums[0] if len(nums) == 2 else 1), nums[-1]


class GenerationSession:
    """Owns the KV cache, the step buffers (`StepState`) and the
    inference-prepared weights of one model, for one stream at a time or
    one lockstep batch of up to `max_batch` prompts (`generate_batch`;
    concurrent streams share the decode pool of `engine/batcher.py`).

    The session re-uses one cache for every request (each prefill writes
    the positions it reads); `params` (plain or quantized, `ops/quant.py`)
    are augmented with the restricted LM head and the fused w1|w3 FFN
    weight. Fusing copies the FFN weights: the caller should drop its own
    reference to `params`, and must not change the session's. `kv_quant`
    keeps the slow cache in int8 with per-(position, head) scales
    (`dual_ar.init_kv_cache(quant=True)`). `prefix_cache_size` > 0 keeps
    the KV rows of that many recent prompts (`PrefixStore`): a prompt that
    shares at least 64 leading columns with one of them restores its rows
    and prefills only the rest (JAX's hit path). A session of `max_batch`
    > 1 refuses it, as JAX's lockstep batch never uses it.

    Each row count has its own step buffers (`StepState`), made at its
    first use; `state` (and `cache`) are those of `max_batch` rows.
    On CUDA every step is a replay of a CUDA graph: one graph per prompt
    bucket for the prefill and its first column (`prefill_{bucket}`; a
    batch of B rows `prefill_{B}_{bucket}`), one per suffix bucket for a
    prefix hit's suffix prefill (`suffix_{sbucket}`) and one for the decode
    step (`decode`, a batch's `decode_{B}`), replayed n times per chunk. A
    graph is captured at the first use of its name, or ahead of time by
    `precompile`, after one eager run of its body that builds the kernels'
    plans and workspaces; a failed capture raises. The graphs share one
    memory pool: they replay on one stream, one at a time, and keep no
    output in it (every result goes to a `StepState` buffer). The weights
    and the cache must stay where they were captured. A capture launches
    no kernel, so it takes back the launch counts its body added; each
    replay adds them again. On the CPU the bodies run eagerly.
    `replays` and `eager_runs` count graph replays and eager body runs by
    name; `capture_seconds` and `pool_bytes` what the captures took.

    `mesh` (`parallel/mesh.py:make_mesh`, dp 1): `params` is this rank's
    shard and every rank makes the same calls in the same order. Its caches
    hold this rank's heads, its restricted head is whole on every rank, and
    its bodies run under `use_mesh(mesh)`: replayed as graphs under nccl,
    eagerly under gloo. Lockstep batches (max_batch > 1) and quantized
    weights are refused under tp > 1, as JAX's server refuses them."""

    def __init__(self, params, cfg: DualARConfig, scfg: SamplingConfig = None,
                 max_batch: int = 1, dtype=torch.bfloat16,
                 decode_chunk_size: int = 32, first_chunk_size: int = 0,
                 pipeline_lookahead: int = 1, kv_quant: bool = False,
                 prefix_cache_size: int = 0, mesh=None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be at least 1")
        if mesh is not None and mesh.tp.size > 1 and (
                max_batch > 1 or has_quantized(params)):
            raise NotImplementedError(
                "tensor-parallel serving drives one stream of bf16/fp32 "
                "weights: lockstep batches (max_batch > 1) and int8/int4 "
                "weights under tp > 1 are not ported (ROADMAP §1 item 10)")
        if max_batch > 1 and prefix_cache_size:
            raise ValueError(
                f"GenerationSession(max_batch={max_batch}) serves lockstep "
                f"batches, which never use the prefix cache: pass "
                f"prefix_cache_size=0 (got {prefix_cache_size})")
        # detached views: a tree fresh from training (LoRA tensors that
        # require grad) must not make decoding record an autograd graph
        params = _detached(params)
        # the weights' bytes, for generate_long's GB/s line (JAX's)
        self.param_bytes = _tree_bytes(params)
        self.mesh = mesh
        with use_mesh(mesh):  # the restricted head gathers over tp
            self.params = fp32_scales(dual_ar.fuse_ffn_weights(
                dual_ar.precompute_semantic_head(params, cfg)))
        self.cfg = cfg.resolve()
        self.scfg = scfg or SamplingConfig()
        self.device = params["embeddings"].device
        self.max_batch = max_batch
        self.dtype = dtype
        self.act_dtype = params["embeddings"].dtype
        self.decode_chunk_size = decode_chunk_size
        self.first_chunk_size = first_chunk_size or decode_chunk_size
        # chunks dispatched ahead of the one being read in generate()
        self.pipeline_lookahead = pipeline_lookahead
        # headroom so a chunk's overshoot never writes past the buffer
        self.cache_len = self.cfg.max_seq_len + decode_chunk_size
        self.kv_quant = kv_quant
        # graphs on CUDA, unless the mesh's collectives cannot be captured
        self.eager = self.device.type != "cuda" or (
            mesh is not None and not mesh.graphs)
        self._states = {}  # rows -> StepState
        self.state = self._state_for(max_batch)
        self.cache = self.state.cache
        self.prefix = PrefixStore(prefix_cache_size)
        self._graphs = {}  # name -> (CUDAGraph, launch counts per replay)
        self._pool = None
        self.capture_seconds = {}
        self.pool_bytes = 0
        self.replays = collections.Counter()
        self.eager_runs = collections.Counter()

    def _state_for(self, rows: int) -> StepState:
        """The step buffers of `rows` rows, made at their first use (a
        chunk of either chunk size fits them)."""
        st = self._states.get(rows)
        if st is None:
            with use_mesh(self.mesh):  # caches of this rank's heads
                st = self._states[rows] = StepState(
                    self.cfg, self.scfg, self.cache_len,
                    max(self.first_chunk_size, self.decode_chunk_size),
                    self.dtype, self.act_dtype, self.device, self.kv_quant, rows)
        return st

    @property
    def prefix_hits(self):
        return self.prefix.hits

    @property
    def prefix_misses(self):
        return self.prefix.misses

    @property
    def hit_buckets(self) -> list:
        """Every suffix bucket a prefix hit of this session can take (none
        with the prefix cache off): what `warm_up` captures ahead."""
        if not self.prefix.size:
            return []
        return hit_suffix_buckets(self._bucket(self.cfg.max_seq_len - 1),
                                  self.cache_len)

    def new_generator(self, seed: int) -> np.random.Generator:
        """The source of one request's per-segment seeds (`request_seed`):
        `generate_long` passes it to each text segment's `generate_stream`,
        as the batcher's session does."""
        return np.random.default_rng(int(seed))

    def _bucket(self, t: int) -> int:
        return min(pick_bucket(t, self.cache_len), self.cfg.max_seq_len)

    def _body(self, name: str):
        kind, rows, bucket = _parse_graph_name(name)
        st = self._state_for(rows)
        if kind == "decode":
            body = functools.partial(decode_step, self.params, self.cfg,
                                     self.scfg, st)
        elif kind == "suffix":
            body = functools.partial(suffix_body, self.params, self.cfg,
                                     self.scfg, st, bucket)
        else:
            body = functools.partial(prefill_body, self.params, self.cfg,
                                     self.scfg, st, bucket, kind == "audio")
        if self.mesh is None:
            return body

        def on_mesh():
            with use_mesh(self.mesh):
                body()
        return on_mesh

    def _capture(self, name: str):
        """Capture graph `name`: one eager run of its body (the carried
        buffers put back after it; a prefill's t_end set to 1, its offsets
        and its start to 0 first, as the buffers may hold a longer
        request's, which would index past this bucket), then the capture
        into the shared pool."""
        t0 = time.perf_counter()
        body = self._body(name)
        st = self._state_for(_parse_graph_name(name)[1])
        with GUARD.launching():
            saved = [t.clone() for t in st.carry()]
            if not name.startswith("decode"):
                st.t_end.fill_(1)
                st.offsets.zero_()
                st.start.zero_()
            body()
            self.eager_runs[name] += 1
            for t, s in zip(st.carry(), saved):
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
        its first use), its body on the CPU or under a gloo mesh."""
        if self.eager:
            self._body(name)()
            self.eager_runs[name] += 1
            return
        replay_graph(*(self._graphs.get(name) or self._capture(name)))
        self.replays[name] += 1

    def _graphs_for(self, *names):
        """Capture the graphs `names` not captured yet (on CUDA): before a
        launching section, which a capture may not sit in."""
        if not self.eager:
            for name in names:
                if name not in self._graphs:
                    self._capture(name)

    def launches_per_replay(self, name: str) -> dict:
        """{counter: launches} one replay of graph `name` adds."""
        return {f"{f.__name__}.{attr}": n
                for (f, attr), n in self._graphs[name][1].items()}

    def precompile(self, prompt_len: int, max_new_tokens: int = 0,
                   first_chunk: Optional[int] = None,
                   suffix_buckets=(), batch: int = 1) -> dict:
        """Capture, ahead of the first request, the graphs a request of
        `prompt_len` tokens and `max_new_tokens` replays: its bucket's
        prefill (`prefill_{bucket}`), unless its budget ends with the
        prefill the decode step (`decode`), and the suffix prefill of each
        bucket of `suffix_buckets` (`suffix_{sbucket}`, a prefix hit's;
        values are mapped to their bucket), the counterpart of the JAX
        session's `precompile`. `batch` > 1 captures a lockstep batch's
        instead (`prefill_{batch}_{bucket}` for a longest prompt of
        `prompt_len`, `decode_{batch}`). One decode graph serves every chunk
        size, so `first_chunk` has only to fit the step buffers. Call it
        between requests: the eager runs write the cache (stored prefixes
        are copies and stay as they are). Returns {name: seconds} of the
        graphs captured by this call (each with its eager run); on the CPU
        nothing is captured and it returns {}, as under a gloo mesh."""
        cfg = self.cfg
        if not 1 <= batch <= self.max_batch:
            raise ValueError(f"batch={batch} outside 1..{self.max_batch}")
        st = self._state_for(batch)
        if first_chunk is not None and not 0 < first_chunk <= st.n_steps:
            raise ValueError(f"first_chunk={first_chunk} outside the step "
                             f"buffers' 1..{st.n_steps}")
        if not 0 < prompt_len < cfg.max_seq_len:
            raise ValueError(f"prompt_len {prompt_len} outside 1.."
                             f"{cfg.max_seq_len - 1}")
        if self.eager:
            return {}
        budget = (max_new_tokens
                  if max_new_tokens and prompt_len + max_new_tokens <= cfg.max_seq_len
                  else cfg.max_seq_len - prompt_len)
        names = [_graph_name("prefill", batch, self._bucket(prompt_len))]
        if budget > 1:
            names.append(_graph_name("decode", batch))
        names += [f"suffix_{pick_bucket(t, self.cache_len)}"
                  for t in suffix_buckets]
        with GUARD.launching():
            self._set_request(st, prompt_len, [0] * batch, self.scfg.temperature,
                              self.scfg.top_p, self.scfg.top_k)
        out = {}
        for name in dict.fromkeys(names):
            if name not in self._graphs:
                self._capture(name)
                out[name] = self.capture_seconds[name]
        return out

    @staticmethod
    def _set_request(st: StepState, t: int, seeds, temperature, top_p, top_k):
        st.t_end.fill_(t)
        if len(seeds) == 1:
            st.seed.fill_(seeds[0])
        else:
            st.seed.copy_(torch.tensor(seeds, dtype=torch.int64))
        for i, v in enumerate((temperature, top_p, top_k)):
            st.sampling[i].fill_(float(v))

    def decode_chunk(self, n: int, generator=None, rows: int = 1):
        """Enqueue n decode steps of the `rows`-row buffers (on CUDA n
        replays of their step graph); returns a copy of their columns (n,
        rows, C+1). Nothing here waits on the device, so chunks can queue.
        The steps draw from each row's seed and the draw counter.
        `generator` is not read: it stays only because
        `scripts/decode_step_profile.py`, kept as it is, still passes one;
        drop it when that script stops passing it."""
        st = self._state_for(rows)
        name = _graph_name("decode", rows)
        self._graphs_for(name)
        with GUARD.launching():
            st.step.zero_()
            for _ in range(n):
                self._run(name)
            return st.cols[:n].clone()

    def generate(self, prompt: np.ndarray, generator, max_new_tokens: int = 0,
                 temperature: float = 1.0, top_p: float = 0.9,
                 top_k: int = 30, audio_features: Optional[np.ndarray] = None,
                 audio_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Generate until im_end or the budget; returns (C+1, N) columns
        including the final im_end column.

        audio_features (T, F) / audio_mask (T,) bool: optional continuous
        conditioning aligned with the prompt
        (`ContentSequence.align_audio_features`); a model with
        `audio_feature_dim > 0` projects them in."""
        last = None
        for last in self.generate_stream(
            prompt, generator, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p, top_k=top_k,
            audio_features=audio_features, audio_mask=audio_mask,
            pipeline_lookahead=self.pipeline_lookahead,
        ):
            pass
        return last

    def _prefill_first(self, prompt: np.ndarray, seed: int, sampling,
                       audio_features=None, audio_mask=None):
        """Enqueue the prefill of `prompt` and its first column: on a
        prefix hit the stored rows' restore and the suffix graph, else the
        prompt's bucket (whose rows are stored when the store takes the
        prompt). JAX's hit and miss decisions and counts: a prompt with
        audio features never looks the store up nor enters it, and
        prefills through `audio_{bucket}` (features and mask padded to the
        bucket; a model without a projector warns and ignores them)."""
        cfg, st = self.cfg, self._state_for(1)
        t = prompt.shape[1]
        audio = audio_features is not None
        pre = (self.prefix.lookup(prompt) if self.prefix.size and not audio
               else None)
        if pre is not None:
            m, rows = pre
            ts = t - m
            sbucket = pick_bucket(ts, self.cache_len)
            if m + sbucket > self.cache_len:
                pre = None  # the suffix's pad tail would overrun the cache
        if pre is not None:
            self.prefix.hits += 1
            inp = np.zeros((1, cfg.num_codebooks + 1, sbucket), np.int32)
            inp[0, :, :ts] = prompt[:, m:]
            name = f"suffix_{sbucket}"
            self._graphs_for(name)
            with GUARD.launching():
                restore_prefix_rows(st.cache, rows)
                st.prompt(sbucket).copy_(torch.from_numpy(inp))
                self._set_request(st, ts, [seed], *sampling)
                st.start.fill_(m)
                self._run(name)
            return
        self.prefix.misses += 1
        bucket = self._bucket(t)
        inp = np.zeros((1, cfg.num_codebooks + 1, bucket), dtype=np.int32)
        inp[0, :, :t] = prompt
        feats = (self._audio_inputs(audio_features, audio_mask, t, bucket)
                 if audio else None)
        name = f"audio_{bucket}" if feats is not None else f"prefill_{bucket}"
        self._graphs_for(name)
        with GUARD.launching():
            st.prompt(bucket).copy_(torch.from_numpy(inp))
            if feats is not None:
                for buf, host in zip(st.features(bucket), feats):
                    buf.copy_(torch.from_numpy(host))
            self._set_request(st, t, [seed], *sampling)
            self._run(name)
            if not audio and self.prefix.accepts(prompt):
                self.prefix.store(prompt, {name: c[:, :, :bucket].clone()
                                           for name, c in st.cache.items()},
                                  bucket)

    def _audio_inputs(self, audio_features, audio_mask, t: int, bucket: int):
        """(features (1, bucket, F) fp32, mask (1, bucket) bool) padded from
        a prompt's (T, F) features and (T,) mask, or None with a warning
        when the model has no projector (JAX's `embed_tokens` ignores them
        there); raises ValueError as JAX's does for a width other than the
        projector's or a missing mask."""
        if "audio_projector" not in self.params:
            logging.getLogger(__name__).warning(
                "audio_features provided but model has no audio_projector")
            return None
        dim = self.params["audio_projector"]["w"].shape[0]
        if audio_features.shape[-1] != dim:
            raise ValueError(f"audio_features dim {audio_features.shape[-1]} "
                             f"!= audio_feature_dim {dim}")
        if audio_mask is None:
            raise ValueError("audio_features requires audio_mask")
        feats = np.zeros((1, bucket, dim), dtype=np.float32)
        feats[0, :t] = audio_features
        mask = np.zeros((1, bucket), dtype=bool)
        mask[0, :t] = audio_mask
        return feats, mask

    def _budget(self, t: int, max_new_tokens: int) -> int:
        if t >= self.cfg.max_seq_len:
            raise ValueError(f"Input sequence length {t} exceeds max_seq_len "
                             f"{self.cfg.max_seq_len}")
        if max_new_tokens and t + max_new_tokens <= self.cfg.max_seq_len:
            return max_new_tokens
        return self.cfg.max_seq_len - t

    def check_request(self, prompt: np.ndarray, max_new_tokens: int = 0,
                      top_k: int = 30) -> int:
        """Raise ValueError for a request `generate_stream` refuses (top_k
        above the cap, a prompt that fills the context), before any step;
        returns its budget of new tokens."""
        check_top_k(top_k)
        return self._budget(prompt.shape[1], max_new_tokens)

    def generate_stream(self, prompt: np.ndarray, generator,
                        max_new_tokens: int = 0, temperature: float = 1.0,
                        top_p: float = 0.9, top_k: int = 30,
                        audio_features: Optional[np.ndarray] = None,
                        audio_mask: Optional[np.ndarray] = None,
                        pipeline_lookahead: int = 0,
                        device_partials: bool = False):
        """Yield the CUMULATIVE (C+1, n) host columns after the prefill frame
        and after every decode chunk; the last yield is the whole sequence.
        `generator`: the request's seed, or the generator of
        `new_generator` that gives it (`request_seed`).

        pipeline_lookahead > 0 enqueues that many chunks beyond the one
        being read, so the device runs chunks back to back.
        device_partials: yield a `StreamPartial` instead, before any host
        sync, after the prefill and after each chunk's enqueue (JAX's
        `_stream_device`; lookahead 0). audio_features / audio_mask: as in
        `generate`."""
        cfg, st = self.cfg, self._state_for(1)
        budget = self.check_request(prompt, max_new_tokens, top_k)
        self._prefill_first(prompt, request_seed(generator),
                            (temperature, top_p, top_k), audio_features,
                            audio_mask)
        if device_partials:
            yield from self._stream_device(budget)
            return
        with GUARD.launching():
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
                inflight.append((self.decode_chunk(n), n))
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

    def _stream_device(self, budget: int):
        """The device partials of the stream whose prefill was enqueued:
        the first column's, then after each enqueued chunk the cumulative
        columns, each yielded before the host reads anything; the host
        checks for im_end after the consumer resumes, through the partial's
        own host copy. Whole chunks, untrimmed (`StreamPartial`)."""
        cfg, st = self.cfg, self._state_for(1)
        with GUARD.launching():
            cum = st.token.T.clone()  # (C+1, 1)
            partial = StreamPartial(cum, cfg.im_end_id, budget)
        yield partial
        if int(partial.host()[0, -1]) == cfg.im_end_id:
            return
        dispatch_left = budget - 1
        first = True
        while dispatch_left > 0:
            n = self.first_chunk_size if first else self.decode_chunk_size
            first = False
            cols = self.decode_chunk(n)
            with GUARD.launching():
                cum = torch.cat([cum, cols[:, 0].T], dim=1)
                partial = StreamPartial(cum, cfg.im_end_id, budget)
            dispatch_left -= n
            yield partial
            if (partial.host()[0] == cfg.im_end_id).any():
                return

    def generate_batch(self, prompts, generator, max_new_tokens: int = 0,
                       temperature: float = 1.0, top_p: float = 0.9,
                       top_k: int = 30, first_chunk_size: Optional[int] = None):
        """JAX's lockstep `generate_batch`: B <= max_batch prompts ((C+1,
        T_i) each) left-padded to a common end t_max, prefilled at B rows
        with per-row offsets (`prefill_{B}_{bucket}`), then decoded in
        lockstep at one position by chunks of `decode_{B}` replays, each
        row attending from its offset (the decode kernels' `starts`). Row
        r draws the uniforms of `batch_seeds(seed, B)[r]`, `seed` being
        `generator` or its next draw (`request_seed`), so its codes do not
        depend on the chunk sizes. Chunks run while any row lacks its
        im_end and the budget (that of the longest prompt) lasts; returns a
        list of (C+1, N_i) arrays, each cut after its own im_end.

        first_chunk_size: an optional smaller first chunk (the streaming
        ramp), then chunks of decode_chunk_size; both must fit the step
        buffers."""
        cfg = self.cfg
        check_top_k(top_k)
        b = len(prompts)
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"{b} prompts for a session of max_batch="
                             f"{self.max_batch}")
        lens = [p.shape[1] for p in prompts]
        t_max = max(lens)
        budget = self._budget(t_max, max_new_tokens)
        st = self._state_for(b)
        chunk = int(first_chunk_size or self.decode_chunk_size)
        if not 0 < chunk <= st.n_steps:
            raise ValueError(f"first_chunk_size={chunk} outside the step "
                             f"buffers' 1..{st.n_steps}")
        bucket = self._bucket(t_max)
        inp = np.zeros((b, cfg.num_codebooks + 1, bucket), dtype=np.int32)
        offsets = np.asarray([t_max - n for n in lens], dtype=np.int32)
        for i, p in enumerate(prompts):
            inp[i, :, offsets[i] : t_max] = p
        name = _graph_name("prefill", b, bucket)
        self._graphs_for(name)
        seeds = batch_seeds(request_seed(generator), b)
        with GUARD.launching():
            st.prompt(bucket).copy_(torch.from_numpy(inp))
            st.offsets.copy_(torch.from_numpy(offsets))
            self._set_request(st, t_max, seeds, temperature, top_p, top_k)
            self._run(name)
            columns = [st.token.cpu().numpy().copy()]  # (B, C+1) each
        done = columns[0][:, 0] == cfg.im_end_id
        steps_left = budget - 1
        while steps_left > 0 and not done.all():
            cols_dev = self.decode_chunk(chunk, rows=b)
            with GUARD.launching():
                cols = cols_dev.cpu().numpy()[: steps_left]  # (n, B, C+1)
            steps_left -= chunk
            columns.extend(cols)
            done = done | (cols[:, :, 0] == cfg.im_end_id).any(axis=0)
            chunk = self.decode_chunk_size
        stacked = np.stack(columns, axis=0)  # (N, B, C+1)
        outputs = []
        for i in range(b):
            ends = np.flatnonzero(stacked[:, i, 0] == cfg.im_end_id)
            n = int(ends[0]) + 1 if len(ends) else stacked.shape[0]
            outputs.append(np.ascontiguousarray(stacked[:n, i].T))
        return outputs

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
                  num_samples: int = 1, max_new_tokens: int = 0,
                  top_p: float = 0.9, top_k: int = 30, temperature: float = 1.0,
                  chunk_length: int = 300, max_speakers: int = 5,
                  prompt_text: Optional[Union[str, List[str]]] = None,
                  prompt_tokens: Optional[Union[np.ndarray, List[np.ndarray]]] = None,
                  seed: int = 42, logger=None, stream_partials: bool = False,
                  device_partials: bool = False, cancel_check=None):
    """Chunked long-form generation: split the text on speaker tags, batch
    the turns (at most `max_speakers` turns and `chunk_length` bytes a
    batch), generate each batch in turn with the earlier batches' codes as
    conversation context; `num_samples` times over, each sample from the
    base conversation again and ending with action="next".

    prompt_text / prompt_tokens: an optional voice-clone prompt (reference
    texts and their (num_codebooks, T) codes) for the system message.
    stream_partials: also yield action="partial" with the cumulative codes
    of the segment in progress after every decode chunk; the closing
    action="sample" repeats the whole segment. device_partials (with
    stream_partials): the partials carry the session's device tensor of
    codebook rows, yielded before any host sync, and a `valid_frames`
    callable that says how many are real (JAX's low-TTFA path;
    `StreamPartial`). The rows are cut at the budget, a host number (where
    JAX passes the whole chunks): past an im_end they are not trimmed, so
    the engine's codec reads the host path's columns except after one. cancel_check: an optional () -> bool polled
    between text segments and decode chunks; True abandons the generation
    (the server wires a client's disconnect here), and closing the
    session's stream frees what it holds. logger: an optional logger given
    each segment's columns, seconds and rates, as JAX's."""
    from fish_speech_tpu_torch.sequence import Conversation, Message, VQPart

    if not 0 < top_p <= 1:
        raise ValueError("top_p must be in (0, 1]")
    if not 0 < temperature < 2:
        raise ValueError("temperature must be in (0, 2)")
    cancelled = cancel_check if cancel_check is not None else (lambda: False)

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
        batches = group_turns_into_batches(turns, max_speakers=max_speakers,
                                           max_bytes=chunk_length)
    else:
        batches = [text]

    generator = session.new_generator(seed)
    kw = dict(max_new_tokens=max_new_tokens, temperature=temperature,
              top_p=top_p, top_k=top_k)
    for _ in range(num_samples):
        conversation = Conversation(list(base_conversation.messages))
        for batch_text in batches:
            encoded = encode_turn(conversation, batch_text, tokenizer,
                                  cfg.num_codebooks)
            if encoded.shape[1] > cfg.max_seq_len - 2048 and cfg.max_seq_len > 2048:
                raise ValueError(f"Prompt is too long: {encoded.shape[1]} > "
                                 f"{cfg.max_seq_len - 2048}")
            if cancelled():
                return
            t0 = time.perf_counter()
            if stream_partials and device_partials:
                last = None
                stream = session.generate_stream(encoded, generator, **kw,
                                                 device_partials=True)
                try:
                    for last in stream:
                        if cancelled():
                            return
                        yield GenerateResponse(
                            action="partial",
                            codes=last.device_cols[1:, : last.max_cols],
                            text=batch_text, valid_frames=last.valid_frames)
                finally:
                    stream.close()
                # the trimmed host sequence (with its im_end column, if
                # any), as the host path's last yield
                host, valid = last.host(), last.valid_frames()
                has_end = (valid < host.shape[1]
                           and int(host[0, valid]) == cfg.im_end_id)
                seq = host[:, : valid + 1 if has_end else valid]
            elif stream_partials or cancel_check is not None:
                # the chunked stream (the loop `session.generate` runs), so
                # the poll fires between decode chunks
                seq = None
                stream = session.generate_stream(
                    encoded, generator, **kw,
                    pipeline_lookahead=(0 if stream_partials else
                                        getattr(session, "pipeline_lookahead", 0)))
                try:
                    for seq in stream:
                        if cancelled():
                            return
                        n_p = seq.shape[1]
                        end_p = (n_p - 1 if n_p and int(seq[0, -1]) == cfg.im_end_id
                                 else n_p)
                        if stream_partials and end_p > 0:
                            yield GenerateResponse(
                                action="partial",
                                codes=np.ascontiguousarray(seq[1:, :end_p]),
                                text=batch_text,
                            )
                finally:
                    stream.close()
            else:
                seq = session.generate(encoded, generator, **kw)
            if logger is not None:
                dt = time.perf_counter() - t0
                tok_s = seq.shape[1] / max(dt, 1e-9)
                logger.info("Generated %d columns in %.2fs (%.1f tok/s, %.1f GB/s, "
                            "RTF %.3f)", seq.shape[1], dt, tok_s,
                            getattr(session, "param_bytes", 0) * tok_s / 1e9,
                            21.5332 / max(tok_s, 1e-9))
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
