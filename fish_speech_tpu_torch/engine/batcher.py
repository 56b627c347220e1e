"""Continuous batching: a fixed pool of decode slots shared by concurrent
requests, in PyTorch.

Port of `fish_speech_tpu/engine/batcher.py`:

  * a worker thread owns the device state: the pool's KV cache and step
    buffers (`generate.PoolState`) plus per-slot host state;
  * new requests are prefilled in GROUPS (one right-aligned prefill per
    prompt bucket, group sizes {16, 4, 1}, 2-3 requests padded to 4)
    dispatched TWO-PHASE: every group is enqueued before any group's first
    columns are read (`_prefill_dispatch` / `_prefill_finalize`);
  * when the pool is full, overflow groups are still prefilled and PARKED
    (their first frame streams back at once), bounded by `park_max_rows`
    allocated rows; freed slots later take parked rows without a second
    prefill (`_activate_parked`);
  * every iteration runs the pool's decode step over all rows, dispatched
    as sub-chunks of `admit_every` steps, two in flight, and an arrival
    interrupts dispatch after at most one in-flight sub-chunk
    (`_run_chunk`); a sub-chunk's columns, positions and active flags reach
    the host through pinned buffers and a CUDA event, so reading sub-chunk
    i never waits for sub-chunk i+1, and admission state is written through
    pinned buffers too (no stream synchronisation);
  * a row retires on its own im_end, its budget, or its client's cancel.

On CUDA every decode step and every admission prefill is the replay of a
CUDA graph: one of the pool step (`decode`, replayed n times per
sub-chunk) and one per admission signature and prompt bucket
(`prefill_{k}_{bucket}`), captured by `precompile` before traffic (else at
first use; a capture waits for the process's other device work through
`generate.GUARD`). The graph dict is the counterpart of JAX's `_aot`
executables; a failed capture or replay raises, and a worker crash fails
every client with the exception. On the CPU the same bodies run eagerly.

A request's sampled codes depend only on its seed and prompt: a row's
uniforms are `counter_uniforms` of its seed and draw index, computed in the
step, whatever its slot, its neighbours or its chunks.

The w1|w3 FFN weights are fused (`dual_ar.fuse_ffn_weights`), unlike the
JAX pool, which skipped the fusion for HBM room on a 16 GB chip: one product
launch fewer per layer, for a transient copy of the FFN weights while the
batcher is built (an H100 holds it).

Not ported yet (ROADMAP): the prefix cache (`prefix_cache_size > 0`
raises).
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, SamplingConfig
from fish_speech_tpu_torch.generate import (GUARD, PROMPT_BUCKETS, GroupState,
                                            PoolState, _detached,
                                            apply_admission, capture_graph,
                                            pick_bucket, pool_decode_step,
                                            prefill_group_body, replay_graph,
                                            scatter_parked_rows)
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.quant import fp32_scales
from fish_speech_tpu_torch.ops.sampling import check_top_k

SIGNATURES = (16, 4, 1)  # admission group sizes, each a graph per bucket


def _alloc_rows(k: int) -> int:
    """Cache rows a k-request admission group allocates: the nearest
    signature {1, 4, 16} at or above k."""
    return k if k in SIGNATURES else (4 if k < 4 else 16)


@dataclass
class BatchRequest:
    prompt: np.ndarray  # (C+1, T)
    max_new_tokens: int = 0
    temperature: float = 0.8
    top_p: float = 0.8
    top_k: int = 30
    seed: int = 42
    # output stream: (n, C+1) arrays per emission, then None (or the
    # worker's exception)
    out: "queue.Queue" = field(default_factory=queue.Queue)
    # client gone: the worker reaps the request at the next boundary
    cancelled: threading.Event = field(default_factory=threading.Event)


@dataclass
class _Slot:
    active: bool = False
    request: Optional[BatchRequest] = None
    pos: int = 0
    budget_left: int = 0


@dataclass
class _Parked:
    """A prefilled admission group waiting for slots: its own copy of the
    group's cache rows (L, k, bucket, ...); its requests already received
    their first frame."""

    cache: dict
    reqs: List[BatchRequest]
    t_ends: np.ndarray
    cols: np.ndarray  # (k, C+1) first columns
    alive: List[bool]
    rows_alloc: int  # the signature's rows, for the parked-row budget

    def pending_rows(self) -> List[int]:
        return [i for i, a in enumerate(self.alive) if a]


class BatcherSession:
    """`GenerationSession`-compatible facade over a `ContinuousBatcher`, so
    the engine's `generate_long` drives the shared pool unchanged.
    `concurrent = True` tells the engine not to serialise requests."""

    concurrent = True

    def __init__(self, batcher: "ContinuousBatcher"):
        self.batcher = batcher
        self.cfg = batcher.cfg
        self.scfg = batcher.scfg

    def new_generator(self, seed: int) -> np.random.Generator:
        """The source of one request's per-segment seeds: `generate_long`
        passes it to each text segment's `generate_stream`."""
        return np.random.default_rng(int(seed))

    @staticmethod
    def _seed_of(generator) -> int:
        return int(generator.integers(0, 2**31 - 1))

    def generate(self, prompt, generator, max_new_tokens=0, temperature=1.0,
                 top_p=0.9, top_k=30, **_):
        return self.batcher.generate(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, top_k=top_k, seed=self._seed_of(generator))

    def generate_stream(self, prompt, generator, max_new_tokens=0,
                        temperature=1.0, top_p=0.9, top_k=30, **_):
        """Yield the CUMULATIVE (C+1, n) columns as the pool emits this
        request's columns; emissions queued while the consumer was busy are
        taken together. Closing the generator early marks the request
        cancelled, so the pool frees its slot at the next boundary."""
        req = BatchRequest(prompt=prompt, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_p=top_p, top_k=top_k,
                           seed=self._seed_of(generator))
        out = self.batcher.submit(req)
        chunks = []
        done = False
        try:
            while not done:
                items = [out.get()]
                while items[-1] is not None and not isinstance(
                        items[-1], BaseException):
                    try:
                        items.append(out.get_nowait())
                    except queue.Empty:
                        break
                for item in items:
                    if isinstance(item, BaseException):
                        done = True
                        raise RuntimeError("batcher worker failed") from item
                    if item is None:
                        done = True
                    else:
                        chunks.append(item)
                if any(item is not None for item in items):
                    yield np.concatenate(chunks, axis=0).T
            if not chunks:
                yield np.zeros((self.cfg.num_codebooks + 1, 0), np.int32)
        finally:
            if not done:
                req.cancelled.set()
                self.batcher._wake.set()


class ContinuousBatcher:
    """The decode pool; see the module docstring. `params` (plain or
    quantized, `ops/quant.py`) are prepared as the session prepares them
    (restricted head, fused FFN): the caller should drop its reference.
    The device is the params' device. JAX's unused `idle_sleep` is not
    taken."""

    def __init__(self, params, cfg: DualARConfig, scfg: SamplingConfig = None,
                 pool_size: int = 4, dtype=torch.bfloat16,
                 decode_chunk_size: int = 16, first_chunk_size: int = 0,
                 kv_quant: bool = False, prefix_cache_size: int = 0,
                 admit_every: int = 4):
        if admit_every < 0:
            # a negative value would make _chunk_plan return an empty plan
            # and the worker busy-spin with admitted streams never decoding
            raise ValueError(f"admit_every must be >= 0, got {admit_every}")
        if prefix_cache_size > 0:
            raise NotImplementedError(
                "the prefix cache (prefill_group_parked_suffix, PrefixStore) "
                "is not ported yet: ROADMAP §1 item 4")
        params = _detached(params)
        self.params = fp32_scales(dual_ar.fuse_ffn_weights(
            dual_ar.precompute_semantic_head(params, cfg)))
        self.cfg = cfg.resolve()
        self.scfg = scfg or SamplingConfig()
        self.device = params["embeddings"].device
        self.dtype = dtype
        self._act_dtype = params["embeddings"].dtype
        self.pool_size = pool_size
        self.chunk = decode_chunk_size
        self.first_chunk = first_chunk_size or decode_chunk_size
        self.admit_every = admit_every
        self.kv_quant = kv_quant
        self.cache_len = self.cfg.max_seq_len + decode_chunk_size
        n_steps = max(self._chunk_plan(self.chunk) + self._chunk_plan(self.first_chunk))
        self.state = PoolState(self.cfg, self.scfg, pool_size, self.cache_len,
                               n_steps, dtype, self._act_dtype, self.device,
                               kv_quant)
        self.groups = {}  # k -> GroupState (the signature's scratch)
        self.slots: List[_Slot] = [_Slot() for _ in range(pool_size)]
        self.parked: List[_Parked] = []
        self.park_max_rows = 2 * pool_size
        self.parked_groups = 0  # groups ever parked (stats)
        self._overflow: List[BatchRequest] = []
        # taken from the overflow by the admission pass under way (failed
        # with the worker's exception if it crashes before placing them)
        self._admitting: List[BatchRequest] = []
        self._worker_error: Optional[BaseException] = None
        # name -> (CUDAGraph, launches per replay); one pool for all graphs,
        # which replay one at a time on one stream and keep no output in it
        self._graphs = {}
        self._pool = None
        self.capture_seconds = {}
        self.pool_growth = {}  # name -> bytes its capture grew the pool by
        self.pool_bytes = 0
        self.replays = collections.Counter()
        self.eager_runs = collections.Counter()
        # held by the worker for each pass and by precompile
        self._state_lock = threading.RLock()
        self.pending: "queue.Queue[BatchRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    # -- public api --

    def submit(self, request: BatchRequest) -> "queue.Queue":
        """Queue a request; returns its output queue ((n, C+1) arrays, then
        None, or the worker's exception if it crashed)."""
        check_top_k(request.top_k)
        if self._worker_error is not None or not self.thread.is_alive():
            request.out.put(self._worker_error
                            or RuntimeError("batcher worker is not running"))
            return request.out
        self.pending.put(request)
        self._wake.set()
        return request.out

    def generate(self, prompt: np.ndarray, **kw) -> np.ndarray:
        """Blocking convenience wrapper -> (C+1, N) columns incl. im_end."""
        out = self.submit(BatchRequest(prompt=prompt, **kw))
        chunks = []
        while True:
            item = out.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise RuntimeError("batcher worker failed") from item
            chunks.append(item)
        if not chunks:
            return np.zeros((self.cfg.num_codebooks + 1, 0), np.int32)
        return np.concatenate(chunks, axis=0).T

    def stats(self) -> dict:
        """Point-in-time pool observability (unsynchronised snapshots)."""
        parked = list(self.parked)
        return {
            "pool_size": self.pool_size,
            "active_slots": sum(1 for s in self.slots if s.active),
            "queued": self.pending.qsize() + len(self._overflow),
            "parked_rows": sum(len(pk.pending_rows()) for pk in parked),
            "parked_groups": self.parked_groups,
            "worker_alive": self.thread.is_alive(),
        }

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        self.thread.join(timeout=10)

    def launches_per_replay(self, name: str) -> dict:
        """{counter: launches} one replay of graph `name` adds."""
        return {f"{f.__name__}.{attr}": n
                for (f, attr), n in self._graphs[name][1].items()}

    # -- graphs --

    def _group(self, k: int, bucket: int) -> GroupState:
        """The scratch of signature k, at least `bucket` long; a longer
        bucket than the scratch's replaces it and drops its graphs."""
        gs = self.groups.get(k)
        if gs is None or gs.max_bucket < bucket:
            with GUARD.launching():
                if gs is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)  # its graphs may be queued
                    for name in [n for n in self._graphs
                                 if n.startswith(f"prefill_{k}_")]:
                        del self._graphs[name]
                gs = self.groups[k] = GroupState(
                    self.cfg, self.scfg, k, bucket, self.dtype,
                    self._act_dtype, self.device, self.kv_quant)
        return gs

    def _body(self, name: str):
        if name == "decode":
            return functools.partial(pool_decode_step, self.params, self.cfg,
                                     self.scfg, self.state)
        _, k, bucket = name.split("_")
        return functools.partial(prefill_group_body, self.params, self.cfg,
                                 self.scfg, self.groups[int(k)], int(bucket))

    def _graph(self, name: str):
        """Capture graph `name` unless it is captured (on CUDA): one eager
        run of its body (`_eager_run`), then the capture into the
        batcher's pool, outside any launching section. Raises if the
        capture fails."""
        if self.device.type != "cuda" or name in self._graphs:
            return
        t0 = time.perf_counter()
        if name != "decode":
            _, k, bucket = name.split("_")
            self._group(int(k), int(bucket))
        self._eager_run(name)
        body = self._body(name)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, launches, grown = capture_graph(body, self._pool, self.device)
        self.pool_growth[name] = grown
        self.pool_bytes += grown
        self.capture_seconds[name] = time.perf_counter() - t0
        self._graphs[name] = (graph, launches)

    def _eager_run(self, name: str):
        """One eager run of graph `name`'s body outside a capture: the
        pool's carried buffers put back after it, and a group's t_end set
        to 1 before it (its scratch may hold a longer bucket's prompt
        ends, which would index past this bucket)."""
        with GUARD.launching():
            saved = [t.clone() for t in self.state.carry()]
            self.state.step.zero_()
            if name != "decode":
                self.groups[int(name.split("_")[1])].t_end.fill_(1)
            self._body(name)()
            self.eager_runs[name] += 1
            for t, s in zip(self.state.carry(), saved):
                t.copy_(s)

    def _run(self, name: str):
        """Run step `name` once: a replay of its graph on CUDA (captured
        beforehand by `_graph`), its body on the CPU."""
        if self.device.type != "cuda":
            self._body(name)()
            self.eager_runs[name] += 1
            return
        replay_graph(*self._graphs[name])
        self.replays[name] += 1

    def _write(self, dst: torch.Tensor, arr: np.ndarray):
        """Host values into a device buffer: through pinned memory and a
        non-blocking copy on CUDA, so the stream is not synchronised."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        dst = torch.empty(arr.shape, device=self.device,
                          dtype=torch.from_numpy(arr[:0]).dtype)
        self._write(dst, arr)
        return dst

    def _to_host(self, *tensors):
        """Start copies of `tensors` to the host; `_fetch` reads them. On
        CUDA into pinned buffers behind a CUDA event, so a later read waits
        for this point of the stream only."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _fetch(staged):
        host, event = staged
        if event is not None:
            with GUARD.launching():
                event.synchronize()
        return [h.numpy() for h in host]

    def precompile(self, buckets=None) -> dict:
        """Capture, before serving traffic, every graph the pool can
        replay: the decode step and each admission signature {1, 4, 16}
        (those within the pool size) at each prompt bucket in `buckets`
        (default: every bucket a prompt below max_seq_len can reach). The
        counterpart of JAX's `precompile` (`fish_speech_tpu/engine/
        batcher.py:763-907`). Returns {name: seconds} of the graphs it
        captured (each with its eager run); on the CPU nothing is captured
        and it returns {}."""
        with self._state_lock:
            if (any(s.active for s in self.slots) or self.parked
                    or self._overflow or not self.pending.empty()):
                raise RuntimeError("ContinuousBatcher.precompile must run "
                                   "before serving traffic")
            if self.device.type != "cuda":
                return {}
            cfg = self.cfg
            if buckets is None:
                buckets = tuple(b for b in PROMPT_BUCKETS
                                if b < cfg.max_seq_len) or (cfg.max_seq_len,)
            buckets = sorted({pick_bucket(b, self.cache_len) for b in buckets})
            ks = [g for g in SIGNATURES if g <= max(self.pool_size, 1)]
            for k in ks:  # each scratch at the largest bucket, made once
                self._group(k, buckets[-1])
            names = ["decode"] + [f"prefill_{k}_{b}" for b in buckets for k in ks]
            out = {}
            for name in names:
                if name not in self._graphs:
                    self._graph(name)
                    out[name] = self.capture_seconds[name]
            return out

    # -- worker --

    def _drain_pending(self):
        while True:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            if req.prompt.shape[1] >= self.cfg.max_seq_len:
                req.out.put(None)
                continue
            self._overflow.append(req)

    def _deactivate(self, i: int):
        """Retire slot i on the host and in the pool's `active`."""
        self.slots[i].active = False
        self.slots[i].request = None
        with GUARD.launching():
            self.state.active[i] = False

    def _reap_cancelled(self):
        """Free what cancelled requests hold: active slots, queued overflow
        and parked rows; each reaped queue ends with None."""
        for i, s in enumerate(self.slots):
            if s.active and s.request is not None and s.request.cancelled.is_set():
                s.request.out.put(None)
                self._deactivate(i)
        if self._overflow:
            keep = []
            for req in self._overflow:
                if req.cancelled.is_set():
                    req.out.put(None)
                else:
                    keep.append(req)
            self._overflow = keep
        for pk in self.parked:
            for j, req in enumerate(pk.reqs):
                if pk.alive[j] and req.cancelled.is_set():
                    pk.alive[j] = False
                    req.out.put(None)
        self.parked = [pk for pk in self.parked if pk.pending_rows()]

    def _request_budget(self, req: BatchRequest, t: int) -> int:
        cfg = self.cfg
        if req.max_new_tokens and t + req.max_new_tokens <= cfg.max_seq_len:
            return req.max_new_tokens
        return cfg.max_seq_len - t

    def _admit(self):
        """Admit requests into free slots and park burst overflow, as JAX's
        `_admit`: freed slots go to parked rows first (the oldest requests),
        then direct admission of the overflow in per-bucket groups, then
        parking of the rest up to the parked-row budget. Both admission
        sites are two-phase: every group's prefill is dispatched before any
        group's first columns are read."""
        self._drain_pending()
        self._reap_cancelled()
        free = [i for i, s in enumerate(self.slots) if not s.active]
        admitted = False

        while free and self.parked:
            pk = self.parked[0]
            avail = pk.pending_rows()
            m = min(len(free), len(avail))
            m = next(g for g in SIGNATURES if g <= m)
            idxs, rows = avail[:m], free[:m]
            free = free[m:]
            self._activate_parked(pk, idxs, rows)
            admitted = True
            if not pk.pending_rows():
                self.parked.pop(0)

        if free and not self.parked and self._overflow:
            batch = self._overflow[: len(free)]
            del self._overflow[: len(batch)]
            self._admitting = list(batch)
            by_bucket = {}
            for req in batch:
                b = pick_bucket(req.prompt.shape[1], self.cache_len)
                by_bucket.setdefault(b, []).append(req)
            staged = []
            for bucket, reqs in sorted(by_bucket.items()):
                i = 0
                for k in self._group_plan(len(reqs)):
                    staged.append(self._prefill_dispatch(bucket, reqs[i : i + k]))
                    i += k
            for st in staged:
                pk = self._prefill_finalize(st)
                if pk is not None:
                    avail = pk.pending_rows()
                    rows = free[: len(avail)]
                    free = free[len(avail):]
                    self._activate_parked(pk, avail, rows)
            admitted = True

        parked_rows = sum(pk.rows_alloc for pk in self.parked)
        staged = []
        while self._overflow and parked_rows < self.park_max_rows:
            bucket, reqs = self._select_park_group(self.park_max_rows - parked_rows)
            self._admitting.extend(reqs)
            staged.append(self._prefill_dispatch(bucket, reqs))
            parked_rows += _alloc_rows(len(reqs))
        for st in staged:
            pk = self._prefill_finalize(st)
            if pk is not None:
                self.parked.append(pk)
                self.parked_groups += 1
        self._admitting = []
        return admitted

    def _group_plan(self, n: int):
        """Split n same-bucket requests into admission-group sizes: greedy
        {16, 4} (bounded by the pool size), then a 1-3 remainder as one
        group (2-3 ride the padded 4-signature)."""
        cap = max(self.pool_size, 1)
        sizes = []
        for g in (16, 4):
            if g <= cap:
                while n >= g:
                    sizes.append(g)
                    n -= g
        if n:
            if n > 1 and 4 <= cap:
                sizes.append(n)
            else:
                sizes.extend([1] * n)
        return sizes

    def _select_park_group(self, max_rows: int):
        """Take one overflow group to park: the oldest request's bucket
        gathered across the whole overflow list (per-bucket FIFO), shrunk
        to fit the parked-row budget. Returns (bucket, reqs)."""
        bucket = pick_bucket(self._overflow[0].prompt.shape[1], self.cache_len)
        cap = min(16, max_rows, max(self.pool_size, 1))
        run_idx = [i for i, req in enumerate(self._overflow)
                   if pick_bucket(req.prompt.shape[1], self.cache_len) == bucket][:cap]
        k = self._group_plan(len(run_idx))[0]
        if _alloc_rows(k) > max_rows:
            k = max(g for g in SIGNATURES if g <= max_rows)
        reqs = [self._overflow[i] for i in run_idx[:k]]
        for i in reversed(run_idx[:k]):
            del self._overflow[i]
        return bucket, reqs

    def _prefill_dispatch(self, bucket: int, reqs):
        """Phase 1: enqueue the group's prefill (the graph of its signature
        and bucket; 2-3 requests padded to 4 with t_end 1, temperature and
        top_p 1, top_k 1), a copy of its cache rows for the parked entry,
        and the copy of its first columns to the host. Nothing waits."""
        cfg = self.cfg
        k = len(reqs)
        ksig, pad = _alloc_rows(k), _alloc_rows(k) - k
        name = f"prefill_{ksig}_{bucket}"
        gs = self._group(ksig, bucket)
        self._graph(name)
        t_ends = np.asarray([req.prompt.shape[1] for req in reqs], np.int64)
        inp = np.zeros((ksig, cfg.num_codebooks + 1, bucket), np.int32)
        for j, req in enumerate(reqs):
            inp[j, :, : t_ends[j]] = req.prompt
        ones = [1.0] * pad
        sampling = np.asarray([[r.temperature for r in reqs] + ones,
                               [r.top_p for r in reqs] + ones,
                               [r.top_k for r in reqs] + ones], np.float32)
        with GUARD.launching():
            self._write(gs.prompt(bucket), inp)
            self._write(gs.t_end, np.concatenate([t_ends, np.ones(pad, np.int64)]))
            self._write(gs.seed, np.asarray([r.seed for r in reqs] + [0] * pad,
                                            np.int64))
            self._write(gs.sampling, sampling)
            self._run(name)
            cache = {n: t[:, :k, :bucket].clone() for n, t in gs.cache.items()}
            column = self._to_host(gs.column)
        return reqs, t_ends, column, cache, ksig

    def _prefill_finalize(self, staged) -> Optional[_Parked]:
        """Phase 2: read the group's first columns, stream each request's
        first frame, and build the parked entry (None if every row ended
        at its first frame)."""
        reqs, t_ends, column, cache, ksig = staged
        k = len(reqs)
        cols = self._fetch(column)[0][:k]
        alive = []
        for j, req in enumerate(reqs):
            req.out.put(cols[j : j + 1].copy())
            if int(cols[j, 0]) == self.cfg.im_end_id or self._request_budget(
                    req, int(t_ends[j])) <= 1:
                req.out.put(None)
                alive.append(False)
            else:
                alive.append(True)
        if not any(alive):
            return None
        return _Parked(cache=cache, reqs=list(reqs), t_ends=t_ends, cols=cols,
                       alive=alive, rows_alloc=ksig)

    def _activate_parked(self, pk: _Parked, idxs, rows):
        """Move parked rows `idxs` into pool slots `rows` (no second
        prefill): their cache rows, then their position, seed, first
        column and sampling parameters (`apply_admission`)."""
        ints = np.zeros((len(rows), 2 + self.cfg.num_codebooks + 1), np.int64)
        floats = np.zeros((3, len(rows)), np.float32)
        for n, (j, r) in enumerate(zip(idxs, rows)):
            req = pk.reqs[j]
            t = int(pk.t_ends[j])
            s = self.slots[r]
            s.active, s.request, s.pos = True, req, t
            s.budget_left = self._request_budget(req, t) - 1
            ints[n, 0], ints[n, 1], ints[n, 2:] = t, req.seed, pk.cols[j]
            floats[:, n] = (req.temperature, req.top_p, req.top_k)
            pk.alive[j] = False
        with GUARD.launching():
            rows_t = self._to_device(np.asarray(rows, np.int64))
            scatter_parked_rows(self.state.cache, pk.cache,
                                self._to_device(np.asarray(idxs, np.int64)),
                                rows_t)
            apply_admission(self.state, rows_t, self._to_device(ints),
                            self._to_device(floats))

    def _loop(self):
        """Worker entry: a crash (device OOM, a failed capture or replay)
        fails every waiting client with the exception."""
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            self._worker_error = e
            for s in self.slots:
                if s.active and s.request is not None:
                    s.request.out.put(e)
                    s.active = False
            for pk in self.parked:
                for j, req in enumerate(pk.reqs):
                    if pk.alive[j]:
                        req.out.put(e)
            self.parked.clear()
            self._drain_pending()
            for req in self._admitting + self._overflow:
                req.out.put(e)
            self._overflow.clear()
            raise

    def _loop_inner(self):
        while not self._stop.is_set():
            with self._state_lock:
                admitted = self._admit()
                busy = any(s.active for s in self.slots)
                if busy:
                    # a short chunk right after an admission, or while an
                    # overflow request waits for a park that can happen
                    waiting_park = self._overflow and (
                        sum(pk.rows_alloc for pk in self.parked)
                        < self.park_max_rows)
                    self._run_chunk(self.first_chunk if (admitted or waiting_park)
                                    else self.chunk)
            if not busy:
                self._wake.wait(timeout=0.1)
                self._wake.clear()

    def _admit_possible(self) -> bool:
        """Whether an `_admit` pass could place a pending request now."""
        if any(not s.active for s in self.slots):
            return True
        return sum(pk.rows_alloc for pk in self.parked) < self.park_max_rows

    def _chunk_plan(self, n: int):
        """Split an n-step chunk into sub-chunks of `admit_every` steps."""
        sub = self.admit_every
        if not sub or n <= sub:
            return [n]
        plan = [sub] * (n // sub)
        if n % sub:
            plan.append(n % sub)
        return plan

    def _dispatch_steps(self, n: int):
        """Enqueue n pool steps and the copies of their columns, positions
        and active flags to the host."""
        self._graph("decode")
        st = self.state
        with GUARD.launching():
            st.step.zero_()
            for _ in range(n):
                self._run("decode")
            return self._to_host(st.cols[:n], st.active, st.pos)

    def _run_chunk(self, n: int):
        """Dispatch an n-step decode as pipelined sub-chunks (two in
        flight) with early admission, as JAX's `_run_chunk`. Each in-flight
        entry carries a snapshot of the slots' owners at its dispatch, so a
        slot re-filled by an overlapped admission never receives an older
        sub-chunk's columns. Unlike JAX's, it stops dispatching once every
        slot has retired (the rest of the chunk would step frozen rows)."""
        cfg = self.cfg
        plan = self._chunk_plan(n)
        inflight = collections.deque()
        next_i = 0
        stop_dispatch = False

        def interrupt() -> bool:
            if self._stop.is_set():
                return True
            if self.pending.empty() or not self._admit_possible():
                return False
            self._admit()
            return True

        while next_i < len(plan) or inflight:
            while not stop_dispatch and next_i < len(plan) and len(inflight) < 2:
                if inflight and interrupt():
                    stop_dispatch = True
                    next_i = len(plan)
                    break
                if not any(s.active for s in self.slots):
                    next_i = len(plan)  # every row retired: nothing to step
                    break
                ni = plan[next_i]
                owners = tuple(s.request if s.active else None for s in self.slots)
                inflight.append((ni, self._dispatch_steps(ni), owners))
                next_i += 1

            ni, staged, owners = inflight.popleft()
            cols_np, still_active, pos_np = self._fetch(staged)
            for i, s in enumerate(self.slots):
                if owners[i] is None or s.request is not owners[i]:
                    continue  # freed, or re-owned by an overlapped admission
                s.pos = int(pos_np[i])
                slot_cols = cols_np[:, i]
                ends = np.nonzero(slot_cols[:, 0] == cfg.im_end_id)[0]
                n_emit = min(int(ends[0]) + 1 if len(ends) else ni, s.budget_left)
                if n_emit > 0:
                    s.request.out.put(slot_cols[:n_emit].copy())
                s.budget_left -= ni
                if len(ends) or s.budget_left <= 0 or not bool(still_active[i]):
                    s.request.out.put(None)
                    self._deactivate(i)

            if not stop_dispatch and interrupt():
                stop_dispatch = True
                next_i = len(plan)
