"""The (dp, tp) mesh on `torch.distributed`, and the Megatron layout of the
Dual-AR tree.

Port of `fish_speech_tpu/parallel/mesh.py`. JAX runs one process per host
driving every chip of a global mesh, and GSPMD inserts the collectives. The
port runs one process per card, PyTorch's own idiom: a rank joins the
process group (`init_distributed`), `make_mesh(dp, tp)` gives it its two
groups (`Mesh.dp`, `Mesh.tp`: the ranks that share its tp coordinate, and
those that share its dp coordinate; rank = dp_index * tp + tp_index, as
JAX's `reshape(dp, tp)`), `shard_params` cuts its part of the tree, and
the model calls the collectives itself (`parallel/collectives.py`) while
`use_mesh(mesh)` is in force.

The layout is the JAX package's (`dual_ar_param_specs`): wqkv, w1, w3, the
untied output, the fast output and the fast project_in are column-parallel;
wo and w2 are row-parallel; the embedding table is split over the
vocabulary; norms, biases after a reduction, the codebook embeddings and
every LoRA leaf are replicated; the KV cache is split over heads and the
batch over dp. Two places differ from an even split of the stored axis,
where GSPMD would reshard and the port must not: the fused wqkv (and bqkv)
gives each rank its block of q heads, its block of k heads and its block
of v heads (contiguous blocks keep every GQA group on one rank), and a
fused w13 gives each rank [its w1 columns | its w3 columns]. A stack whose
heads or FFN width do not divide by tp stays whole on every rank (JAX's
`host_shard` replicates such leaves too), as does a vocabulary that does
not divide (`tp_layout`).
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from fish_speech_tpu_torch.config import DualARConfig

# every process group gets one: a rank that raises leaves the others in a
# collective, which then fails after this long instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def default_device(rank: Optional[int] = None) -> torch.device:
    """`cuda:{rank % device_count}`; raises RuntimeError without CUDA (a
    rank runs on the CPU only when its caller passes device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "(--cpu) to run the ranks on the CPU")
    rank = dist.get_rank() if rank is None else rank
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def init_distributed(coordinator: Optional[str] = None,
                     num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None, timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> bool:
    """Join the process group: `coordinator` is the rendezvous ("host:port",
    or a URL such as "file:///path"), `num_hosts` the world size and
    `host_id` this process's rank (the JAX flags' names; JAX's processes
    are hosts, the port's are cards). The backend is the caller's, else
    "nccl" for a CUDA rank and "gloo" for a CPU rank (`device`, default
    `default_device`); nothing switches it afterwards. A CUDA rank's device
    becomes the current one. Returns False, doing nothing, without a
    coordinator."""
    if not coordinator:
        return False
    if num_hosts is None or host_id is None:
        raise ValueError("--coordinator needs --num-hosts and --host-id")
    device = torch.device(device) if device is not None else default_device(host_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_hosts),
                            rank=int(host_id), timeout=timeout)
    return True


class Axis:
    """One mesh axis as this rank sees it: `size` ranks in `group` (global
    ranks `ranks`), this one at `rank`. The collectives sum; under gloo
    they use all_reduce and broadcast only (the calls gloo gives on CUDA
    tensors too), reducing 16-bit floats in fp32. `calls` counts the
    collectives this rank has issued (a graph capture records them without
    running them)."""

    def __init__(self, name: str, ranks, rank: int, group, backend: str):
        self.name = name
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        self.group = group
        self.backend = backend
        self.calls = 0
        self._index = {}

    def __repr__(self):
        return f"Axis({self.name}, {self.rank}/{self.size}, {self.backend})"

    def all_reduce(self, x):
        """Sum `x` over the axis, in place; returns x."""
        self.calls += 1
        if self.backend != "nccl" and x.dtype in (torch.bfloat16, torch.float16):
            y = x.float()
            dist.all_reduce(y, group=self.group)
            return x.copy_(y)
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x, dim: int = -1):
        """Every rank's `x` concatenated along `dim`, in rank order."""
        x = x.contiguous()
        if self.backend == "nccl":
            self.calls += 1
            out = x.new_empty((self.size, *x.shape))
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:  # zeros elsewhere: the sum is exact
            out = x.new_zeros((self.size, *x.shape))
            out[self.rank] = x
            self.all_reduce(out)
        return torch.cat(out.unbind(0), dim=dim)

    def reduce_scatter(self, x):
        """x (size, n): this rank's row of the sum over the axis."""
        if self.backend == "nccl":
            self.calls += 1
            out = x.new_empty(x.shape[1:])
            dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group)
            return out
        return self.all_reduce(x.clone())[self.rank].clone()

    def broadcast(self, x, src: int = 0):
        """`x` of the axis's rank `src`, in place on every rank."""
        self.calls += 1
        dist.broadcast(x, self.ranks[src], group=self.group)
        return x

    def index(self, kind: str, n: int, device, heads=None):
        """This rank's positions along an axis of n (`split_index`), a
        cached int64 tensor on `device`."""
        key = (kind, n, heads, str(device))
        idx = self._index.get(key)
        if idx is None:
            idx = self._index[key] = torch.as_tensor(
                split_index(kind, n, self.size, self.rank, heads),
                dtype=torch.int64, device=device)
        return idx


@dataclass
class Mesh:
    """This rank's view of a (dp, tp) mesh: its two axes, its device and
    the backend. Collectives under nccl run inside CUDA graphs; under gloo
    the sessions run their bodies eagerly (gloo cannot be captured)."""

    dp: Axis
    tp: Axis
    device: torch.device
    backend: str

    @property
    def graphs(self) -> bool:
        """Whether the collectives can be captured in CUDA graphs."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def barrier(self):
        """Wait until every rank of the mesh got here: a sum over tp, then
        over dp, read on the host (the groups' own communicators; the
        default group's barrier hung on two cards once a session's graphs
        held nccl collectives)."""
        x = torch.zeros(1, device=self.device)
        self.dp.all_reduce(self.tp.all_reduce(x)).item()


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, device=None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's (dp, tp) mesh over the whole process group (defaults:
    every rank on tp, as JAX's). Every rank calls it, in the same order
    as its other group creations. Each group's communicator is set up by
    one all-reduce here, before any CUDA graph could capture its first
    collective. `device`: the caller's, else `default_device`."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None and tp is None:
        dp, tp = 1, world
    elif dp is None:
        dp = world // tp
    elif tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} != {world} ranks")
    backend = dist.get_backend()
    device = torch.device(device) if device is not None else default_device(rank)
    d_i, t_i = divmod(rank, tp)
    axes = {}
    for name, groups in (("tp", [[d * tp + t for t in range(tp)] for d in range(dp)]),
                         ("dp", [[d * tp + t for d in range(dp)] for t in range(tp)])):
        for ranks in groups:  # every rank makes every group, in one order
            group = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                axes[name] = Axis(name, ranks, ranks.index(rank), group, backend)
    mesh = Mesh(dp=axes["dp"], tp=axes["tp"], device=device, backend=backend)
    for axis in (mesh.tp, mesh.dp):
        axis.all_reduce(torch.zeros(1, device=device))
    assert (mesh.dp.rank, mesh.tp.rank) == (d_i, t_i)
    return mesh


_CURRENT = contextvars.ContextVar("fish_speech_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the model on this rank's shard of `mesh` (None: unsharded) in
    the block: `models/dual_ar.py` reads it (`current_mesh`) to size its
    heads and call its collectives. Sessions and trainers enter it around
    their own calls; it is per thread."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT.get()


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Layout:
    """Which parts of the tree a tp split takes apart: the vocabulary (the
    embedding table and the untied output), the slow stack, and the fast
    part (its stack, project_in and output)."""

    vocab: bool
    slow: bool
    fast: bool


def tp_layout(cfg: DualARConfig, tp: int) -> Layout:
    """Each part splits where every width it splits divides by tp."""
    cfg = cfg.resolve()

    def divides(*ns):
        return all(n % tp == 0 for n in ns)

    fast_in = (cfg.fast_dim,) if cfg.fast_dim != cfg.dim else ()
    return Layout(
        vocab=divides(cfg.vocab_size),
        slow=divides(cfg.n_head, cfg.n_local_heads, cfg.intermediate_size),
        fast=divides(cfg.fast_n_head, cfg.fast_n_local_heads,
                     cfg.fast_intermediate_size, cfg.codebook_size, *fast_in))


def split_index(kind: str, n: int, size: int, rank: int, heads=None) -> list:
    """Positions of rank `rank`'s part, in order, along an axis of n split
    `size` ways: "even" a contiguous n/size block; "halves" the rank's
    block of each half ([w1 part | w3 part] of a fused w13); "qkv" its
    block of q heads, of k heads and of v heads of a fused (H + 2 Hkv) *
    Dh axis, heads = (H, Hkv, Dh)."""
    def block(lo, m):
        return list(range(lo + rank * m // size, lo + (rank + 1) * m // size))

    if kind == "even":
        return block(0, n)
    if kind == "halves":
        return block(0, n // 2) + block(n // 2, n // 2)
    if kind == "qkv":  # whole heads: h and hkv divide by size
        h, hkv, d = heads
        assert n == (h + 2 * hkv) * d, (n, heads)
        return (block(0, h * d) + block(h * d, hkv * d)
                + block((h + hkv) * d, hkv * d))
    raise ValueError(kind)


def _stack_heads(cfg: DualARConfig, fast: bool):
    if fast:
        return cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim
    return cfg.n_head, cfg.n_local_heads, cfg.head_dim


def leaf_split(path, cfg: DualARConfig, layout: Layout):
    """How the leaf at `path` (a tuple of keys) splits over tp: None
    (replicated), or (axis, kind, heads) for `split_index`."""
    if any("lora" in k for k in path) or path[0].startswith("_"):
        return None
    fast = path[0] == "fast"
    if path == ("embeddings",):
        return (0, "even", None) if layout.vocab else None
    if path == ("output",):
        return (-1, "even", None) if layout.vocab else None
    if not (layout.fast if fast else layout.slow):
        return None
    name = path[-1]
    if path[-2:-1] == ("layers",):
        heads = _stack_heads(cfg, fast)
        return {"wqkv": (-1, "qkv", heads), "bqkv": (-1, "qkv", heads),
                "wo": (-2, "even", None), "w1": (-1, "even", None),
                "w3": (-1, "even", None), "w13": (-1, "halves", None),
                "w2": (-2, "even", None)}.get(name)
    if fast and path[1:] in (("output",), ("project_in", "w"), ("project_in", "b")):
        return (-1, "even", None)
    return None


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) and not _is_quantized(v):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and ({"q", "s"} <= node.keys()
                                       or {"p", "gs"} <= node.keys())


def has_quantized(tree) -> bool:
    """Whether any weight of the tree is quantized (`ops/quant.py`)."""
    return any(_is_quantized(v) for _, v in _walk(tree))


def _rebuild(tree, fn, path=()):
    return {k: (_rebuild(v, fn, path + (k,))
                if isinstance(v, dict) and not _is_quantized(v)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def shard_leaf(x, path, cfg: DualARConfig, mesh: Mesh):
    """This rank's part of the full leaf `x` at `path` (x itself where it
    is replicated, and on a tp of 1)."""
    split = leaf_split(path, cfg, tp_layout(cfg, mesh.tp.size))
    if split is None or mesh.tp.size == 1:
        return x
    if _is_quantized(x):
        raise NotImplementedError(
            f"quantized weights are not served under tp > 1 ({'/'.join(path)}); "
            f"JAX's server refuses int8 under a mesh too")
    axis, kind, heads = split
    idx = mesh.tp.index(kind, x.shape[axis], x.device, heads)
    return x.index_select(axis, idx).contiguous()


def gather_leaf(x, path, cfg: DualARConfig, mesh: Mesh):
    """The full leaf from every tp rank's part `x` (the inverse of
    `shard_leaf`; a collective over tp for a split leaf)."""
    split = leaf_split(path, cfg, tp_layout(cfg, mesh.tp.size))
    if split is None or mesh.tp.size == 1:
        return x
    axis, kind, heads = split
    axis = axis % x.dim()
    n = x.shape[axis] * mesh.tp.size
    parts = mesh.tp.all_gather(x.detach(), dim=axis).split(x.shape[axis], dim=axis)
    full = x.new_empty((*x.shape[:axis], n, *x.shape[axis + 1:]))
    for r, part in enumerate(parts):
        idx = torch.as_tensor(split_index(kind, n, mesh.tp.size, r, heads),
                              device=x.device)
        full.index_copy_(axis, idx, part)
    return full


def shard_params(params, cfg: DualARConfig, mesh: Mesh):
    """This rank's shard of the full tree `params` (the port's layout; a
    fused w13 is cut per half). Replicated leaves are the same tensors.
    Every rank must hold the same full tree (the same checkpoint, or the
    same seeded init), as JAX's `host_shard` requires."""
    return _rebuild(params, lambda p, x: shard_leaf(x, p, cfg, mesh))


def unshard_params(params, cfg: DualARConfig, mesh: Mesh):
    """The full tree from this rank's shard (every tp rank calls it)."""
    return _rebuild(params, lambda p, x: gather_leaf(x, p, cfg, mesh))


# ---------------------------------------------------------------------------
# The JAX package's specs (PartitionSpecs as tuples of axis names)
# ---------------------------------------------------------------------------


def _layer_specs(qk_norm: bool, qkv_bias: bool, o_bias: bool):
    specs = {
        "attn_norm": (None, None),
        "wqkv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "ffn_norm": (None, None),
        "w1": (None, None, "tp"),
        "w3": (None, None, "tp"),
        "w2": (None, "tp", None),
    }
    if qkv_bias:
        specs["bqkv"] = (None, "tp")
    if o_bias:
        specs["bo"] = (None, None)
    if qk_norm:
        specs["q_norm"] = (None, None)
        specs["k_norm"] = (None, None)
    return specs


def dual_ar_param_specs(cfg: DualARConfig):
    """The JAX package's spec tree over `init_dual_ar`'s structure, each
    spec a tuple of mesh axis names (None: not split). `shard_params`
    splits what it marks "tp" (wqkv and bqkv by heads)."""
    cfg = cfg.resolve()
    specs = {
        "embeddings": ("tp", None),
        "codebook_embeddings": (None, None),
        "layers": _layer_specs(cfg.attention_qk_norm, cfg.attention_qkv_bias,
                               cfg.attention_o_bias),
        "norm": (None,),
        "fast": {
            "embeddings": (None, None),
            "layers": _layer_specs(cfg.fast_attention_qk_norm,
                                   cfg.fast_attention_qkv_bias,
                                   cfg.fast_attention_o_bias),
            "norm": (None,),
            "output": (None, "tp"),
        },
    }
    if not cfg.tie_word_embeddings:
        specs["output"] = (None, "tp")
    if cfg.fast_dim != cfg.dim:
        specs["fast"]["project_in"] = {"w": (None, "tp"), "b": ("tp",)}
    return specs


def kv_cache_specs(quant: bool = False):
    """Slow KV cache (L, B, S, Hkv, Dh): batch over dp, heads over tp; the
    int8 cache's scales (L, B, S, Hkv) like k/v without the head dim."""
    specs = {"k": (None, "dp", None, "tp", None),
             "v": (None, "dp", None, "tp", None)}
    if quant:
        specs["ks"] = (None, "dp", None, "tp")
        specs["vs"] = (None, "dp", None, "tp")
    return specs


def batch_spec(accum: bool = False):
    """Training batch specs: the batch axis over dp (after the microbatch
    axis with `accum`). `Trainer._place_batch` takes this rank's rows."""
    spec = {"inputs": ("dp", None, None), "labels": ("dp", None, None),
            "pad_mask": ("dp", None)}
    if accum:
        spec = {k: (None, *s) for k, s in spec.items()}
    return spec


def zero1_shard_opt_state(tensors, dp: Axis):
    """ZeRO-1's split of the optimizer's tensors over dp: for each, the
    flattened elements [r * s, (r + 1) * s) of dp rank r, s = ceil(n / dp)
    (the last shards padded with zeros). Returns this rank's shards, each a
    new tensor in its tensor's dtype that the optimizer updates and keeps
    m and v for (1/dp of the replicated state), and the shard sizes. `train/step.py` reduce-scatters the gradients into them
    and all-gathers the updated shards back."""
    shards, sizes = [], []
    for t in tensors:
        s = math.ceil(t.numel() / dp.size)
        flat = torch.zeros(s * dp.size, dtype=t.dtype, device=t.device)
        flat[: t.numel()] = t.detach().reshape(-1)
        shards.append(flat[dp.rank * s:(dp.rank + 1) * s].clone())
        sizes.append(s)
    return shards, sizes


def _sorted_leaves(tree, path=()):
    """(path, leaf) in the JAX flatten order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def train_state_memory_plan(cfg: DualARConfig, dp: int = 1, tp: int = 1,
                            zero1: bool = False, param_dtype=None) -> dict:
    """The JAX package's per-chip plan of the persistent training state
    (params, grads, AdamW m and v) on a (dp, tp) mesh, pure arithmetic:
    leaves split as `dual_ar_param_specs`, m/v under ZeRO-1 also over dp
    on their first unsplit axis that dp divides. The shapes come from the
    port's own initialiser on the meta device (nothing is allocated)."""
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar

    cfg = cfg.resolve()
    shapes = dict(_sorted_leaves(init_dual_ar(
        0, cfg, dtype=param_dtype or torch.bfloat16, device="meta")))
    specs = dict(_sorted_leaves(dual_ar_param_specs(cfg)))
    assert shapes.keys() == specs.keys(), (set(shapes) ^ set(specs))
    size = {"dp": dp, "tp": tp}

    def per_chip(leaf, spec, extra_dp=False):
        axes = list(spec) + [None] * (leaf.dim() - len(spec))
        denom = 1
        for ax in axes:
            if ax:
                denom *= size[ax]
        if extra_dp and dp > 1:
            for i, ax in enumerate(axes):
                if ax is None and leaf.shape[i] % dp == 0 and leaf.shape[i] >= dp:
                    denom *= dp
                    break
        return leaf.numel() * leaf.element_size() / denom

    paths = list(shapes)
    params_b = sum(per_chip(shapes[p], specs[p]) for p in paths)
    grads_b = params_b
    opt_b = 2 * sum(per_chip(shapes[p], specs[p], extra_dp=zero1) for p in paths)
    total_params = sum(shapes[p].numel() for p in paths)
    gib = float(2**30)
    return {
        "params_gib": round(params_b / gib, 2),
        "grads_gib": round(grads_b / gib, 2),
        "opt_gib": round(opt_b / gib, 2),
        "total_gib": round((params_b + grads_b + opt_b) / gib, 2),
        "bytes_per_param_per_chip": round(
            (params_b + grads_b + opt_b) / total_params, 2),
        "n_params": int(total_params),
        "mesh": {"dp": dp, "tp": tp, "zero1": zero1},
    }
