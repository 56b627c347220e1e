"""Weight bridge from the JAX package's parameter pytrees to the port.

Input is the pytree with every leaf as a numpy array (`np.asarray` of each
JAX leaf, or what `fish_speech_tpu/convert/` emits from a checkpoint);
output is the same nested dict of torch tensors on a given device and
dtype, in the port's layouts:

  * the dual-AR LM keeps the JAX layout: stacked (L, in, out) weights;
  * codec conv weights (K, Cin, Cout) become torch's (Cout, Cin, K);
    conv-transpose weights (K, Cout, Cin) become torch's (Cin, Cout, K)
    (`fish_speech_tpu/models/dac/conv.py`: the JAX layout is the torch one
    rolled to spatial-major); depthwise convs follow the conv rule, with
    Cin = 1 and `groups` = channels.

Also here: torch counterparts of the JAX package's random initialisers for
the parts of the slice (`init_dual_ar` is in `models/dual_ar.py`;
`init_dac_decoder` below), so a full-size model can be built directly on
the card without a second copy on the host.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from fish_speech_tpu_torch.config import DACConfig


def config_from_jax(obj, cls):
    """The port's config `cls` built from any dataclass with the same field
    names (a config of the JAX package, say), by its fields: nested configs
    are rebuilt as the port's classes. Never imports the JAX package."""
    return _config(cls, dataclasses.asdict(obj))


def _config(cls, data):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init or f.name not in data:
            continue
        value = data[f.name]
        sub = _nested_dataclass(hints[f.name])
        if sub is not None and isinstance(value, dict):
            value = _config(sub, value)
        kwargs[f.name] = value
    return cls(**kwargs)


def _nested_dataclass(tp):
    """The dataclass in a field's type (`X` or `Optional[X]`), if any."""
    if dataclasses.is_dataclass(tp):
        return tp
    return next((a for a in typing.get_args(tp) if dataclasses.is_dataclass(a)),
                None)


def _tensor(a, dtype, device):
    """One leaf as a tensor: integer leaves (int8 `q`, uint8 `p`) stay
    integer, floating leaves are cast to `dtype` (None: the leaf's own)."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"  # ml_dtypes bf16: torch cannot view it
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
    if t.is_floating_point():
        t = t.to(dtype or (torch.bfloat16 if bf16 else t.dtype))
    return t.to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def dual_ar_from_jax(params, dtype=torch.bfloat16, device=None):
    """Dual-AR LM pytree (numpy leaves) -> torch tensors, layout unchanged,
    LoRA leaves included (`models/lora.py` layout). Quantized weights cross
    leaf for leaf: int8 {"q","s"} and int4 {"p","gs"} keep their integer
    `q`/`p` and their scales' dtype. The audio projector is not ported."""
    def convert(node, path=""):
        if isinstance(node, dict):
            quant = {"q", "s"} <= node.keys() or {"p", "gs"} <= node.keys()
            out = {}
            for k, v in node.items():
                if k == "audio_projector":
                    raise NotImplementedError(f"{path}/{k} is not ported")
                if quant and k in ("s", "gs"):  # scales keep their dtype
                    out[k] = _tensor(v, None, device)
                else:
                    out[k] = convert(v, f"{path}/{k}")
            return out
        if isinstance(node, (list, tuple)):
            return [convert(v, path) for v in node]
        return _tensor(node, dtype, device)

    return convert(params)


def _conv(p, dtype, device):
    """JAX conv {"w": (K, Cin, Cout), "b"} -> torch {"w": (Cout, Cin, K)};
    also right for conv-transpose (K, Cout, Cin) -> (Cin, Cout, K)."""
    return {"w": _tensor(np.transpose(np.asarray(p["w"]), (2, 1, 0)), dtype, device),
            "b": _tensor(p["b"], dtype, device)}


def dac_decoder_from_jax(params, dtype=torch.float32, device=None):
    """Codec pytree (numpy leaves) -> the decode half in torch layout:
    {"quantizer": {semantic, residual, upsample, post}, "decoder": ...}.
    The encoder, the downsample stages and the pre-quantizer transformer
    serve `dac_encode`, which is not ported."""
    def plain(x):
        return _tree(x, lambda a: _tensor(a, dtype, device))

    def vq(p):
        return {"codebook": plain(p["codebook"]), "out_proj": plain(p["out_proj"])}

    q = params["quantizer"]
    quantizer = {
        "semantic": [vq(p) for p in q["semantic"]],
        "residual": [vq(p) for p in q["residual"]],
        "upsample": [
            {
                "conv": _conv(st["conv"], dtype, device),
                "convnext": {
                    **plain({k: v for k, v in st["convnext"].items()
                             if k != "dwconv"}),
                    "dwconv": _conv(st["convnext"]["dwconv"], dtype, device),
                },
            }
            for st in q["upsample"]
        ],
    }
    if "post" in q:
        quantizer["post"] = plain(q["post"])

    d = params["decoder"]
    decoder = {
        "conv_in": _conv(d["conv_in"], dtype, device),
        "blocks": [
            {
                "alpha": plain(blk["alpha"]),
                "conv": _conv(blk["conv"], dtype, device),
                "units": [
                    {"alpha1": plain(u["alpha1"]),
                     "conv1": _conv(u["conv1"], dtype, device),
                     "alpha2": plain(u["alpha2"]),
                     "conv2": _conv(u["conv2"], dtype, device)}
                    for u in blk["units"]
                ],
            }
            for blk in d["blocks"]
        ],
        "alpha_out": plain(d["alpha_out"]),
        "conv_out": _conv(d["conv_out"], dtype, device),
    }
    return {"quantizer": quantizer, "decoder": decoder}


# ---------------------------------------------------------------------------
# Random initialisation of the codec's decode half, in torch layout
# ---------------------------------------------------------------------------


def init_dac_decoder(seed: int, cfg: DACConfig, dtype=torch.float32,
                     device=None):
    """Random weights for `dac_from_indices` with `init_dac`'s shapes and
    scales (truncated-normal convs and transformer weights at std 0.02,
    normal codebooks, unit snake alphas), drawn on `device` from a
    torch.Generator seeded with `seed`."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def trunc(shape, std=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * std).to(dtype)

    def normal(shape, std=1.0):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, std, generator=gen).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def conv(c_out, c_in, k):  # torch conv layout
        return {"w": trunc((c_out, c_in, k)), "b": full((c_out,), 0.0)}

    def conv_t(c_in, c_out, k):  # torch conv-transpose layout
        return {"w": trunc((c_in, c_out, k)), "b": full((c_out,), 0.0)}

    rvq = cfg.rvq
    d = rvq.input_dim

    def vq(size):
        return {"codebook": normal((size, rvq.codebook_dim)),
                "out_proj": {"w": normal((rvq.codebook_dim, d), 0.02),
                             "b": full((d,), 0.0)}}

    def convnext(dim):
        return {
            "dwconv": conv(dim, 1, 7),
            "norm_w": full((dim,), 1.0),
            "norm_b": full((dim,), 0.0),
            "pw1": {"w": normal((dim, 4 * dim), 0.02), "b": full((4 * dim,), 0.0)},
            "pw2": {"w": normal((4 * dim, dim), 0.02), "b": full((dim,), 0.0)},
            "gamma": full((dim,), 1e-6),
        }

    quantizer = {
        "semantic": [vq(rvq.semantic_codebook_size)],
        "residual": [vq(rvq.codebook_size) for _ in range(rvq.n_codebooks)],
        "upsample": [{"conv": conv_t(d, d, f), "convnext": convnext(d)}
                     for f in reversed(rvq.downsample_factor)],
    }
    if rvq.post_transformer is not None:
        quantizer["post"] = _init_codec_transformer(
            rvq.post_transformer, d, trunc, full)

    channels = cfg.decoder_dim
    blocks = []
    for i, stride in enumerate(cfg.decoder_rates):
        d_in, d_out = channels // 2**i, channels // 2 ** (i + 1)
        blocks.append({
            "alpha": full((d_in,), 1.0),
            "conv": conv_t(d_in, d_out, 2 * stride),
            "units": [{"alpha1": full((d_out,), 1.0),
                       "conv1": conv(d_out, d_out, 7),
                       "alpha2": full((d_out,), 1.0),
                       "conv2": conv(d_out, d_out, 1)} for _ in range(3)],
        })
    decoder = {
        "conv_in": conv(channels, cfg.resolved_latent_dim, 7),
        "blocks": blocks,
        "alpha_out": full((d_out,), 1.0),
        "conv_out": conv(1, d_out, 7),
    }
    return {"quantizer": quantizer, "decoder": decoder}


def _init_codec_transformer(tcfg, input_dim, trunc, full):
    tcfg = tcfg.resolve()
    n = tcfg.n_layer
    total_qkv = (tcfg.n_head + 2 * tcfg.n_local_heads) * tcfg.head_dim
    params = {
        "layers": {
            "attn_norm": full((n, tcfg.dim), 1.0),
            "wqkv": trunc((n, tcfg.dim, total_qkv)),
            "wo": trunc((n, tcfg.n_head * tcfg.head_dim, tcfg.dim)),
            "attn_scale": full((n, tcfg.dim), 1e-2),
            "ffn_norm": full((n, tcfg.dim), 1.0),
            "w1": trunc((n, tcfg.dim, tcfg.intermediate_size)),
            "w3": trunc((n, tcfg.dim, tcfg.intermediate_size)),
            "w2": trunc((n, tcfg.intermediate_size, tcfg.dim)),
            "ffn_scale": full((n, tcfg.dim), 1e-2),
        },
        "norm": full((tcfg.dim,), 1.0),
    }
    if input_dim != tcfg.dim:
        params["input_proj"] = {"w": trunc((input_dim, tcfg.dim)),
                                "b": full((tcfg.dim,), 0.0)}
        params["output_proj"] = {"w": trunc((tcfg.dim, input_dim)),
                                 "b": full((input_dim,), 0.0)}
    return params
