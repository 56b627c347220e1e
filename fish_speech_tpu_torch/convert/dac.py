"""Convert a reference modded-DAC codec checkpoint (codec.pth) to native,
the port's copy of `fish_speech_tpu/convert/dac.py`.

Weight-norm is folded (`convert.torch_state.fold_weight_norm`) so native
weights are plain tensors. Layout changes:
  conv:        torch (Cout, Cin, K) -> (K, Cin, Cout)
  transposed:  torch (Cin, Cout, K) -> (K, Cout, Cin)
  linear/1x1:  torch (O, I[, 1])    -> (I, O)
  snake alpha: torch (1, C, 1)      -> (C,)

Module tree (from `modded_dac.py` / `rvq.py` with causal=True):
  encoder.block.0            first conv (.conv under CausalConvNet)
  encoder.block.{1..4}.block 3x ResidualUnit, Snake, strided conv,
                             [WindowLimitedTransformer]
  encoder.block.5/.6         final Snake + conv
  decoder.model.0            first conv
  decoder.model.{1..4}.block Snake, transposed conv, 3x ResidualUnit
  decoder.model.5/.6         final Snake + conv (+ Tanh, no params)
  quantizer.{downsample,upsample}.{i}.{0,1}  conv + ConvNeXt
  quantizer.{semantic_quantizer,quantizer}.quantizers.{i}.{in,out}_proj/codebook
  quantizer.{pre,post}_module  window transformers

The output is the stored (JAX) layout that `codec.safetensors` holds, with
float32 numpy leaves; `utils/checkpoint.load_codec` turns it into the torch
layout the port's codec runs. Only host reshapes, no device work.
"""

from __future__ import annotations

import numpy as np

from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.convert.torch_state import (fold_weight_norm,
                                                       load_torch_state_dict)


def _conv(w, key):
    return {
        "w": np.transpose(np.asarray(w[key + ".weight"], np.float32), (2, 1, 0)),
        "b": np.asarray(w[key + ".bias"], np.float32),
    }


def _tconv(w, key):
    # torch transposed conv weight (Cin, Cout, K) -> (K, Cout, Cin)
    return {
        "w": np.transpose(np.asarray(w[key + ".weight"], np.float32), (2, 1, 0)),
        "b": np.asarray(w[key + ".bias"], np.float32),
    }


def _alpha(w, key):
    return np.asarray(w[key + ".alpha"], np.float32).reshape(-1)


def _linear(w, key):
    weight = np.asarray(w[key + ".weight"], np.float32)
    if weight.ndim == 3:  # 1x1 conv used as linear
        weight = weight[:, :, 0]
    return {
        "w": weight.T,
        "b": np.asarray(w[key + ".bias"], np.float32),
    }


def _residual_unit(w, base):
    return {
        "alpha1": _alpha(w, base + ".block.0"),
        "conv1": _conv(w, base + ".block.1.conv"),
        "alpha2": _alpha(w, base + ".block.2"),
        "conv2": _conv(w, base + ".block.3.conv"),
    }


def _transformer(w, base, n_layer):
    def stack(tmpl, transpose=False):
        arrs = []
        for i in range(n_layer):
            a = np.asarray(w[tmpl.format(i=i)], np.float32)
            arrs.append(a.T if transpose else a)
        return np.stack(arrs)

    params = {
        "layers": {
            "attn_norm": stack(base + ".layers.{i}.attention_norm.weight"),
            "wqkv": stack(base + ".layers.{i}.attention.wqkv.weight", transpose=True),
            "wo": stack(base + ".layers.{i}.attention.wo.weight", transpose=True),
            "attn_scale": stack(base + ".layers.{i}.attention_layer_scale.gamma"),
            "ffn_norm": stack(base + ".layers.{i}.ffn_norm.weight"),
            "w1": stack(base + ".layers.{i}.feed_forward.w1.weight", transpose=True),
            "w3": stack(base + ".layers.{i}.feed_forward.w3.weight", transpose=True),
            "w2": stack(base + ".layers.{i}.feed_forward.w2.weight", transpose=True),
            "ffn_scale": stack(base + ".layers.{i}.ffn_layer_scale.gamma"),
        },
        "norm": np.asarray(w[base + ".norm.weight"], np.float32),
    }
    if base + ".input_proj.weight" in w:
        params["input_proj"] = _linear(w, base + ".input_proj")
        params["output_proj"] = _linear(w, base + ".output_proj")
    return params


def _convnext(w, base):
    return {
        "dwconv": _conv(w, base + ".dwconv.conv"),
        "norm_w": np.asarray(w[base + ".norm.weight"], np.float32),
        "norm_b": np.asarray(w[base + ".norm.bias"], np.float32),
        "pw1": _linear(w, base + ".pwconv1"),
        "pw2": _linear(w, base + ".pwconv2"),
        "gamma": np.asarray(w[base + ".gamma"], np.float32),
    }


def _vq_stack(w, base, n):
    return [
        {
            "in_proj": _linear(w, f"{base}.quantizers.{i}.in_proj"),
            "out_proj": _linear(w, f"{base}.quantizers.{i}.out_proj"),
            "codebook": np.asarray(
                w[f"{base}.quantizers.{i}.codebook.weight"], np.float32
            ),
        }
        for i in range(n)
    ]


def convert_dac(weights_or_path, cfg: DACConfig):
    """Torch codec state dict (or codec.pth path) -> native param pytree."""
    if not isinstance(weights_or_path, dict):
        weights = load_torch_state_dict(weights_or_path)
    else:
        weights = dict(weights_or_path)
    # strip the GAN trainer's "generator." prefix if present
    if any(k.startswith("generator.") for k in weights):
        weights = {
            k[len("generator."):]: v
            for k, v in weights.items()
            if k.startswith("generator.")
        }
    w = fold_weight_norm(weights)

    # -- encoder --
    encoder = {"conv_in": _conv(w, "encoder.block.0.conv"), "blocks": []}
    for bi, n_t in enumerate(cfg.encoder_transformer_layers):
        base = f"encoder.block.{bi + 1}.block"
        block = {
            "units": [_residual_unit(w, f"{base}.{j}") for j in range(3)],
            "alpha": _alpha(w, base + ".3"),
            "conv": _conv(w, base + ".4.conv"),
        }
        if n_t > 0:
            block["transformer"] = _transformer(w, base + ".5", n_t)
        encoder["blocks"].append(block)
    n_enc = len(cfg.encoder_rates)
    encoder["alpha_out"] = _alpha(w, f"encoder.block.{n_enc + 1}")
    encoder["conv_out"] = _conv(w, f"encoder.block.{n_enc + 2}.conv")

    # -- decoder --
    decoder = {"conv_in": _conv(w, "decoder.model.0.conv"), "blocks": []}
    for bi in range(len(cfg.decoder_rates)):
        base = f"decoder.model.{bi + 1}.block"
        decoder["blocks"].append(
            {
                "alpha": _alpha(w, base + ".0"),
                "conv": _tconv(w, base + ".1.conv"),
                "units": [_residual_unit(w, f"{base}.{j}") for j in (2, 3, 4)],
            }
        )
    n_dec = len(cfg.decoder_rates)
    decoder["alpha_out"] = _alpha(w, f"decoder.model.{n_dec + 1}")
    decoder["conv_out"] = _conv(w, f"decoder.model.{n_dec + 2}.conv")

    # -- quantizer --
    rvq = cfg.rvq
    quantizer = {
        "semantic": _vq_stack(w, "quantizer.semantic_quantizer", 1),
        "residual": _vq_stack(w, "quantizer.quantizer", rvq.n_codebooks),
        "downsample": [
            {
                "conv": _conv(w, f"quantizer.downsample.{i}.0.conv"),
                "convnext": _convnext(w, f"quantizer.downsample.{i}.1"),
            }
            for i in range(len(rvq.downsample_factor))
        ],
        "upsample": [
            {
                "conv": _tconv(w, f"quantizer.upsample.{i}.0.conv"),
                "convnext": _convnext(w, f"quantizer.upsample.{i}.1"),
            }
            for i in range(len(rvq.downsample_factor))
        ],
    }
    if rvq.pre_transformer is not None:
        quantizer["pre"] = _transformer(
            w, "quantizer.pre_module", rvq.pre_transformer.n_layer
        )
    if rvq.post_transformer is not None:
        quantizer["post"] = _transformer(
            w, "quantizer.post_module", rvq.post_transformer.n_layer
        )

    return {"encoder": encoder, "quantizer": quantizer, "decoder": decoder}
