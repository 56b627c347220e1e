"""A synthetic upstream codec state dict (the modded-DAC `codec.pth` naming)
written from a native codec tree by the layout table of
`fish_speech_tpu/convert/dac.py`: the inverse of `convert_dac`, with every
convolution's weight split into a weight-norm pair (g, v), the new
`parametrizations.weight.original0/1` naming and the old `weight_g` /
`weight_v` naming in turn, and the GAN trainer's "generator." prefix."""

import numpy as np


class _Writer:
    def __init__(self, rng):
        self.rng = rng
        self.state = {}
        self.n_wn = 0

    def put(self, key, value):
        self.state["generator." + key] = np.ascontiguousarray(value, np.float32)

    def weight_norm(self, key, w):
        """w (d0, ...) as g * v / ||v||: v is w times a random positive
        scale per d0 row, g the row norms of w."""
        w = np.asarray(w, np.float32)
        axes = tuple(range(1, w.ndim))
        scale = self.rng.uniform(0.5, 2.0, size=(w.shape[0],) + (1,) * (w.ndim - 1))
        v = w * scale.astype(np.float32)
        g = np.sqrt((w * w).sum(axis=axes, keepdims=True))
        if self.n_wn % 2:
            self.put(key + ".weight_g", g)
            self.put(key + ".weight_v", v)
        else:
            self.put(key + ".parametrizations.weight.original0", g)
            self.put(key + ".parametrizations.weight.original1", v)
        self.n_wn += 1

    def conv(self, key, p):
        # stored (K, Cin, Cout) / transposed (K, Cout, Cin) -> torch (2, 1, 0)
        self.weight_norm(key, np.transpose(np.asarray(p["w"]), (2, 1, 0)))
        self.put(key + ".bias", p["b"])

    def alpha(self, key, a):
        self.put(key + ".alpha", np.asarray(a).reshape(1, -1, 1))

    def linear(self, key, p, conv1x1=False):
        w = np.asarray(p["w"]).T
        self.put(key + ".weight", w[:, :, None] if conv1x1 else w)
        self.put(key + ".bias", p["b"])

    def residual_unit(self, base, p):
        self.alpha(base + ".block.0", p["alpha1"])
        self.conv(base + ".block.1.conv", p["conv1"])
        self.alpha(base + ".block.2", p["alpha2"])
        self.conv(base + ".block.3.conv", p["conv2"])

    def transformer(self, base, p):
        layers = p["layers"]
        names = (("attn_norm", "attention_norm.weight", False),
                 ("wqkv", "attention.wqkv.weight", True),
                 ("wo", "attention.wo.weight", True),
                 ("attn_scale", "attention_layer_scale.gamma", False),
                 ("ffn_norm", "ffn_norm.weight", False),
                 ("w1", "feed_forward.w1.weight", True),
                 ("w3", "feed_forward.w3.weight", True),
                 ("w2", "feed_forward.w2.weight", True),
                 ("ffn_scale", "ffn_layer_scale.gamma", False))
        for name, key, transpose in names:
            for i, a in enumerate(np.asarray(layers[name])):
                self.put(f"{base}.layers.{i}.{key}", a.T if transpose else a)
        self.put(base + ".norm.weight", p["norm"])
        if "input_proj" in p:
            self.linear(base + ".input_proj", p["input_proj"])
            self.linear(base + ".output_proj", p["output_proj"])

    def convnext(self, base, p):
        self.conv(base + ".dwconv.conv", p["dwconv"])
        self.put(base + ".norm.weight", p["norm_w"])
        self.put(base + ".norm.bias", p["norm_b"])
        self.linear(base + ".pwconv1", p["pw1"])
        self.linear(base + ".pwconv2", p["pw2"])
        self.put(base + ".gamma", p["gamma"])

    def vq_stack(self, base, stack):
        for i, vq in enumerate(stack):
            self.linear(f"{base}.quantizers.{i}.in_proj", vq["in_proj"], conv1x1=True)
            self.linear(f"{base}.quantizers.{i}.out_proj", vq["out_proj"],
                        conv1x1=True)
            self.put(f"{base}.quantizers.{i}.codebook.weight", vq["codebook"])


def upstream_codec_state(params, cfg, seed=0):
    """{upstream key: float32 array} of a native codec tree (numpy leaves)
    of config `cfg`, weight-normed (module docstring)."""
    w = _Writer(np.random.default_rng(seed))
    enc = params["encoder"]
    w.conv("encoder.block.0.conv", enc["conv_in"])
    for bi, block in enumerate(enc["blocks"]):
        base = f"encoder.block.{bi + 1}.block"
        for j, unit in enumerate(block["units"]):
            w.residual_unit(f"{base}.{j}", unit)
        w.alpha(base + ".3", block["alpha"])
        w.conv(base + ".4.conv", block["conv"])
        if "transformer" in block:
            w.transformer(base + ".5", block["transformer"])
    n_enc = len(cfg.encoder_rates)
    w.alpha(f"encoder.block.{n_enc + 1}", enc["alpha_out"])
    w.conv(f"encoder.block.{n_enc + 2}.conv", enc["conv_out"])

    dec = params["decoder"]
    w.conv("decoder.model.0.conv", dec["conv_in"])
    for bi, block in enumerate(dec["blocks"]):
        base = f"decoder.model.{bi + 1}.block"
        w.alpha(base + ".0", block["alpha"])
        w.conv(base + ".1.conv", block["conv"])
        for j, unit in zip((2, 3, 4), block["units"]):
            w.residual_unit(f"{base}.{j}", unit)
    n_dec = len(cfg.decoder_rates)
    w.alpha(f"decoder.model.{n_dec + 1}", dec["alpha_out"])
    w.conv(f"decoder.model.{n_dec + 2}.conv", dec["conv_out"])

    q = params["quantizer"]
    w.vq_stack("quantizer.semantic_quantizer", q["semantic"])
    w.vq_stack("quantizer.quantizer", q["residual"])
    for i, (down, up) in enumerate(zip(q["downsample"], q["upsample"])):
        w.conv(f"quantizer.downsample.{i}.0.conv", down["conv"])
        w.convnext(f"quantizer.downsample.{i}.1", down["convnext"])
        w.conv(f"quantizer.upsample.{i}.0.conv", up["conv"])
        w.convnext(f"quantizer.upsample.{i}.1", up["convnext"])
    if "pre" in q:
        w.transformer("quantizer.pre_module", q["pre"])
    if "post" in q:
        w.transformer("quantizer.post_module", q["post"])
    return w.state
