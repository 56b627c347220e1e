"""Matmul helper of the model code (`fish_speech_tpu/ops/quant.py:mm`).

Only plain weights are ported so far. The JAX package's int8 ({"q", "s"})
and int4 ({"p", "gs"}) weight dicts are the ROADMAP item "int8 weights and
the int8 KV cache" (and, for int4, the unported Pallas kernel
`ops/pallas_int4.py`).
"""

import torch


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain (..., I, O) weight."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized weights are not ported yet (ROADMAP: int8 weights and "
            "the int8 KV cache; int4 needs ops/pallas_int4.py ported)"
        )
    return x @ w
