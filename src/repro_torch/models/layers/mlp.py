"""Dense FFN blocks: SwiGLU (Llama/Qwen/Phi family) and GELU (MusicGen)
(torch twin of ``repro/models/layers/mlp.py``).

On non-MoE architectures the dense FFN takes part in DyMoE's depth-aware
precision schedule: ``mlp_quantized`` runs the FFN straight from the
packed codes of the precision a per-layer criticality flag selects, each
matmul one K2 launch through ``quant/mixed.py``'s 1-expert lift.

Under a mesh (``sharding/spmd.py``) the float FFN is a Megatron pair (its
input products stay local, one SUM ends ``w_down``) and the quantized one
runs each K2 on its local N rows and gathers the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.quant.mixed import mixed_precision_matmul
from repro_torch.quant.qtensor import MixedPrecisionWeights
from repro_torch.sharding import spmd

__all__ = ["init_mlp", "mlp", "quantize_mlp", "mlp_quantized"]


def init_mlp(cfg: ModelConfig, draw, lead=()) -> dict:
    """FFN weights with the JAX package's layout and init scales;
    ``draw.normal(shape, scale)`` gives N(0, scale²) draws in the model's
    dtype, ``lead`` the stacked leading dims."""
    dm, dff = cfg.d_model, cfg.d_ff
    p = {"w_up": draw.normal(lead + (dm, dff), dm ** -0.5),
         "w_down": draw.normal(lead + (dff, dm), dff ** -0.5)}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = draw.normal(lead + (dm, dff), dm ** -0.5)
    return p


def _act(cfg: ModelConfig, mm, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return F.silu(mm("w_gate", x)) * mm("w_up", x)
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(mm("w_up", x), approximate="tanh")


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = _act(cfg, lambda name, h: h @ spmd.local(p[name]), x)
    h = spmd.to_down(h, p["w_up"], p["w_down"])
    return spmd.from_down(h @ spmd.local(p["w_down"]), p["w_down"])


def quantize_mlp(p, cfg: ModelConfig) -> dict:
    """Mixed-precision variants of every FFN matrix."""
    pol = cfg.dymoe
    low = pol.low_bits or None
    return {name: MixedPrecisionWeights.build(w, pol.high_bits, low,
                                              pol.group_size)
            for name, w in p.items()}


def mlp_quantized(qp, cfg: ModelConfig, x: torch.Tensor,
                  critical: bool) -> torch.Tensor:
    """FFN from quantized weights; ``critical`` is the layer's host-side
    tier flag. High precision when critical, low otherwise — or, under
    "x/0", zeros, so the residual passes the layer through."""

    def mm(name, h):
        return mixed_precision_matmul(h, spmd.local_mp(qp[name]), critical,
                                      skip_to_zero=True, out_dtype=x.dtype)

    h = spmd.to_down(_act(cfg, mm, x), qp["w_up"], qp["w_down"])
    return spmd.from_down(mm("w_down", h), qp["w_down"])
