"""Edge-device cost model for the orchestrated serving path (a copy of
``repro/serving/cost_model.py``, numpy only).

The paper's edge hardware (RTX3090-class GPU behind PCIe Gen3 x16,
12–24 GB VRAM budgets) is modeled explicitly, whatever card runs the
model: compute windows come from FLOP/byte counts of each layer,
transfers from the DMA queue in :mod:`repro_torch.core.orchestrator`. Ratios (expert bytes per precision,
compute-vs-transfer overlap) are exact; absolute constants are the paper's
hardware class and are configurable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["EdgeProfile", "EdgeCostModel", "expert_bytes"]


@dataclasses.dataclass(frozen=True)
class EdgeProfile:
    name: str = "rtx3090"
    vram_bytes: int = 24 << 30
    pcie_bw: float = 16e9        # Gen3 x16 effective
    flops: float = 71e12         # fp16/bf16 dense
    mem_bw: float = 936e9        # GDDR6X
    mfu: float = 0.45            # achievable fraction of peak compute
    mbu: float = 0.70            # achievable fraction of peak bandwidth

    def with_vram(self, gb: int) -> "EdgeProfile":
        return dataclasses.replace(self, vram_bytes=gb << 30)


def expert_bytes(cfg: ModelConfig, bits: int) -> int:
    """Per-expert blob size (3 SwiGLU matrices) at a bit-width, including
    group scales. Since the grouped ``expert_quant_matmul`` kernel feeds the
    matrix units straight from the packed codes, this is also exactly what one
    expert's matmuls move over the memory system — not a 2x-bf16
    dequantized copy."""
    dm, dff, gs = cfg.d_model, cfg.expert_d_ff, cfg.dymoe.group_size
    weights = 3 * dm * dff * bits // 8
    scales = (2 * (dm // gs) * dff + (dff // gs) * dm) * 4
    return weights + scales


class EdgeCostModel:
    def __init__(self, cfg: ModelConfig, profile: EdgeProfile):
        self.cfg = cfg
        self.profile = profile

    # ---------------------------------------------------------- helpers
    def _attn_flops(self, s_ctx: int, s_q: int) -> float:
        cfg = self.cfg
        if not cfg.has_attention:
            return 0.0
        dm, h, hk, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        proj = 2 * s_q * dm * (h + 2 * hk) * d + 2 * s_q * h * d * dm
        attn = 4 * s_q * s_ctx * h * d  # qk + pv
        return proj + attn

    def _expert_flops_per_token(self) -> float:
        return 6 * self.cfg.d_model * self.cfg.expert_d_ff

    def _dense_ffn_flops(self, s_q: int) -> float:
        mult = 3 if self.cfg.mlp_type == "swiglu" else 2
        return 2 * mult * s_q * self.cfg.d_model * self.cfg.d_ff

    # ------------------------------------------------------------- API
    def moe_weight_bytes(self, n_hi, n_lo, include_shared: bool = True):
        """Packed weight bytes one MoE layer's grouped quant-matmul actually
        reads for ``n_hi`` Critical + ``n_lo`` Sub-critical active experts
        (skipped experts in a "x/0" deployment move zero bytes — pass them
        in neither count). ``n_hi`` / ``n_lo`` may be numpy arrays (e.g.
        per-layer or (steps, layers) counts); the result broadcasts, so a
        whole telemetry block is priced in one call."""
        cfg = self.cfg
        hb = expert_bytes(cfg, cfg.dymoe.high_bits)
        lb = expert_bytes(cfg, cfg.dymoe.low_bits) if cfg.dymoe.low_bits \
            else 0
        b = n_hi * hb + n_lo * lb
        if include_shared:
            b += cfg.num_shared_experts * expert_bytes(cfg, 16)
        return b

    def dual_dispatch_weight_bytes(self, include_shared: bool = True):
        """Weight traffic of the PRE-FUSED dual-dispatch path per MoE
        layer: two separate grouped kernel launches (one per precision
        buffer), each streaming its ENTIRE packed expert blob — all E
        experts at high bits plus, when ``low_bits`` is on, all E again
        at low bits — regardless of which experts hold live rows. The
        fused single-dispatch kernel's ragged grid reads only blocks
        with live rows, priced by :meth:`moe_weight_bytes`; the ratio of
        the two is the modeled traffic win reported by the kernel
        benchmark's fused-vs-dual rows."""
        cfg = self.cfg
        e = cfg.num_experts
        b = e * expert_bytes(cfg, cfg.dymoe.high_bits)
        if cfg.dymoe.low_bits:
            b += e * expert_bytes(cfg, cfg.dymoe.low_bits)
        if include_shared:
            b += cfg.num_shared_experts * expert_bytes(cfg, 16)
        return b

    def layer_compute_s(self, *, phase: str, s_ctx, s_q,
                        active_experts_hi=0,
                        active_experts_lo=0,
                        tokens_routed=0):
        """Modeled compute window for one transformer layer.

        decode (s_q small) is bandwidth-bound: time = resident bytes read /
        mem_bw; prefill is compute-bound: time = FLOPs / flops. We take the
        max of both terms (roofline).

        Every numeric argument broadcasts: pass scalars for one layer, or
        numpy arrays — e.g. ``s_ctx`` of shape (T, 1) with expert counts of
        shape (T, L) — to price a whole chunk of decode telemetry in one
        vectorized call. Scalar in, scalar out; the arithmetic is identical
        either way, so the vectorized path is bit-equal to the loop it
        replaces.
        """
        cfg, p = self.cfg, self.profile
        # out-of-place accumulation: the terms have different broadcast
        # shapes (e.g. s_ctx (T, 1) vs expert counts (T, L))
        flops = self._attn_flops(s_ctx, s_q)
        rbytes = 0.0
        if cfg.has_attention:
            # KV cache read + attention weights
            rbytes = rbytes + 2 * cfg.num_kv_heads * cfg.head_dim * s_ctx * 2
            rbytes = rbytes \
                + (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
                * cfg.d_model * 2 + cfg.num_heads * cfg.head_dim \
                * cfg.d_model * 2
        if cfg.is_moe:
            per_tok = self._expert_flops_per_token()
            k = cfg.num_experts_per_tok
            flops = flops + tokens_routed * k * per_tok
            if cfg.num_shared_experts:
                flops = flops + s_q * cfg.num_shared_experts * per_tok
            rbytes = rbytes + self.moe_weight_bytes(active_experts_hi,
                                                    active_experts_lo)
        elif cfg.d_ff:
            flops = flops + self._dense_ffn_flops(s_q)
            mult = 3 if cfg.mlp_type == "swiglu" else 2
            rbytes = rbytes + mult * cfg.d_model * cfg.d_ff * 2
        if cfg.ssm_version:
            di, n = cfg.d_inner, cfg.ssm_state
            flops = flops + 2 * s_q * cfg.d_model * 3 * di \
                + 6 * s_q * di * n
            rbytes = rbytes + (3 * cfg.d_model * di + di * n) * 2
        t_compute = flops / (p.flops * p.mfu)
        t_mem = rbytes / (p.mem_bw * p.mbu)
        return np.maximum(t_compute, t_mem)

    def nonexpert_overlap_window_s(self, *, s_ctx: int, s_q: int) -> float:
        """Compute time of the non-MoE part of a layer — the window the
        paper overlaps transfers with (§6.2: 'I/O is often fully masked by
        the computation of non-MoE layers')."""
        p = self.profile
        return self._attn_flops(s_ctx, s_q) / (p.flops * p.mfu)
