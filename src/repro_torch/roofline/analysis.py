"""Three-term roofline of one step on the H100 (torch twin of
``repro/roofline/analysis.py``).

  compute term    = FLOPs / peak FLOP/s
  memory term     = bytes accessed / HBM bandwidth
  collective term = collective payload bytes / link bandwidth

all per device. The port has no compiler cost analysis: the dry run
(``repro_torch.launch.dryrun``) counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over one traced step and
bytes from its op trace, and collective bytes come from the payload
counters of a ``repro_torch.launch.mesh.Mesh``
(:func:`collective_bytes_from_mesh`). :func:`collective_bytes_from_hlo`
is kept as the JAX package has it (pure text parsing of post-SPMD HLO):
same keys, so either source feeds :func:`roofline_terms`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

__all__ = ["HW", "collective_bytes_from_hlo", "collective_bytes_from_mesh",
           "roofline_terms", "model_flops_estimate"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM5 80 GB constants (per card), from NVIDIA's
    datasheet: dense bf16 tensor-core peak (no sparsity), HBM3 bandwidth,
    and NVLink 4 per direction (900 GB/s both ways). The card the port is
    measured on reports itself as "NVIDIA H100 80GB HBM3" at a 700 W
    power limit, which is that part; a card capped below 700 W runs below
    these peaks under load."""

    peak_flops: float = 989e12   # bf16 dense tensor cores, FLOP/s
    hbm_bw: float = 3.35e12      # B/s
    ici_bw: float = 450e9        # B/s, NVLink 4, one direction


# Byte widths for parsing HLO text on the HOST — the f64/s64 entries
# describe dtypes an HLO dump may mention, they put no f64 into any
# traced program (the dtype-discipline rule of repro_torch.analysis
# checks that none of the serving traces carry f64 tensors).
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(pred|[sufc]\d+|bf16)\[([\d,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every shape literal in ``text``."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, int]:
    """Per-collective-kind byte totals from post-SPMD HLO text.

    Counts each op once: max(output bytes, operand bytes) as the moved
    volume proxy.
    """
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"(?:ROOT )?%?[\w.\-]+ = (.*)$", line)
        if not m:
            continue
        rhs = m.group(1)
        for kind in _COLLECTIVES:
            # match the op name token, e.g. " all-gather(" or "all-reduce-start("
            if re.search(rf"\b{kind}(-start)?\(", rhs):
                paren = rhs.index("(")
                out_bytes = _shape_bytes(rhs[:paren])
                in_bytes = _shape_bytes(rhs[paren:])
                out[kind] += max(out_bytes, in_bytes)
                break
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def collective_bytes_from_mesh(mesh) -> Dict[str, int]:
    """The :func:`collective_bytes_from_hlo` dict from a
    ``repro_torch.launch.mesh.Mesh``'s payload counters (what its
    collectives moved, or on meta tensors would move): every HLO kind,
    with "broadcast" beside them (the port's third collective) and the
    total over all."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    out.update({k: int(v) for k, v in mesh.collective_bytes.items()
                if k != "total"})
    out["total"] = sum(out.values())
    return out


def roofline_terms(cost: Optional[dict], collective_bytes: int,
                   hw: HW = HW()) -> Dict[str, float]:
    """Seconds per term, per step, from per-device cost analysis."""
    cost = cost or {}
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_collective = collective_bytes / hw.ici_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)),
        key=lambda kv: kv[1])[0]
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "collective_bytes": float(collective_bytes),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


def model_flops_estimate(cfg, *, tokens: int, phase: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for the step;
    decode counts one token per sequence. ``tokens`` = global token count
    processed by the step. Training multiplies by 3 (fwd+bwd)."""
    dm, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    n_layer = 0.0
    if cfg.has_attention:
        h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n_layer += dm * (h + 2 * hk) * d + h * d * dm
    if cfg.is_moe:
        per_expert = 3 * dm * cfg.expert_d_ff
        n_layer += (cfg.num_experts_per_tok + cfg.num_shared_experts) \
            * per_expert
    elif cfg.d_ff:
        mult = 3 if cfg.mlp_type == "swiglu" else 2
        n_layer += mult * dm * cfg.d_ff
    if cfg.ssm_version:
        di = cfg.d_inner
        n_layer += 3 * dm * di + di * cfg.ssm_state
    if cfg.shared_attn_every:
        n_sites = len(range(0, L, cfg.shared_attn_every))
        h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shared = dm * (h + 2 * hk) * d + h * d * dm + 3 * dm * cfg.d_ff
        n_layer += shared * n_sites / L
    n_active = n_layer * L + dm * V  # + unembed
    total = 2.0 * n_active * tokens          # fwd: 2·N·D
    if phase == "train":
        total *= 3.0                          # +bwd ≈ 2× fwd
    return total
