"""Model + DyMoE policy configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the DyMoE
technique is parameterized by ``DyMoEPolicy`` and applies fully to MoE
architectures (see DESIGN.md §Arch-applicability for the dense/SSM
restriction).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "DyMoEPolicy"]


@dataclasses.dataclass(frozen=True)
class DyMoEPolicy:
    """DyMoE runtime policy (paper §4).

    high_bits/low_bits: the "4/2" or "4/0" precision spectrum; low_bits=0
    means sub-critical experts are skipped outright (paper's 0-bit state).
    retention: λ-controlled average retention ratio r (paper Eq. 4 uses λ as
    the floor of the cosine schedule; ``retention`` here is the target mean
    r across layers, from which λ is solved in closed form since the mean of
    the cosine term is 1/2: mean r = (1 - λ)/2 + λ ⇒ λ = 2·mean_r - 1,
    clamped to [0, 1]).
    """

    enabled: bool = True
    high_bits: int = 4
    low_bits: int = 2  # 0 => skip sub-critical experts ("4/0")
    group_size: int = 64
    retention: float = 0.75
    heavy_hitter_frac: float = 0.2  # top-k token fraction for Eq. (2)
    prefetch_topk: int = 2  # top-t experts prefetched per layer (Eq. 7/8)
    depth_schedule: str = "cosine"  # cosine | equal | linear
    # Pallas tile sizes for the grouped/fused expert quant-matmuls.
    # Edge-sized d_model/d_ff configs override these so tiny dispatches
    # don't zero-pad to oversized tiles (see configs/qwen3_0p6b.py,
    # configs/olmoe_1b_7b.py).
    block_m: int = 128
    block_n: int = 128
    block_k: int = 512

    @property
    def lam(self) -> float:
        return min(1.0, max(0.0, 2.0 * self.retention - 1.0))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (unused for pure SSM)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_emb: str = "rope"  # rope | sinusoidal | none
    sliding_window: Optional[int] = None  # ring-buffer window for decode
    # --- perf levers (§Perf hillclimb; defaults = paper-faithful baseline)
    attn_causal_skip: bool = False   # skip fully-masked key chunks
    attn_compute_dtype: str = "float32"  # qk/pv einsum precision
    act_seq_shard: bool = False      # sequence-shard the residual carry
                                     # (bounds remat-saved activations)
    moe_dispatch_shards: int = 0     # data-local MoE dispatch: split tokens
                                     # into this many shards so capacity
                                     # buffers shard along the data axis
    moe_dispatch_axes: Tuple[str, ...] = ()  # mesh axes of those shards
    scan_layers: bool = True         # lax.scan over the stacked layers; the
                                     # dry-run also compiles an UNROLLED
                                     # shallow copy to recover per-layer
                                     # costs (cost_analysis counts a scan
                                     # body once regardless of trip count)
    # dense FFN
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # SSM (Mamba)
    ssm_version: int = 0  # 0=no ssm, 1=mamba1, 2=mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    ssm_head_dim: int = 64  # mamba2 only
    dt_rank: int = 0  # mamba1 only; 0 -> d_model // 16
    # hybrid (zamba2-style): insert a weight-shared attention block every N
    shared_attn_every: int = 0
    # numerics / misc
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 4096
    # remat policy for train_step: "none" | "block" (checkpoint each block)
    remat: str = "block"
    # DyMoE
    dymoe: DyMoEPolicy = dataclasses.field(default_factory=DyMoEPolicy)
    source: str = ""  # citation for the config

    # ----- derived -----
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def kv_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_version == 2 else 0

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn_dense' | 'attn_moe' | 'ssm'.

        Hybrid models additionally interleave the weight-shared attention
        block — handled inside the stack, not listed here.
        """
        if self.arch_type in ("dense", "vlm", "audio"):
            return ("attn_dense",) * self.num_layers
        if self.arch_type == "moe":
            return ("attn_moe",) * self.num_layers
        if self.arch_type in ("ssm", "hybrid"):
            return ("ssm",) * self.num_layers
        raise ValueError(self.arch_type)

    def validate(self) -> None:
        if self.has_attention:
            assert self.head_dim > 0 and self.num_kv_heads > 0
            assert self.num_heads % self.num_kv_heads == 0
        if self.is_moe:
            assert 0 < self.num_experts_per_tok <= self.num_experts
        if self.ssm_version:
            assert self.d_inner > 0 and self.ssm_state > 0
        if self.ssm_version == 2:
            assert self.d_inner % self.ssm_head_dim == 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            num_layers=min(2, self.num_layers),
            d_model=min(256, self.d_model),
            vocab_size=min(512, self.vocab_size),
            max_seq_len=128,
        )
        if self.has_attention:
            small.update(num_heads=4, num_kv_heads=max(1, min(4, self.num_kv_heads)),
                         head_dim=32)
            if self.num_kv_heads == self.num_heads:
                small["num_kv_heads"] = 4
        if self.d_ff:
            small["d_ff"] = 512
        if self.is_moe:
            small.update(num_experts=4,
                         num_experts_per_tok=min(2, self.num_experts_per_tok),
                         num_shared_experts=min(1, self.num_shared_experts),
                         moe_d_ff=128,
                         # effectively dropless at smoke-test scale so
                         # prefill/decode consistency is exact
                         capacity_factor=4.0)
        if self.ssm_version:
            small.update(d_inner=512, ssm_state=min(16, self.ssm_state),
                         ssm_head_dim=64 if self.ssm_version == 2 else self.ssm_head_dim,
                         dt_rank=16)
        if self.shared_attn_every:
            small["shared_attn_every"] = 2
        if self.sliding_window:
            small["sliding_window"] = 64
        small["dtype"] = "float32"
        small["remat"] = "none"
        small.update(overrides)
        return dataclasses.replace(self, **small)
