"""Invariant rule registry: structured findings over op traces (torch twin
of ``repro/analysis/rules.py``).

Each rule is a function ``(LintTarget) -> [Finding]`` registered under a
stable rule id. A :class:`LintTarget` is one traced program (prefill /
admission wave / decode chunk, solo or as rank 0 of an abstract mesh) of
one config at one bit mix, plus the expectations the rules check against.
Findings carry the rule id, severity, the site's provenance (its
enclosing kernel scopes and the ``file:line`` in ``repro_torch`` that
dispatched it), the offending op and its tensor.

Rule catalog (the reference's ids where the rule is the same; the heirs
of its two Pallas rules are named for what they check on the card):

  no-dense-dequant        no float op output at dense dequantized weight
                          scale outside a kernel call
  kernel-dispatch-budget  exact kernel calls a layer body and step
                          (heir of ``pallas-dispatch-budget``)
  kernel-resources        every kernel call's dynamic shared memory, and
                          every instantiation's registers, shared memory
                          and spills, within the H100's budgets (heir of
                          ``vmem-footprint``)
  dtype-discipline        no f64 tensor on the target's device; no packed
                          code widened outside a kernel call
  host-sync               no read of a device value on the host inside
                          the program
  retrace-budget          the live_cap ladder compiles at most
                          ``log2(B) + 1`` decode variants per sampling mode
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.resources import SMEM_BUDGET_BYTES, \
    KernelResources, kernel_smem_bytes, launch_smem_bytes
from repro_torch.analysis.walker import FLOAT_DTYPES, PACKED_DTYPES, \
    OpSite, Trace, iter_ops

__all__ = ["Finding", "LintTarget", "RULES", "rule", "run_rules",
           "expected_dispatch_count", "forbidden_weight_shapes",
           "FLOAT_DTYPES", "PACKED_DTYPES"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, with enough provenance to act on."""

    rule: str
    severity: str          # "error" | "warning"
    target: str            # e.g. "qwen2_moe_a2p7b/4-2/decode_chunk"
    message: str
    provenance: str = ""   # enclosing kernel scopes @ file:line
    primitive: str = ""    # offending op (aten overload / kernel:<name>)
    aval: str = ""         # offending tensor, when one exists

    def to_json(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintTarget:
    """One traced program plus the expectations rules check against."""

    name: str                       # "<config>/<mix>/<phase>"
    cfg: Any                        # ModelConfig
    phase: str                      # prefill | admission | decode_chunk...
    trace: Optional[Trace] = None   # None: accounting-only
    fused: bool = True
    device: str = "meta"            # where the traced tensors lived
    target: str = "sm_90a"          # the GPU the budgets are for
    # no-dense-dequant: float shapes that must never appear. None =
    # derive from cfg (expert-weight scale).
    forbidden_shapes: Optional[frozenset] = None
    # kernel-dispatch-budget: exact expected calls a layer body and step
    # (None = derive), and the layer bodies times steps the trace ran
    expected_dispatches: Optional[int] = None
    layer_steps: int = 1
    # kernel-resources: per-block shared memory budget override (bytes);
    # instantiations' resources (ptxas logs, the card's attributes) and
    # the dynamic sizes the C++ requests, {"<lib>:<label>": bytes}
    smem_budget: Optional[int] = None
    resources: Optional[List[KernelResources]] = None
    requested_smem: Optional[Dict[str, int]] = None
    # dtype-discipline: packed operands at/above this byte size must not
    # widen outside kernels. None = derive from cfg.
    packed_upcast_threshold: Optional[int] = None
    # retrace-budget inputs (accounting, no trace needed)
    slots: Optional[int] = None
    ladder: Optional[Callable[[int, int], int]] = None
    sampling_variants: int = 2
    # set by build_targets when the traced run raised; reported as a
    # "trace-error" finding (the host-sync rule still reads the trace up
    # to the failure: a host read on meta raises)
    trace_error: Optional[str] = None


RuleFn = Callable[[LintTarget], List[Finding]]
RULES: Dict[str, Tuple[str, RuleFn]] = {}


def rule(name: str, severity: str = "error"):
    def deco(fn: RuleFn) -> RuleFn:
        assert name not in RULES, f"duplicate rule {name!r}"
        RULES[name] = (severity, fn)
        fn.rule_name = name
        return fn
    return deco


def run_rules(target: LintTarget,
              only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every (selected) registered rule over one target."""
    findings: List[Finding] = []
    for name, (_, fn) in RULES.items():
        if only is not None and name not in only:
            continue
        findings.extend(fn(target))
    return findings


def _finding(target: LintTarget, rule_name: str, message: str,
             site: Optional[OpSite] = None, aval: Any = None) -> Finding:
    sev = RULES[rule_name][0]
    return Finding(
        rule=rule_name, severity=sev, target=target.name, message=message,
        provenance=site.provenance() if site is not None else "",
        primitive=site.op if site is not None else "",
        aval=str(aval) if aval is not None else "")


# --------------------------------------------------------------- helpers


def forbidden_weight_shapes(cfg) -> frozenset:
    """Float shapes that equal a dense dequantized quantized-weight leaf
    (both matmul orientations) — the tensors the packed store abolished."""
    dm = cfg.d_model
    shapes = set()
    kind = cfg.block_kinds()[0]
    if kind == "attn_moe":
        e, dff = cfg.num_experts, cfg.expert_d_ff
        shapes |= {(e, dm, dff), (e, dff, dm)}
    elif kind == "attn_dense":
        dff = cfg.d_ff
        shapes |= {(dm, dff), (dff, dm)}
    else:  # ssm: in_proj/out_proj
        di = cfg.d_inner
        if cfg.ssm_version == 1:
            in_n = 2 * di
        else:
            in_n = 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads
        shapes |= {(dm, in_n), (in_n, dm), (di, dm), (dm, di)}
    return frozenset(shapes)


def expected_dispatch_count(cfg, *, phase: str, fused: bool = True) -> int:
    """Exact kernel calls a layer body (and decode step) for a quantized
    serving trace — the reference's ``pallas_call`` count a layer-scan
    body, which the port's traces (no scan: every layer and step runs)
    multiply by the layer bodies and steps they ran.

    attn_moe: one grouped kernel per expert matmul — gate/up/down = 3.
    The dual-dispatch oracle path (``fused=False``) launches one kernel
    per precision buffer (6), except under "4/0" where the low buffer is
    never built (3). The batch-shared prefill path (``moe_apply``) runs
    the critical-masked kernel: both precisions inside ONE dispatch per
    matmul — 3 regardless of the bit mix.
    attn_dense: one kernel per FFN matmul (swiglu 3, gelu 2).
    ssm/hybrid: the two quantized projections (in_proj / out_proj).
    """
    kind = cfg.block_kinds()[0]
    if kind == "attn_moe":
        if fused or cfg.dymoe.low_bits == 0:
            return 3
        return 3 if phase == "prefill" else 6
    if kind == "attn_dense":
        return 3 if cfg.mlp_type == "swiglu" else 2
    return 2


def _default_packed_threshold(cfg) -> int:
    """Smallest packed quantized leaf (bytes) for this config: a uint8
    upcast at/above this size outside a kernel is packed codes being
    unpacked outside the kernels."""
    dm = cfg.d_model
    kind = cfg.block_kinds()[0]
    bits = min(b for b in (cfg.dymoe.high_bits,
                           cfg.dymoe.low_bits or cfg.dymoe.high_bits))
    vpb = 8 // bits
    if kind == "attn_moe":
        return cfg.num_experts * cfg.expert_d_ff * dm // vpb
    if kind == "attn_dense":
        return cfg.d_ff * dm // vpb
    return cfg.d_inner * dm // vpb


def _is_op(site: OpSite) -> bool:
    """An aten op outside every kernel call (not a kernel or host-read
    site)."""
    return not site.in_kernel and site.op.startswith("aten.")


# ----------------------------------------------------------------- rules


@rule("no-dense-dequant")
def check_no_dense_dequant(target: LintTarget) -> List[Finding]:
    """No float op output at dense dequantized-weight scale outside a
    kernel call: the packed representation must be carried all the way
    into the kernel (the packed-weights contract). An output counts when
    it was made from packed codes (``OpSite.from_packed``), so an
    activation buffer that has a weight's shape at a small config is not
    one. Views are not materializations: a layer's slice of the float
    master weights (which ``_index_tree`` takes of every leaf) allocates
    nothing, and a view of a dequantized tensor is flagged where that
    tensor was made."""
    if target.trace is None:
        return []
    forbidden = target.forbidden_shapes
    if forbidden is None:
        forbidden = forbidden_weight_shapes(target.cfg)
    out: List[Finding] = []
    for site in iter_ops(target.trace, into_kernels=False):
        if not _is_op(site) or site.is_view or not site.from_packed:
            continue
        for o in site.outputs:
            if o.shape in forbidden and o.dtype in FLOAT_DTYPES:
                out.append(_finding(
                    target, "no-dense-dequant",
                    "dense dequantized weight materialized at "
                    f"{o.shape} {o.dtype}", site, o))
    return out


@rule("kernel-dispatch-budget")
def check_kernel_dispatch_budget(target: LintTarget) -> List[Finding]:
    """Exactly the budgeted kernel calls a layer body and step, times the
    layer bodies and steps the trace ran (``layer_steps``): one per
    expert matmul on the fused path (3), one per (matmul, precision
    buffer) on the dual oracle path (6), one per quantized projection of
    a dense (3 swiglu, 2 gelu) or Mamba layer (2). A hybrid's weight-shared
    attention sites add none: their MLP runs in float, so zamba2_1p2b
    makes 2 a Mamba layer, 76 a decode step (qwen3_0p6b 84, falcon_mamba_7b
    128, ROADMAP contract 1). Only outermost calls count."""
    if target.trace is None:
        return []
    per = target.expected_dispatches
    if per is None:
        per = expected_dispatch_count(
            target.cfg, phase=target.phase, fused=target.fused)
    expected = per * target.layer_steps
    sites = [s for s in iter_ops(target.trace, into_kernels=False)
             if s.kernel is not None]
    if len(sites) == expected:
        return []
    where = sorted({f"{s.kernel} @ {s.where}" for s in sites})
    return [_finding(
        target, "kernel-dispatch-budget",
        f"{len(sites)} kernel calls over {target.layer_steps} layer bodies "
        f"and steps, expected exactly {expected} ({per} a body; sites: "
        f"{where})", sites[0] if sites else None)]


@rule("kernel-resources")
def check_kernel_resources(target: LintTarget) -> List[Finding]:
    """Every kernel call's dynamic shared memory (mirrored from the C++
    at the call's shapes) fits a block's budget on the target GPU; every
    instantiation the target carries resources for (``ptxas -v``, the
    card's ``cudaFuncGetAttributes``) stays within 255 registers, the
    shared memory budget and zero spill bytes; and the sizes the C++
    requests equal the mirror's."""
    budget = target.smem_budget or SMEM_BUDGET_BYTES[target.target]
    out: List[Finding] = []
    if target.trace is not None:
        seen = set()
        for site in iter_ops(target.trace, into_kernels=False):
            if site.kernel is None or not site.inputs:
                continue
            label, smem = launch_smem_bytes(site.kernel, site.inputs,
                                            site.params)
            if smem > budget and label not in seen:
                seen.add(label)
                out.append(_finding(
                    target, "kernel-resources",
                    f"{label} asks {smem} B of dynamic shared memory a "
                    f"block, budget {budget} B", site, site.inputs[0]))
    for res in target.resources or ():
        problems = res.problems(target.target)
        if target.smem_budget is not None and res.smem_bytes > budget:
            problems.append(f"{res.smem_bytes} B of shared memory a block "
                            f"> {budget} B")
        if problems:
            out.append(_finding(target, "kernel-resources",
                                f"{res.name}: " + "; ".join(problems)))
    mirror = kernel_smem_bytes()
    for name, got in (target.requested_smem or {}).items():
        if mirror.get(name) != got:
            out.append(_finding(
                target, "kernel-resources",
                f"{name} requests {got} B of dynamic shared memory, the "
                f"mirror says {mirror.get(name)} B"))
    return out


@rule("dtype-discipline")
def check_dtype_discipline(target: LintTarget) -> List[Finding]:
    """No f64 tensor on the target's device in a serving program (host-side
    f64 — e.g. ``_capacity``'s exact-truncation contract — stays in Python
    floats or on the host of a card's program), and no packed-code widening
    outside a kernel call: weight-scale uint8 buffers may only widen
    inside a kernel (the in-kernel unpack)."""
    if target.trace is None:
        return []
    threshold = target.packed_upcast_threshold
    if threshold is None:
        threshold = _default_packed_threshold(target.cfg)
    out: List[Finding] = []
    for site in iter_ops(target.trace, into_kernels=True):
        for o in site.outputs:
            if o.dtype == torch.float64 and o.device == target.device:
                out.append(_finding(
                    target, "dtype-discipline",
                    f"f64 tensor {o.shape} on {o.device} in the traced "
                    "serving program", site, o))
        if not _is_op(site):
            continue
        for i in site.inputs:
            if i.dtype not in PACKED_DTYPES or i.nbytes < threshold:
                continue
            wide = [o for o in site.outputs
                    if o.dtype not in PACKED_DTYPES
                    and o.dtype.itemsize > 1 and o.numel >= i.numel]
            if wide:
                out.append(_finding(
                    target, "dtype-discipline",
                    f"packed codes ({i.shape} {i.dtype}) widen to "
                    f"{wide[0].dtype} outside a kernel call", site,
                    wide[0]))
                break
    return out


@rule("host-sync")
def check_host_sync(target: LintTarget) -> List[Finding]:
    """No read of a device value on the host inside the serving programs
    (``item()``, ``bool()``, ``tolist()``, ``nonzero()``, a copy to the
    CPU, ...): one inside the decode chunk would serialize every chunk on
    the host and break the one-sync-per-boundary contract, and a CUDA
    graph cannot hold it."""
    if target.trace is None:
        return []
    return [_finding(target, "host-sync",
                     f"host read '{site.op}' inside the {target.phase} "
                     "program", site, site.inputs[0] if site.inputs
                     else None)
            for site in iter_ops(target.trace, into_kernels=True)
            if site.host_read]


@rule("retrace-budget")
def check_retrace_budget(target: LintTarget) -> List[Finding]:
    """The scheduler's static-capacity ladder compiles a bounded trace
    family: over every reachable live-slot count 1..B the ladder must
    emit power-of-two capacities with at most ``floor(log2(B)) + 1``
    distinct values — so a session compiles at most
    ``(log2(B) + 1) x sampling_variants`` decode variants, i.e.
    ``log2(B) + C`` per sampling mode."""
    if target.slots is None or target.ladder is None:
        return []
    b = int(target.slots)
    budget = math.floor(math.log2(b)) + 1 if b > 0 else 1
    caps = sorted({int(target.ladder(n, b)) for n in range(1, b + 1)})
    out: List[Finding] = []
    bad = [c for c in caps if c < 1 or c > b or (c & (c - 1)) != 0]
    if bad:
        out.append(_finding(
            target, "retrace-budget",
            f"live_cap ladder emits non-power-of-two / out-of-range "
            f"capacities {bad} for B={b} — every value is a fresh trace "
            "key"))
    if len(caps) > budget:
        out.append(_finding(
            target, "retrace-budget",
            f"live_cap ladder compiles {len(caps)} variants for B={b} "
            f"(caps={caps}), budget is log2(B)+1 = {budget} per sampling "
            f"mode ({budget * target.sampling_variants} total)"))
    return out
