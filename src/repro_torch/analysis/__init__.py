"""Op-trace invariant linter: proof from one traced run that the hot path
stays fused, packed, host-sync free and retrace-bounded (torch twin of
``repro.analysis``).

The repo's core performance claims are STRUCTURAL properties of the
serving programs, not benchmark numbers — and every new code path can
silently regress them. This package runs prefill, the batched admission
wave and the scheduler's decode chunk of every shipped config once under
a dispatch-mode trace (:mod:`repro_torch.analysis.walker`) — on PyTorch's
``meta`` device by default: full-size weights, zero bytes allocated, no
card needed — and checks the traces against a rule registry. Run it as::

    PYTHONPATH=src python -m repro_torch.analysis            # all configs
    PYTHONPATH=src python -m repro_torch.analysis --smoke    # 3 edge configs
    PYTHONPATH=src python -m repro_torch.analysis --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.analysis --json report.json

Exit status is non-zero on any error-severity finding. On the card,
``chip_smoke.py``'s ``lint:`` phase traces the full-width OLMoE serve
path through the CUDA kernels and runs every rule on it.

The invariant contract
======================

1. **Packed buffers only.** A quantized weight exists in exactly two
   forms: the packed uint8 codes + f32 group scales at rest, and the
   codes widened inside a kernel (in registers on the card). A dense
   float tensor at full dequantized-weight scale — (E, d_model, d_ff) for
   experts — must never appear as an op output outside a kernel call.
2. **Fused dispatch budget.** The fused dual-buffer MoE calls exactly 3
   kernels a layer (one per expert matmul; both precision regions inside
   each) and decode step. The dual-buffer oracle path is 6 (3 under
   "4/0"); dense FFN is 3 (swiglu) or 2 (gelu); SSM projections are 2.
3. **Kernel resources.** Every kernel call's dynamic shared memory fits
   a block's budget on the H100 (227 KiB), every instantiation stays
   within 255 registers and spills nothing — from the mirror of the
   C++ sizes at each call's shapes, ``ptxas -v`` and, on the card,
   ``cudaFuncGetAttributes``.
4. **Dtype discipline.** Serving programs carry no f64 tensor on their
   device (host-side f64 — e.g. ``_capacity``'s exact-truncation
   contract — stays in Python floats), and packed codes never widen
   outside a kernel call.
5. **No host syncs.** No op inside prefill, the admission wave or the
   decode chunk reads a device value on the host: the chunk boundary's
   one fetch is the scheduler's, outside the program.
6. **Bounded retraces.** The scheduler's power-of-two ``live_cap``
   ladder (:func:`repro_torch.serving.scheduler.live_cap_for`) gives at
   most ``log2(B) + 1`` decode variants per sampling mode.

Rule catalog
============

========================  ========  =====================================
rule id                   severity  checks
========================  ========  =====================================
no-dense-dequant          error     contract 1 — float op outputs at
                                    dense dequantized-weight shapes
kernel-dispatch-budget    error     contract 2 — exact kernel calls a
                                    layer body and step
kernel-resources          error     contract 3 — shared memory, registers
                                    and spills against the H100's budgets
dtype-discipline          error     contract 4 — f64 tensors; packed-code
                                    widening outside kernel calls
host-sync                 error     contract 5 — host reads of device
                                    values inside the programs
retrace-budget            error     contract 6 — live_cap ladder emits
                                    pow2 caps, ≤ log2(B)+1 distinct
========================  ========  =====================================

Findings are structured (:class:`repro_torch.analysis.rules.Finding`):
rule id, severity, target (config/mix/phase), human message, provenance
(the enclosing kernel scopes and the ``file:line`` of ``repro_torch``
that dispatched the op), offending op and tensor.

Names of the JAX package's jaxpr walker and VMEM estimate and their heirs
here: ``EqnSite`` -> :class:`OpSite`, ``iter_eqns`` -> :func:`iter_ops`,
``find_eqns`` -> :func:`find_ops`, ``intermediate_avals`` ->
:func:`intermediate_shapes`, ``count_primitive`` -> :func:`count_op`,
``count_pallas_calls`` -> :func:`count_kernel_calls`, ``subjaxprs`` ->
:func:`trace_ops` (one flat trace whose sites carry their nesting in
``path``), ``PallasVmemEstimate`` -> :class:`KernelResources`,
``VMEM_BUDGET_BYTES`` -> :data:`SMEM_BUDGET_BYTES`,
``estimate_pallas_vmem`` -> :func:`launch_smem_bytes`.
"""
from __future__ import annotations

from repro_torch.analysis.resources import KernelResources, \
    SMEM_BUDGET_BYTES, kernel_smem_bytes, launch_smem_bytes, parse_ptxas
from repro_torch.analysis.rules import Finding, LintTarget, RULES, \
    expected_dispatch_count, forbidden_weight_shapes, rule, run_rules
from repro_torch.analysis.walker import OpSite, Trace, count_kernel_calls, \
    count_op, find_ops, intermediate_shapes, iter_ops, trace_ops

__all__ = [
    "Finding", "KernelResources", "LintTarget", "OpSite", "RULES",
    "SMEM_BUDGET_BYTES", "Trace", "count_kernel_calls", "count_op",
    "expected_dispatch_count", "find_ops", "forbidden_weight_shapes",
    "intermediate_shapes", "iter_ops", "kernel_smem_bytes",
    "launch_smem_bytes", "parse_ptxas", "rule", "run_rules", "trace_ops",
]
