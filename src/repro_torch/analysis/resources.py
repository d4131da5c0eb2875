"""What bounds a Hopper kernel: the heir of the JAX package's VMEM
estimate (``repro/analysis/vmem.py``).

A Pallas TPU kernel had to fit its double-buffered blocks in VMEM. A CUDA
kernel of the port has to fit a thread block's dynamic shared memory in
what an SM grants one block (227 KiB on the H100, the opt-in maximum),
its registers in 255 a thread, and must not spill to local memory (the
tensor-core tiles of K1-K5 are sized to the register file: a spill is a
toolchain regression, not a tuning choice).

Three sources, held against each other:

* ``ptxas -v`` logs (``kernels/_build.build_all(ptxas_verbose=True)``):
  registers, static shared memory and spill bytes of every instantiation,
  parsed by :func:`parse_ptxas`;
* this module's mirror of the dynamic shared memory each launch asks for
  (``smem_bytes<Tin, MT>()`` of ``kernels/quant_matmul/csrc/mma_tile.cuh``
  for K1-K3, ``fwd_smem_bytes`` / ``mass_smem_bytes`` over
  ``kernels/attn_scores/csrc/score_tile.cuh`` for K4/K5), for every
  instantiation the wrappers can launch (:data:`INSTANTIATIONS`) and for
  one call at its shapes (:func:`launch_smem_bytes`);
* on the card, ``cudaFuncGetAttributes`` of each instantiation through
  the ``<lib>_attrs`` entry every library exports (:func:`card_resources`),
  with the size the launcher requests as the C++ computes it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["KernelResources", "SMEM_BUDGET_BYTES", "MAX_REGISTERS",
           "MAX_SPILL_BYTES", "INSTANTIATIONS", "instantiation_smem",
           "kernel_smem_bytes", "launch_smem_bytes", "parse_ptxas",
           "card_resources"]

# dynamic shared memory one block may opt into
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), by target
SMEM_BUDGET_BYTES: Dict[str, int] = {"sm_90a": 232448}
MAX_REGISTERS = 255
MAX_SPILL_BYTES = 0


@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One kernel instantiation's resources: ``name`` is
    ``"<library>:<kernel><<type>,<tile>>"``; ``smem_bytes`` the shared
    memory of one block (static, plus the dynamic size its launcher
    requests where that is known); spill bytes a thread (on the card:
    its local memory, spills and stack together)."""

    name: str
    registers: int
    smem_bytes: int
    spill_stores: int
    spill_loads: int

    def problems(self, target: str = "sm_90a") -> List[str]:
        """What breaks the budgets, as sentences (empty: fits)."""
        out = []
        if self.registers > MAX_REGISTERS:
            out.append(f"{self.registers} registers a thread > "
                       f"{MAX_REGISTERS}")
        if self.smem_bytes > SMEM_BUDGET_BYTES[target]:
            out.append(f"{self.smem_bytes} B of shared memory a block > "
                       f"{SMEM_BUDGET_BYTES[target]} B")
        if self.spill_stores + self.spill_loads > MAX_SPILL_BYTES:
            out.append(f"spills {self.spill_stores} B stores, "
                       f"{self.spill_loads} B loads")
        return out


# --------------------------------------------------- mirror of mma_tile.cuh
_BN, _BK, _STAGES, _XPAD = 128, 64, 2, 16
_MAX_GROUPS = _BK // 16


def _code_stride(bits: int) -> int:
    b = _BK * bits // 8
    return b if (b // 16) % 2 else b + 16


_CODE_STRIDE_MAX = _code_stride(8)
_SIZE = {"bf16": 2, "f32": 4}


def _mma_smem(tin: str, mt: int) -> int:
    """``smem_bytes<Tin, MT>()``: a STAGES-deep ring of (x tile, code
    chunk, scale chunk)."""
    x_tile = 16 * mt * (_BK + _XPAD) * _SIZE[tin]
    return _STAGES * (x_tile + _BN * _CODE_STRIDE_MAX + _MAX_GROUPS * _BN * 4)


# ------------------------------------------------- mirror of score_tile.cuh
_ROWS = 64


def _col_rows(t: str, dmax: int) -> int:
    return 32 if t == "f32" and dmax > 64 else 64


def _pad16(d: int) -> int:
    return (d + 15) & ~15


def _ld_rows(t: str, dp: int) -> int:
    if t == "f32":
        return dp if (dp // 16) % 2 else dp + 16
    return dp + 8


def _row_tile(t: str, dp: int) -> int:
    return _ROWS * _ld_rows(t, dp) * _SIZE[t]


def _plane(ct: int, dp: int) -> int:
    return ct * (dp + 8) * 2


def _landing(ct: int, dp: int) -> int:
    return ct * dp * 4


def _fwd_smem(t: str, ct: int, dp: int) -> int:
    return _row_tile(t, dp) + (
        2 * _landing(ct, dp) + 5 * _plane(ct, dp) if t == "f32"
        else 4 * _plane(ct, dp))


def _mass_smem(t: str, ct: int, dp: int) -> int:
    return _row_tile(t, dp) + 2 * ct * 4 + (
        _landing(ct, dp) + 3 * _plane(ct, dp) if t == "f32"
        else 2 * _plane(ct, dp))


_DMAX = (64, 128, 256)

# every instantiation a library can launch, in the order its
# ``<lib>_attrs(which, ...)`` entry enumerates them
INSTANTIATIONS: Dict[str, Tuple[str, ...]] = {
    "eqm_grouped": tuple(f"grouped_kernel<{t},{mt}>"
                         for t in ("bf16", "f32") for mt in (1, 4)),
    "eqm_expert": tuple(f"expert_kernel<{t},{mt}>"
                        for t in ("bf16", "f32") for mt in (1, 4)),
    "qm_dense": tuple(f"dense_kernel<{t},{mt}>"
                      for t in ("bf16", "f32") for mt in (1, 4))
    + ("dense_split_kernel<bf16>", "dense_split_kernel<f32>"),
    "attn_flash_fwd": tuple(f"flash_fwd_kernel<{t},{d}>"
                            for t in ("bf16", "f32") for d in _DMAX),
    "attn_key_mass": tuple(f"key_mass_kernel<{t},{d}>"
                           for t in ("bf16", "f32") for d in _DMAX),
}

_LABEL = re.compile(r"(\w+)<(\w+)(?:,(\d+))?>")


def instantiation_smem(label: str) -> int:
    """The dynamic shared memory the launcher requests for an
    instantiation (the attribute it sets once; for K4/K5 the largest D of
    the instantiation's bucket)."""
    kern, t, n = _LABEL.fullmatch(label).groups()
    if kern == "dense_split_kernel":
        return _mma_smem(t, 1)
    if kern in ("grouped_kernel", "expert_kernel", "dense_kernel"):
        return _mma_smem(t, int(n))
    dmax = int(n)
    fn = _fwd_smem if kern == "flash_fwd_kernel" else _mass_smem
    return fn(t, _col_rows(t, dmax), dmax)


def kernel_smem_bytes() -> Dict[str, int]:
    """{"<lib>:<instantiation>": requested dynamic shared memory} for
    every instantiation (the heir of ``estimate_pallas_vmem``)."""
    return {f"{lib}:{label}": instantiation_smem(label)
            for lib, labels in INSTANTIATIONS.items() for label in labels}


def _tname(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def launch_smem_bytes(kernel: str, inputs: Sequence, params: dict
                      ) -> Tuple[str, int]:
    """(instantiation, dynamic shared memory) of one kernel call, from the
    shapes and dtypes of its operands (``inputs``: (shape, dtype, ...)
    entries, the first the activation) and its scalar ``params``, as the
    C launchers pick them."""
    shape, dtype = inputs[0][0], inputs[0][1]
    t = _tname(dtype)
    if kernel in ("flash_fwd", "key_mass"):
        d = shape[-1]
        dmax = next(v for v in _DMAX if d <= v or v == _DMAX[-1])
        fn = _fwd_smem if kernel == "flash_fwd" else _mass_smem
        label = f"{kernel}_kernel<{t},{dmax}>"
        return label, fn(t, _col_rows(t, dmax), _pad16(d))
    if kernel == "quant_matmul":
        m = 1
        for v in shape[:-1]:
            m *= v
        mt = 1 if m <= 16 else 4
        return f"dense_kernel<{t},{mt}>", _mma_smem(t, mt)
    m = shape[1]
    if kernel == "expert_quant_matmul_grouped":
        cap_hi = params.get("cap_hi", m)
        mt = 1 if cap_hi <= 16 and m - cap_hi <= 16 else 4
        return f"grouped_kernel<{t},{mt}>", _mma_smem(t, mt)
    mt = 1 if m <= 16 else 4
    return f"expert_kernel<{t},{mt}>", _mma_smem(t, mt)


# ----------------------------------------------------------------- ptxas

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_MANGLED = re.compile(
    r"(grouped_kernel|expert_kernel|dense_split_kernel|dense_kernel|"
    r"flash_fwd_kernel|key_mass_kernel)I(13__nv_bfloat16|f)(?:Li(\d+)E)?E")


def _demangle(symbol: str) -> str:
    m = _MANGLED.search(symbol)
    if m is None:
        return symbol
    kern, t, n = m.groups()
    t = "bf16" if t.endswith("bfloat16") else "f32"
    return f"{kern}<{t},{n}>" if n else f"{kern}<{t}>"


def parse_ptxas(log: str, lib: str = "") -> List[KernelResources]:
    """The entry functions of one ``ptxas -v`` log (one library's build
    output): registers, static shared memory and spill bytes each. The
    dynamic shared memory a launch requests is not in the log; add it
    with :func:`instantiation_smem`."""
    out: List[KernelResources] = []
    cur: Optional[dict] = None

    def close():
        if cur is not None and "registers" in cur:
            out.append(KernelResources(
                name=f"{lib}:{cur['name']}" if lib else cur["name"],
                registers=cur["registers"], smem_bytes=cur.get("smem", 0),
                spill_stores=cur.get("stores", 0),
                spill_loads=cur.get("loads", 0)))

    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            close()
            cur = {"name": _demangle(m.group(1))}
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["stores"], cur["loads"] = int(m.group(1)), int(m.group(2))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    close()
    return out


def with_requested_smem(res: KernelResources) -> KernelResources:
    """``res`` with the dynamic shared memory its launcher requests added
    to its static size."""
    label = res.name.split(":", 1)[-1]
    if not _LABEL.fullmatch(label):
        return res
    return dataclasses.replace(
        res, smem_bytes=res.smem_bytes + instantiation_smem(label))


# ------------------------------------------------------------------ card


def card_resources(lib: str) -> List[dict]:
    """``cudaFuncGetAttributes`` of every instantiation of library
    ``lib`` on the current card, through its ``<lib>_attrs`` entry:
    {name, registers, local_bytes, static_smem, max_dynamic_smem (the
    attribute as the launcher left it: what it set once it launched),
    requested_smem (the launcher's own size, computed by the C++),
    mirror_smem (this module's), resources (a :class:`KernelResources`
    with the local bytes as spills)}. Builds the libraries if needed."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load_attrs(lib)
    rows = []
    for which, label in enumerate(INSTANTIATIONS[lib]):
        vals = (ctypes.c_int * 5)()
        _build.raise_on_error(f"{lib}_attrs({which})", fn(which, vals))
        regs, local, static, max_dyn, requested = list(vals)
        name = f"{lib}:{label}"
        rows.append(dict(
            name=name, registers=regs, local_bytes=local,
            static_smem=static, max_dynamic_smem=max_dyn,
            requested_smem=requested, mirror_smem=instantiation_smem(label),
            resources=KernelResources(name, regs, static + requested, local,
                                      0)))
    return rows
