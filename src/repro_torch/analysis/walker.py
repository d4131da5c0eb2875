"""The op trace every invariant rule reads: the heir of the JAX package's
jaxpr walker.

The JAX package traced its serving programs into jaxprs and walked their
equations. The port has no tracer of that kind; what it has is one eager
run of the same program. :func:`trace_ops` runs ``fn`` once under a
``TorchDispatchMode`` and records every aten op the run dispatches, on
whichever device the run's tensors live:

* ``meta`` — the full-size program, zero bytes allocated (the heir of
  ``jax.eval_shape``); a kernel returns an empty output of its shape;
* the CPU — the kernels' plain versions run inside their scopes;
* the card — the CUDA kernels launch through ``ctypes``, which the
  dispatcher never sees.

A kernel call is what :class:`~repro_torch.kernels._scope.kernel_scope`
marks: the trace records each scope's entry as a site of its own (the
counterpart of a ``pallas_call`` equation), with its operands and result,
and marks every op run inside a scope ``in_kernel`` (the counterpart of a
Pallas kernel body). Scopes nest in ``path``; only outermost scopes are
counted as calls.

What the trace sees of a host read. Besides the dispatch mode, a
``TorchFunctionMode`` watches the Python-level calls that read a
tensor's value on the host: ``item()``, ``tolist()``, ``numpy()``,
``bool()``, ``int()``, ``float()``, ``__index__``, ``nonzero()``,
``masked_select``, ``unique``, ``equal`` and ``bincount`` (anything that
sizes an output by a value), and ``cpu()`` / ``to("cpu")`` of a tensor
that is not on the CPU. Each is a ``host:<name>`` site, on every device,
recorded before the call runs (on ``meta`` it then raises). At the aten
level a CPU run dispatches no op at all for ``tolist()`` or ``numpy()``,
and composite ops read values for their own checks on the CPU only (the
CPU ``one_hot`` checks its class range with ``.item()``; the CUDA one
does not), so an aten op that reads a value (``_local_scalar_dense``,
``nonzero``, a copy to the CPU, ...) counts as a host read only where
its input lives on the card. There, ``torch.cuda.set_sync_debug_mode(
"error")`` is the second net under the trace.

Provenance. For the ops a rule can flag (an output at a watched shape,
f64, packed codes widened, a host read) the trace records the nearest
frame of ``repro_torch`` outside this package as ``file:line``, so a
finding points at the line that broke the contract. Recording it for
those ops alone keeps a full-size trace fast.

Packed codes. Outside kernel calls the trace marks an op
``from_packed`` when it widens packed codes (uint8 / int8 in, a wider
non-packed tensor of as many elements out: the unpack) or reads a
tensor such an op made, so a dense weight dequantized outside the
kernels is told apart from an activation buffer that merely has a
weight's shape.

Memory. The trace keeps the sum of the bytes of the storages that the run
created and that are still alive (a ``weakref.finalize`` on each
output), and its largest value: with the bytes of ``fn``'s tensor
arguments, the estimate of the run's peak that the dry run reports.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _scope

__all__ = ["TensorInfo", "OpSite", "Trace", "trace_ops", "iter_ops",
           "find_ops", "intermediate_shapes", "count_op",
           "count_kernel_calls", "tensor_bytes", "FLOAT_DTYPES",
           "PACKED_DTYPES", "HOST_SYNC_OPS"]

FLOAT_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.float16))
PACKED_DTYPES = frozenset((torch.uint8, torch.int8))
# aten ops that hand a device value to the host (or size an output by
# one, which reads it on the host)
HOST_SYNC_OPS = frozenset((
    "aten._local_scalar_dense.default", "aten.is_nonzero.default",
    "aten.equal.default", "aten.nonzero.default",
    "aten.masked_select.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.repeat_interleave.Tensor",
))

# Python-level calls that read a tensor's value on the host
HOST_READS = frozenset((
    "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
    "__index__", "nonzero", "argwhere", "masked_select", "unique",
    "unique_consecutive", "equal", "bincount"))

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = os.path.join(_PKG, "analysis") + os.sep
_KERNELS = os.path.join(_PKG, "kernels") + os.sep
_ROOT = os.path.dirname(_PKG)
if os.path.basename(_ROOT) == "src":
    _ROOT = os.path.dirname(_ROOT)


class TensorInfo(tuple):
    """(shape, dtype, device type) of one tensor of a site."""

    __slots__ = ()

    def __new__(cls, t: torch.Tensor):
        return tuple.__new__(cls, (tuple(t.shape), t.dtype, t.device.type))

    shape = property(lambda self: self[0])
    dtype = property(lambda self: self[1])
    device = property(lambda self: self[2])

    @property
    def numel(self) -> int:
        n = 1
        for d in self[0]:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self[1].itemsize

    def __repr__(self) -> str:
        return f"{str(self[1]).removeprefix('torch.')}{list(self[0])}"


@dataclasses.dataclass
class OpSite:
    """One recorded aten op or kernel call, and where it lives.

    ``op`` is the aten overload (``"aten.mm.default"``), for a kernel
    call ``"kernel:<name>"``, for a Python-level host read
    ``"host:<name>"``. ``path`` is the chain of enclosing kernel
    scopes; ``in_kernel`` is True inside any of them (for a kernel site:
    when it is nested in another kernel call). ``where`` is the
    ``file:line`` of the nearest frame of ``repro_torch`` outside
    ``analysis/``, recorded for the ops a rule can flag and for kernel
    calls."""

    op: str
    inputs: Tuple[TensorInfo, ...]
    outputs: Tuple[TensorInfo, ...]
    path: Tuple[str, ...]
    in_kernel: bool
    where: str = ""
    is_view: bool = False
    host_read: bool = False     # hands a tensor's value to the host
    from_packed: bool = False   # outside kernels, made from packed codes
    params: dict = dataclasses.field(default_factory=dict)  # a kernel's

    @property
    def kernel(self) -> Optional[str]:
        return self.op[7:] if self.op.startswith("kernel:") else None

    def provenance(self) -> str:
        """Where the site is, for findings: its enclosing scopes and its
        source line."""
        scopes = "/".join(self.path) or "<top>"
        return f"{scopes} @ {self.where}" if self.where else scopes


@dataclasses.dataclass
class Trace:
    """What one run dispatched. ``sites`` in dispatch order;
    ``arg_bytes`` the bytes of the run's tensor arguments;
    ``peak_temp_bytes`` the largest sum of live bytes the run allocated;
    ``error`` what the run raised, if it did (the sites up to it are
    kept)."""

    sites: List[OpSite]
    arg_bytes: int = 0
    peak_temp_bytes: int = 0
    error: Optional[str] = None

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.peak_temp_bytes

    def bytes_accessed(self) -> int:
        """Bytes read and written, the heir of XLA's "bytes accessed":
        each op outside a kernel scope (views excepted) reads its inputs
        and writes its outputs once; each outermost kernel call reads its
        operands and writes its result once."""
        total = 0
        for s in self.sites:
            if s.in_kernel or s.is_view or s.op.startswith("host:"):
                continue
            total += sum(i.nbytes for i in s.inputs)
            total += sum(o.nbytes for o in s.outputs)
        return total


def tensor_bytes(tree: Any, exclude: Any = None) -> int:
    """Bytes of the distinct storages of the tensors in a tree of dicts,
    lists, tuples, dataclasses (packed stores, caches) and shards
    (``.local``), leaving out those the tensors of ``exclude`` hold (a
    step's outputs that alias its arguments)."""
    seen = {t.untyped_storage()._cdata for t in _tensors_in(exclude)}
    total = 0
    for t in _tensors_in(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _tensors_in(node: Any) -> Iterator[torch.Tensor]:
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors_in(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors_in(v)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _tensors_in(getattr(node, f.name))
    elif hasattr(node, "local") and isinstance(getattr(node, "local"),
                                                torch.Tensor):
        yield node.local


def _infos(values) -> Tuple[TensorInfo, ...]:
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(TensorInfo(v))
        elif isinstance(v, (list, tuple)):
            out.extend(TensorInfo(t) for t in v
                       if isinstance(t, torch.Tensor))
    return tuple(out)


def _where(outside: str = _SKIP) -> str:
    """``file:line`` of the nearest frame of repro_torch outside
    ``analysis/`` and ``outside`` (``""`` when the op came from
    elsewhere)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_SKIP) \
                and not fn.startswith(outside):
            return f"{os.path.relpath(fn, _ROOT)}:{f.f_lineno}"
        f = f.f_back
    return ""


class _Recorder(TorchDispatchMode):
    """The dispatch mode of :func:`trace_ops`; also this thread's kernel
    scope recorder while it runs."""

    def __init__(self, watch_shapes: frozenset, args: set):
        super().__init__()
        self.args = args                       # storages of fn's arguments
        self.sites: List[OpSite] = []
        self.stack: List[str] = []
        self.watch = watch_shapes
        self.live: Dict[int, List[int]] = {}   # storage -> [bytes, refs]
        self.live_bytes = 0
        self.peak = 0
        self.tainted: set = set()   # storages made from packed codes
        self.names: Dict[Any, str] = {}

    # ---------------------------------------------------------- memory
    def _drop(self, key: int) -> None:
        ent = self.live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self.live[key]
            self.tainted.discard(key)

    def _track(self, out: Any) -> None:
        ts = (out,) if isinstance(out, torch.Tensor) else (
            out if isinstance(out, (list, tuple)) else ())
        for t in ts:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            ent = self.live.get(key)
            if ent is None:
                if key in self.args:
                    continue
                ent = self.live[key] = [st.nbytes(), 0]
                self.live_bytes += ent[0]
                if self.live_bytes > self.peak:
                    self.peak = self.live_bytes
            ent[1] += 1
            weakref.finalize(t, self._drop, key)

    # ---------------------------------------------------------- kernels
    def enter_kernel(self, name: str, operands, params: dict) -> OpSite:
        site = OpSite(op=f"kernel:{name}", inputs=_infos(operands),
                      outputs=(), path=tuple(self.stack),
                      in_kernel=bool(self.stack),
                      where=_where(_KERNELS),   # the entry point's caller
                      params=params)
        self.sites.append(site)
        self.stack.append(name)
        return site

    def exit_kernel(self, site: OpSite) -> None:
        self.stack.pop()

    def kernel_outputs(self, site: OpSite, out) -> None:
        site.outputs = _infos(out if isinstance(out, (list, tuple))
                              else (out,))

    # -------------------------------------------------------------- ops
    def host_read(self, name: str, args) -> None:
        self.sites.append(OpSite(
            op=f"host:{name}", inputs=_infos(args[:1]), outputs=(),
            path=tuple(self.stack), in_kernel=bool(self.stack),
            where=_where(), host_read=True))

    def _flag(self, site: OpSite) -> bool:
        ins, outs = site.inputs, site.outputs
        if site.op in HOST_SYNC_OPS or site.op in _COPIES:
            site.host_read = any(i.device == "cuda" for i in ins) and (
                site.op in HOST_SYNC_OPS
                or any(o.device == "cpu" for o in outs[:1]))
            if site.host_read:
                return True
        for o in outs:
            if o.dtype == torch.float64:
                return True
        if self.stack:
            return False
        for o in outs:
            if o.shape in self.watch and o.dtype in FLOAT_DTYPES \
                    and site.from_packed and not site.is_view:
                return True
        return _widens(ins, outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = self.names.get(func)
        if name is None:
            name = self.names[func] = str(func)
        ins = _infos(args) + _infos(kwargs.values())
        site = OpSite(op=name, inputs=ins, outputs=(),
                      path=tuple(self.stack), in_kernel=bool(self.stack),
                      is_view=func.is_view)
        self.sites.append(site)
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        site.outputs = _infos(outs)
        if not self.stack and (_widens(ins, site.outputs) or (
                self.tainted and any(
                    k in self.tainted for k in _storages(args, kwargs)))):
            site.from_packed = True
            self.tainted.update(_storages(outs, {}))
        if self._flag(site):
            site.where = _where()
        self._track(out)
        return out


def _storages(args, kwargs) -> List[int]:
    """Storage keys of the tensors among ``args`` and ``kwargs`` (one
    level of lists)."""
    out = []
    for v in (*args, *kwargs.values()):
        for t in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(t, torch.Tensor):
                out.append(t.untyped_storage()._cdata)
    return out


_COPIES = frozenset(("aten._to_copy.default", "aten.copy_.default"))


class _HostReads(TorchFunctionMode):
    """Records the Python-level calls of :data:`HOST_READS` (and moves of
    a non-CPU tensor to the CPU) into the recorder, before they run."""

    def __init__(self, rec: "_Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in HOST_READS or (name in ("cpu", "to") and _to_host(
                name, args, kwargs)):
            self.rec.host_read(name, args)
        return func(*args, **kwargs)


def _to_host(name: str, args, kwargs) -> bool:
    """A move of a tensor that is not on the CPU to the CPU."""
    if not args or not isinstance(args[0], torch.Tensor) or \
            args[0].device.type == "cpu":
        return False
    if name == "cpu":
        return True
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
    return dev is not None and torch.device(dev).type == "cpu"


def _widens(ins, outs) -> bool:
    """Packed codes (uint8 / int8) made into a wider non-packed tensor of
    at least as many elements: the unpack."""
    for i in ins:
        if i.dtype in PACKED_DTYPES:
            for o in outs:
                if o.dtype not in PACKED_DTYPES and o.dtype.itemsize > 1 \
                        and o.numel >= i.numel:
                    return True
    return False


def trace_ops(fn: Callable, *args, watch_shapes=frozenset(),
              **kwargs) -> Tuple[Any, Trace]:
    """Run ``fn(*args, **kwargs)`` once and return (its result, the
    :class:`Trace`). ``watch_shapes``: output shapes whose float ops
    outside a kernel get a ``where`` (the dense-weight shapes a rule
    forbids). If ``fn`` raises, the exception propagates with the trace so
    far attached as ``exc.trace`` (its ``error`` set)."""
    rec = _Recorder(frozenset(watch_shapes),
                    {t.untyped_storage()._cdata
                     for t in _tensors_in((args, kwargs))})
    trace = Trace(sites=rec.sites, arg_bytes=tensor_bytes((args, kwargs)))
    prev = _scope.set_recorder(rec)
    try:
        with _HostReads(rec), rec:
            out = fn(*args, **kwargs)
    except BaseException as e:
        trace.error = f"{type(e).__name__}: {e}"
        trace.peak_temp_bytes = rec.peak
        e.trace = trace
        raise
    finally:
        _scope.set_recorder(prev)
    trace.peak_temp_bytes = rec.peak
    return out, trace


# ------------------------------------------------------------- queries


def iter_ops(trace: Trace, *, into_kernels: bool = True
             ) -> Iterator[OpSite]:
    """Every site in dispatch order; ``into_kernels=False`` leaves out
    what runs inside a kernel call (the kernel sites themselves stay)."""
    for s in trace.sites:
        if into_kernels or not s.in_kernel:
            yield s


def find_ops(trace: Trace, pred: Callable[[OpSite], bool], *,
             into_kernels: bool = True) -> List[OpSite]:
    return [s for s in iter_ops(trace, into_kernels=into_kernels)
            if pred(s)]


def intermediate_shapes(trace: Trace, *, into_kernels: bool = False
                        ) -> List[TensorInfo]:
    """Every op output (shape, dtype, device); kernel bodies left out by
    default, as the no-dense-dequant contract is about what lives outside
    kernels."""
    return [o for s in iter_ops(trace, into_kernels=into_kernels)
            if s.kernel is None for o in s.outputs]


def count_op(trace: Trace, name: str) -> int:
    """Sites of op ``name`` (``"aten.mm.default"``, or
    ``"kernel:<name>"``) outside kernel bodies."""
    return len(find_ops(trace, lambda s: s.op == name, into_kernels=False))


def count_kernel_calls(trace: Trace, name: Optional[str] = None) -> int:
    """Outermost kernel calls (of kernel ``name``, or of any): the heir of
    ``count_pallas_calls``. The port has no layer scan, so a trace holds
    every layer and step: divide by them for a per-body count."""
    return len(find_ops(
        trace, lambda s: s.kernel is not None and (name is None
                                                   or s.kernel == name),
        into_kernels=False))
