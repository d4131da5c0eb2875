"""Where one kernel call starts and ends, for the op trace of
``repro_torch.analysis``.

On the card a kernel launches through the plain C interface of
``kernels/_build.py``, not through the torch dispatcher, so a trace of
aten ops cannot see it. Every public kernel entry point therefore enters
:class:`kernel_scope` around its call, whichever implementation runs: the
scope is what the trace sees of a launch (the counterpart of a
``pallas_call`` equation in the JAX package's jaxpr), and the ops run
inside it (a wrapper's output allocation on the card, the plain version
on the CPU) are marked as inside a kernel, like a Pallas kernel body.

A recorder (``analysis/walker.py``) registers itself for its own thread.
With none registered, entering and leaving a scope reads one thread-local
attribute and does nothing else.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = ["kernel_scope", "set_recorder", "current_recorder"]

_tls = threading.local()


def current_recorder() -> Optional[Any]:
    """The recorder of this thread's trace, or None."""
    return getattr(_tls, "recorder", None)


def set_recorder(recorder: Optional[Any]) -> Optional[Any]:
    """Make ``recorder`` this thread's (None: stop); returns the previous
    one, for the caller to restore."""
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = recorder
    return prev


class kernel_scope:
    """``with kernel_scope(name, *operands, **params) as ks: ...
    return ks.done(out)``

    ``name`` is the kernel's (the key of its ``LAUNCHES`` counter);
    ``operands`` are the tensors the kernel reads (None entries are
    skipped), ``params`` the scalars that pick its launch (as an
    equation's params), ``done(out)`` names what it returns and returns
    it. A recorder sees the scope's entry, operands, params and outputs,
    and the ops run inside it."""

    __slots__ = ("name", "operands", "params", "_site", "_rec")

    def __init__(self, name: str, *operands, **params):
        self.name = name
        self.operands = operands
        self.params = params
        self._site = None

    def __enter__(self) -> "kernel_scope":
        rec = getattr(_tls, "recorder", None)
        self._rec = rec
        if rec is not None:
            self._site = rec.enter_kernel(self.name, self.operands,
                                          self.params)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            self._rec.exit_kernel(self._site)
        return False

    def done(self, out):
        if self._rec is not None:
            self._rec.kernel_outputs(self._site, out)
        return out
