"""The port's fault taxonomy, injector and recovery ladders on the CPU
against the JAX package's (``serve(pipeline=False)``), on the tiny MoE of
``tests/test_faults.py`` from the same numpy-made params.

The injector's fired log equals the reference injector's for the same
specs and seed. Under each injection site — ``device.dispatch`` (one
retry, and a burst that walks the ladder to a ``DispatchError``),
``admit.alloc``, ``replay.prefill``, ``replay.chunk``,
``cache.blob.corrupt``, ``cache.blob.oversize``, and the SLO-policy sites
``preempt.evict`` and ``degrade.shift`` (EDF with a mid-run priority
burst) — and under one chaos schedule, every handle resolves as in the
JAX session: tokens, typed-error classes, result flags, modeled
TTFT/TPOT/timings and every ``SessionHealth`` field, with ``==``. A
failure that is neither injected nor an out-of-memory error raised before
the chunk wrote its state propagates out of ``step()`` unretried."""
import dataclasses
import warnings

import pytest
import torch

from _torch_serving import Pair, events, health, outcome, request_cls, \
    script
from repro.serving.faults import FaultInjector as JInjector
from repro.serving.faults import FaultSpec as JSpec
from repro.serving.faults import InjectedFault as JInjected
from repro_torch.serving import FaultInjector, FaultSpec, InjectedFault, \
    NO_FAULTS, ServingError, SessionClosed
from repro_torch.serving.compiled import CompiledDecodeChunk

SPECS = [dict(site="s", at=1, times=2, note="boom"),
         dict(site="s", at=2, times=3, probability=0.5),
         dict(site="d", kind="delay", delay_s=0.0, times=2),
         dict(site="big", kind="inflate", factor=3.0, at=1, times=2),
         dict(site="big", kind="inflate", factor=0.5, at=2, probability=0.7)]


def test_injector_fired_log_equals_reference():
    for seed in (0, 1, 7):
        fired = []
        for inj, spec, exc in ((JInjector, JSpec, JInjected),
                               (FaultInjector, FaultSpec, InjectedFault)):
            fi = inj([spec(**k) for k in SPECS], seed=seed)
            raised, sizes = [], []
            for _ in range(8):
                for site in ("s", "d"):
                    try:
                        fi.fire(site)
                        raised.append(None)
                    except exc as e:
                        raised.append((e.site, e.visit, str(e)))
                sizes.append(fi.inflate("big", 1000))
            fired.append((fi.fired, raised, sizes,
                          [fi.visits(s) for s in ("s", "d", "big", "x")]))
        assert fired[1] == fired[0]
    assert NO_FAULTS.fire("anything") is None
    assert NO_FAULTS.inflate("anything", 5) == 5
    with pytest.raises(ValueError):
        FaultSpec(site="s", kind="explode")


@pytest.fixture(scope="module")
def pair():
    return Pair(low_bits=2)


# SLO-policy sites run under EDF with a mid-run priority burst (the
# reference chaos suite's pattern), so preemption and the ladder are hit
SITES = {
    "dispatch-retry": [("device.dispatch", dict(at=1))],
    "dispatch-burst": [("device.dispatch", dict(at=1, times=4))],
    "admit-alloc": [("admit.alloc", dict(at=0, times=2))],
    "replay-prefill": [("replay.prefill", dict(at=0))],
    "replay-chunk": [("replay.chunk", dict(at=1))],
    "cache-corrupt": [("cache.blob.corrupt", dict(at=5))],
    "cache-oversize": [("cache.blob.oversize", dict(
        kind="inflate", factor=1e9, at=2, times=4))],
    "preempt-evict": [("preempt.evict", dict(at=0))],
    "degrade-shift": [("degrade.shift", dict(at=0))],
    "chaos": [("replay.chunk", dict(at=2)),
              ("device.dispatch", dict(at=1, times=2)),
              ("admit.alloc", dict(at=1)),
              ("preempt.evict", dict(at=1)),
              ("degrade.shift", dict(at=0, times=2))],
}
POLICY = {"preempt-evict", "degrade-shift", "chaos"}


def _serve_script(pair, which, name):
    policy = "edf" if name in POLICY else "fifo"
    s = pair.serve(which, faults=SITES[name], num_slots=2, slots_len=64,
                   policy=policy)
    reqs = script(which)
    if name in POLICY:
        hs = [s.submit(dataclasses.replace(r, max_new_tokens=12))
              for r in reqs[:4]]
        for _ in range(2):                  # slots busy, queue deep
            s.step()
        hs += [s.submit(dataclasses.replace(r, priority=3))
               for r in reqs[4:]]           # urgent burst: preempts
    else:
        hs = [s.submit(r) for r in reqs]
    s.drain(cancel_queued=False)
    # a late request after the faults: the session still serves
    hs.append(s.submit(request_cls(which)(
        prompt_tokens=[9, 8, 7], max_new_tokens=3, request_id="late")))
    s.drain(cancel_queued=False)
    hl = health(s)
    fired = list(s._faults.fired)
    s.close()
    return hs, hl, fired


@pytest.mark.parametrize("name", list(SITES))
def test_each_site_equals_jax(pair, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the oversize bypass warning
        jh, jhealth, jfired = _serve_script(pair, "jax", name)
        th, thealth, tfired = _serve_script(pair, "port", name)
    assert tfired == jfired and tfired           # the sites were visited
    assert [outcome(h) for h in th] == [outcome(h) for h in jh]
    assert [events(h) for h in th] == [events(h) for h in jh]
    assert thealth == jhealth
    for h in th:
        assert h.done
        assert h.error is None or isinstance(h.error, ServingError)
    assert th[-1].error is None                  # post-fault service
    if name == "dispatch-retry":
        assert thealth["dispatch_retries"] == 1
        assert thealth["status"] == "ok"
        assert all(h.error is None for h in th)


def _boom(exc):
    def call(self, *a, **kw):
        raise exc
    return call


def _two_requests(pair):
    s = pair.serve("port", num_slots=2, slots_len=64)
    hs = [s.submit(dataclasses.replace(r, max_new_tokens=20))
          for r in script("port")[:2]]
    s.step()                                     # admit + a clean chunk
    return s, hs


@pytest.mark.parametrize("where,exc,retried", [
    ("call", RuntimeError("CUDA error: an illegal memory access"), False),
    ("eager", torch.OutOfMemoryError("out of memory"), False),
    ("call", torch.OutOfMemoryError("out of memory"), True)],
    ids=["runtime-error", "oom-after-write", "oom-before-launch"])
def test_only_ladder_errors_are_retried(pair, monkeypatch, where, exc,
                                        retried):
    """A plain ``RuntimeError`` from the compiled chunk (a launch or
    device error) and an out-of-memory error raised once the eager chunk
    may have written the caches propagate out of ``step()`` with no
    retry; an out-of-memory error raised before the chunk ran is retried
    with a shorter chunk, token- and modeled-time-exact. ``close()``
    then resolves the handles and gives the decode state back."""
    clean, base = _two_requests(pair)
    clean.drain(cancel_queued=False)
    clean.close()
    s, hs = _two_requests(pair)
    cls = CompiledDecodeChunk
    if where == "eager":
        monkeypatch.setattr(cls, "_chunk", _boom(exc))
    else:
        inner, fired = cls.__call__, []

        def once(self, *a, **kw):
            if not fired:
                fired.append(1)
                raise exc
            return inner(self, *a, **kw)

        monkeypatch.setattr(cls, "__call__", once)
    if retried:
        s.drain(cancel_queued=False)
        assert s.health().dispatch_retries == 1
        # tokens, TTFT/TPOT and every step's timing (the cache-stats
        # snapshot is taken at a boundary the shorter chunk moved)
        keep = (0, 1, 2, 3, 10, 11)
        assert [[outcome(h)[i] for i in keep] for h in hs] == \
            [[outcome(h)[i] for i in keep] for h in base]
    else:
        with pytest.raises(RuntimeError) as info:
            s.step()
        assert not isinstance(info.value, torch.OutOfMemoryError)
        assert s.health().dispatch_retries == 0
        assert s.health().dispatch_failures == 0
    s.close()
    assert all(h.done for h in hs)
    if not retried:
        assert all(isinstance(h.error, SessionClosed) for h in hs)
    assert not any(st.held for st in pair.port._decode_batched.states())
