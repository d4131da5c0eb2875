"""The port's pipelined telemetry replay (``ReplayStream``, the session's
``pipeline=True``, the JAX package's default) on the CPU, on the tiny MoE
of ``tests/_torch_serving.py`` (2 layers, d_model 64, 4 experts top-2)
from numpy-made params:

  * ``ReplayStream`` alone: FIFO order on one worker, backpressure at
    ``maxsize``, sticky poisoning, ``pipelined=False`` running each job
    inline at ``submit``, ``close`` stopping the worker; a non-driving
    waiter bails out of a poisoned stream;
  * sessions: the port's pipelined session equals its inline session and
    the JAX package's pipelined session (greedy and sampled, "4/2" and
    "4/0"): outcomes (tokens, modeled TTFT/TPOT/timings, cache stats,
    weight bytes), ``TokenChunk`` streams in replay order and ``health()``;
    ``generate_batch`` both ways;
  * faults: a ``delay`` on every chunk replay with ``max_inflight_chunks=1``
    (the dispatch thread blocks on the full queue) changes no number; a
    ``replay.chunk`` raise takes down its job's handles with
    ``ReplayError``, counts one replay fault, degrades the session to
    inline replay, and requests admitted after the recovery get a clean
    run's tokens and modeled numbers from a cold orchestrator, equal to
    the JAX package's pipelined session;
  * a 2-replica ``ClusterRouter`` with ``pipeline=True`` equals the JAX
    package's (placements, tokens, modeled TTFT/TPOT);
  * threads: after ``close()``, after a fault's recovery and after a
    replica's cold restart, no port ``ReplayStream`` worker is left
    running.

Tolerance: none — every compared value is compared with ``==``."""
import threading
import time

import pytest

from _torch_serving import Pair, events, health, outcome, request_cls, \
    script
from repro.serving import ClusterRouter as JRouter
from repro.serving import ReplayError as JReplayError
from repro_torch.serving import ClusterRouter, ContinuousBatchingScheduler, \
    FaultInjector, FaultSpec, ReplayError, ReplayStream, Request, \
    SchedulerConfig
from repro_torch.serving.request import RequestHandle

SLOTS_LEN = 64


@pytest.fixture(scope="module", params=[2, 0], ids=["4/2", "4/0"])
def pair(request):
    return Pair(low_bits=request.param)


@pytest.fixture(scope="module")
def pair42():
    return Pair(low_bits=2)


# ------------------------------------------------------------ ReplayStream


def _wait(pred, timeout=5.0):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < timeout, "timed out"
        time.sleep(0.001)


@pytest.mark.parametrize("case", ["fifo", "backpressure", "poison",
                                  "inline", "waiter"])
def test_replay_stream(case):
    if case == "fifo":
        s = ReplayStream(pipelined=True, maxsize=64)
        seen = []
        for i in range(50):
            s.submit(lambda i=i: seen.append((i, threading.get_ident())))
        s.drain()
        assert [i for i, _ in seen] == list(range(50))
        assert len({tid for _, tid in seen}) == 1
        assert seen[0][1] != threading.get_ident()
        s.close()
        assert not s._thread.is_alive()
    elif case == "backpressure":
        s = ReplayStream(pipelined=True, maxsize=2)
        gate = threading.Event()
        s.submit(gate.wait)                  # the worker holds this one
        _wait(lambda: s._q.unfinished_tasks == 1 and s._q.qsize() == 0)
        s.submit(lambda: None)
        s.submit(lambda: None)               # queue full now
        blocked = threading.Thread(target=s.submit, args=(lambda: None,))
        blocked.start()
        time.sleep(0.05)
        assert blocked.is_alive()            # submit waits for a free place
        gate.set()
        blocked.join(timeout=5)
        assert not blocked.is_alive()
        s.drain()
        s.close()
    elif case == "poison":
        s = ReplayStream(pipelined=True, maxsize=8)
        ran = []
        gate = threading.Event()
        s.submit(gate.wait)

        def boom():
            raise ValueError("job failed")
        s.submit(boom)
        s.submit(lambda: ran.append("after"))   # queued behind the failure
        gate.set()
        with pytest.raises(ValueError, match="job failed"):
            s.drain()
        assert s.poisoned and ran == []
        with pytest.raises(RuntimeError, match="poisoned"):   # sticky
            s.submit(lambda: ran.append("later"))
        with pytest.raises(RuntimeError, match="poisoned"):
            s.drain()
        assert ran == []
        s.close()
        assert not s._thread.is_alive()
    elif case == "inline":
        s = ReplayStream(pipelined=False)
        seen = []
        s.submit(lambda: seen.append(threading.get_ident()))
        assert seen == [threading.get_ident()]   # ran at submit, here
        with pytest.raises(KeyError):
            s.submit(lambda: {}["x"])
        assert s.poisoned
        with pytest.raises(RuntimeError, match="poisoned"):
            s.submit(lambda: None)
        with pytest.raises(RuntimeError, match="poisoned"):
            s.drain()
        s.close()                            # no worker: a no-op
    else:   # a waiter that does not drive bails out of a poisoned stream
        class _Session:
            _stream = ReplayStream(pipelined=False)
        sess = _Session()
        with pytest.raises(KeyError):
            sess._stream.submit(lambda: {}["x"])
        h = RequestHandle(sess, 0, Request(prompt_tokens=[1, 2],
                                           max_new_tokens=2), 0.0)
        with pytest.raises(RuntimeError, match="poisoned"):
            h.result(drive=False)
        with pytest.raises(RuntimeError, match="poisoned"):
            list(h.stream(drive=False))


# ----------------------------------------------------------------- sessions


def _requests(which):
    """Four of ``script``'s ragged requests, and two seeded sampled
    ones."""
    cls = request_cls(which)
    return script(which)[:4] + [
        cls(prompt_tokens=[5, 9, 17, 3, 44, 2, 8], max_new_tokens=7,
            temperature=0.8, top_k=5, seed=11, request_id="req-6"),
        cls(prompt_tokens=[7, 7, 1, 30, 12], max_new_tokens=6,
            temperature=1.1, seed=4, request_id="req-7")]


def _serve(pair, which, pipeline, faults=(), **kw):
    """Staggered submits on 2 slots, stepped until idle, then flushed:
    (handles, health, the session)."""
    s = pair.serve(which, faults=faults, pipeline=pipeline, num_slots=2,
                   slots_len=SLOTS_LEN, **kw)
    reqs = _requests(which)
    hs = [s.submit(r) for r in reqs[:3]]
    s.step()
    s.step()
    hs += [s.submit(r) for r in reqs[3:]]
    while s.step():
        pass
    s.flush()
    got = hs, health(s)
    s.close()
    return got + (s,)


def _values(hs, hl):
    return [outcome(h) for h in hs], [events(h) for h in hs], hl


def test_pipelined_session_equals_inline_and_jax(pair):
    port_p = _serve(pair, "port", True)
    assert port_p[2]._stream.pipelined
    assert not port_p[2]._stream._thread.is_alive()   # closed
    want = _values(*_serve(pair, "port", False)[:2])
    assert _values(*port_p[:2]) == want
    assert _values(*_serve(pair, "jax", True)[:2]) == want
    assert all(h.error is None for h in port_p[0])


def test_generate_batch_pipelined(pair42):
    """``generate_batch`` defaults to the pipelined replay; it equals the
    inline one and the JAX package's; ``replay_s`` counts the jobs' own
    seconds and ``replay_blocked_s`` the dispatch thread's submits."""
    eng = pair42.port
    eng.faults = None
    pair42.jax.faults = None
    reqs = _requests("port")
    got = eng.generate_batch(reqs, num_slots=2)
    st = dict(eng.last_stats)
    inline = eng.generate_batch(reqs, num_slots=2, pipeline=False)
    want = pair42.jax.generate_batch(_requests("jax"), num_slots=2)
    key = [(r.tokens, r.ttft_s, r.tpot_s, r.cache_stats) for r in got]
    assert key == [(r.tokens, r.ttft_s, r.tpot_s, r.cache_stats)
                   for r in inline]
    assert key == [(r.tokens, r.ttft_s, r.tpot_s, r.cache_stats)
                   for r in want]
    assert st["replay_jobs"] == st["chunks"] + st["waves_batched"] + \
        st["waves_solo"]
    assert st["replay_s"] > 0 and st["replay_blocked_s"] > 0
    assert eng.last_stats["replay_blocked_s"] == 0.0   # inline: none


# ------------------------------------------------------------------- faults


def test_delay_with_one_inflight_chunk_changes_nothing(pair42):
    """Each chunk replay sleeps 30 ms and the queue holds one job: the
    dispatch thread blocks on its submits; every number is the clean
    inline run's."""
    want = _values(*_serve(pair42, "port", False)[:2])
    eng = pair42.port
    inj = FaultInjector([FaultSpec(site="replay.chunk", kind="delay",
                                   delay_s=0.03, times=100)])
    eng.faults = inj
    s = ContinuousBatchingScheduler(
        eng, num_slots=2, scfg=SchedulerConfig(max_inflight_chunks=1))
    s._ensure_started(slots_len=SLOTS_LEN)
    reqs = _requests("port")
    hs = [s.submit(r) for r in reqs[:3]]
    s.step()
    s.step()
    hs += [s.submit(r) for r in reqs[3:]]
    while s.step():
        pass
    s.flush()
    got = _values(hs, health(s))
    s.close()
    eng.faults = None
    assert got == want
    assert len(inj.fired) == s.stats["chunks"] >= 4
    assert s.stats["replay_s"] >= 0.03 * len(inj.fired)


def _fault_run(pair, which):
    """Three requests in flight together on 3 slots; the first chunk's
    replay raises. Then two more requests on the recovered session.
    Returns (phase-1 handles, phase-2 handles, health, the session)."""
    cls = request_cls(which)
    faults = [("replay.chunk", dict(at=0))]
    s = pair.serve(which, faults=faults, pipeline=True, num_slots=3,
                   slots_len=SLOTS_LEN)
    first = [s.submit(cls(prompt_tokens=list(range(3 + i, 11 + i)),
                          max_new_tokens=12, request_id=f"a{i}"))
             for i in range(3)]
    while s.step():
        pass
    s.flush()
    second = [s.submit(r) for r in script(which)[:2]]
    while s.step():
        pass
    s.flush()
    hl = health(s)
    s.close()
    return first, second, hl, s


def test_replay_chunk_fault_invariants(pair42):
    first, second, hl, s = _fault_run(pair42, "port")
    assert all(h.done for h in first + second)
    assert all(isinstance(h.error, ReplayError) for h in first)
    assert hl["replay_faults"] == 1 and hl["status"] == "degraded"
    assert not s._stream.pipelined                 # inline after recovery
    # admitted after the recovery: a clean inline run from a cold cache
    clean = pair42.serve("port", num_slots=3, slots_len=SLOTS_LEN)
    want = [clean.submit(r) for r in script("port")[:2]]
    while clean.step():
        pass
    clean.close()
    assert [outcome(h) for h in second] == [outcome(h) for h in want]
    assert [events(h) for h in second] == [events(h) for h in want]
    # and the JAX package's pipelined session under the same fault
    jfirst, jsecond, jhl, _ = _fault_run(pair42, "jax")
    assert all(isinstance(h.error, JReplayError) for h in jfirst)
    assert [outcome(h) for h in second] == [outcome(h) for h in jsecond]
    assert hl == jhl


# ------------------------------------------------------------------ cluster


def _route(router, cls):
    hs = [router.submit(cls(prompt_tokens=list(range(2 + i, 10 + i)),
                            max_new_tokens=4 + i % 4, request_id=f"r{i}"))
          for i in range(8)]
    res = [h.result() for h in hs]
    return ([h.replica for h in hs],
            [(r.tokens, r.ttft_s, r.tpot_s) for r in res])


def test_pipelined_router_equals_jax(pair42):
    pair42.port.faults = pair42.jax.faults = None
    with ClusterRouter.replicate(pair42.port, 2, num_slots=2,
                                 slots_len=SLOTS_LEN, pipeline=True) as r:
        streams = [rep.session._stream for rep in r.replicas]
        got = _route(r, Request)
    assert all(s.pipelined and not s._thread.is_alive() for s in streams)
    with JRouter.replicate(pair42.jax, 2, num_slots=2, slots_len=SLOTS_LEN,
                           pipeline=True) as jr:
        want = _route(jr, request_cls("jax"))
    assert got == want
    assert set(got[0]) == {0, 1}


# ------------------------------------------------------------------ threads


def test_no_worker_left_after_recovery_and_restart(pair42):
    """A replica's chunk replay faults: the recovery closes its pipelined
    worker (the session goes on inline), the cold restart swaps in a
    fresh pipelined session, and closing the router stops that worker."""
    pair42.port.faults = None
    faulty = FaultInjector([FaultSpec(site="replay.chunk", at=0)])
    router = ClusterRouter.replicate(pair42.port, 2, num_slots=2,
                                     slots_len=SLOTS_LEN, pipeline=True,
                                     faults=[None, faulty])
    rep = router.replicas[1]
    old = rep.session._stream
    try:
        hs = [router.submit(Request(prompt_tokens=[1 + i, 2, 3, 4],
                                    max_new_tokens=6)) for i in range(4)]
        for h in hs:
            try:
                h.result()
            except ReplayError:
                pass
        assert all(h.done for h in hs)
        assert any(isinstance(h.error, ReplayError) for h in hs)
        for _ in range(2):        # maintenance runs at the top of a step
            router.step()
        assert rep.restarts == 1
        assert not old._thread.is_alive()
        new = rep.session._stream
        assert new is not old and new.pipelined and new._thread.is_alive()
    finally:
        router.close()
    assert not new._thread.is_alive()
    assert all(not rp.session._stream.pipelined
               or not rp.session._stream._thread.is_alive()
               for rp in router.replicas)
