"""The port's open serving session (``engine.serve`` / ``submit`` /
``step`` / ``handle.stream`` / ``cancel`` / ``close``) on the CPU against
the JAX engine's session with ``pipeline=False`` (its inline replay), on
the tiny MoE of ``tests/test_faults.py`` from the same numpy-made params:
staggered submits with mid-run admission, the stream events, cancel in
flight and while queued, ``QueueFull`` backpressure with
``submit_with_retry``, deadline shedding, ``close`` and ``serve``
retiring the session before it. Tolerance: none — tokens, stream events
``(request_id, phase, tokens, modeled_s)``, typed-error classes,
``GenerationResult`` flags, modeled TTFT/TPOT/timings and every
``SessionHealth`` counter are compared with ``==``. The in-flight
deadline eviction is wall-clock driven, so only its flag and counter are
checked (the port alone)."""
import dataclasses
import time

import pytest

from _torch_serving import Pair, events, health, outcome, request_cls, \
    script
from repro.serving.faults import QueueFull as JQueueFull
from repro.serving.faults import SessionClosed as JSessionClosed
from repro.serving.faults import submit_with_retry as jsubmit_with_retry
from repro_torch.serving import DeadlineExceeded, QueueFull, \
    SessionClosed, submit_with_retry

BOTH = ("jax", "port")


@pytest.fixture(scope="module", params=[2, 0], ids=["4/2", "4/0"])
def pair(request):
    return Pair(low_bits=request.param)


@pytest.fixture(scope="module")
def pair42():
    return Pair(low_bits=2)


def _both(pair, scenario):
    """``scenario(which)`` -> (handles, health dict, extra) on each engine;
    asserts the two agree and returns the port's."""
    out = {w: scenario(w) for w in BOTH}
    (jh, jhealth, jx), (th, thealth, tx) = out["jax"], out["port"]
    assert [outcome(h) for h in th] == [outcome(h) for h in jh]
    assert [events(h) for h in th] == [events(h) for h in jh]
    assert thealth == jhealth
    assert tx == jx
    return th, thealth


def test_staggered_submits_mid_run_admission(pair):
    """Three requests, two steps, two more, a step, the last: late
    requests are admitted mid-run into drained slots; every stream's
    events concatenate to its tokens."""
    def scenario(which):
        s = pair.serve(which, num_slots=2, slots_len=64)
        reqs = script(which)
        hs = [s.submit(r) for r in reqs[:3]]
        s.step()
        s.step()
        hs += [s.submit(r) for r in reqs[3:5]]
        s.step()
        hs.append(s.submit(reqs[5]))
        s.drain(cancel_queued=False)
        hl = health(s)
        s.close()
        return hs, hl, None

    hs, hl = _both(pair, scenario)
    assert hl["submitted"] == hl["completed"] == 6
    for h in hs:
        res = h.result(drive=False)
        assert len(res.tokens) == h.request.max_new_tokens
        assert res.queue_wait_s >= 0.0
    # the events were consumed by the comparison: a second stream ends
    assert all(list(h.stream(drive=False)) == [] for h in hs)


def test_stream_drives_the_session(pair42):
    """``stream()`` with ``drive=True`` steps the session itself; its
    events equal those of the same run driven by ``drain``."""
    got = {}
    for which in BOTH:
        s = pair42.serve(which, num_slots=2, slots_len=64)
        hs = [s.submit(r) for r in script(which)]
        got[which] = [(e.request_id, e.phase, list(e.tokens), e.modeled_s)
                      for e in hs[4].stream()]
        s.drain(cancel_queued=False)
        got[which + "_rest"] = [outcome(h) for h in hs]
        s.close()
    assert got["port"] == got["jax"]
    assert got["port_rest"] == got["jax_rest"]
    assert sum((e[2] for e in got["port"]), []) == got["port_rest"][4][1]


def test_cancel_in_flight_and_queued(pair42):
    """One slot: the in-flight request cancelled after its first chunk
    gives a partial result; a queued one cancelled before admission gives
    an empty cancelled result; the request behind them serves whole."""
    def scenario(which):
        s = pair42.serve(which, num_slots=1, slots_len=64)
        R = request_cls(which)
        a = s.submit(R(prompt_tokens=[1, 2, 3, 4], max_new_tokens=30,
                       request_id="a"))
        b = s.submit(R(prompt_tokens=[5, 6], max_new_tokens=5,
                       request_id="b"))
        c = s.submit(R(prompt_tokens=[7, 8, 9], max_new_tokens=4,
                       request_id="c"))
        s.step()                   # admit a + one chunk
        a.cancel()
        b.cancel()
        s.drain(cancel_queued=False)
        hl = health(s)
        s.close()
        return [a, b, c], hl, None

    (a, b, c), _ = _both(pair42, scenario)
    ra, rb, rc = (h.result(drive=False) for h in (a, b, c))
    assert ra.cancelled and 0 < len(ra.tokens) < 30
    assert rb.cancelled and rb.tokens == []
    assert not rc.cancelled and len(rc.tokens) == 4


def test_queue_full_and_submit_with_retry(pair42):
    """``max_queue`` 2: a third submit raises ``QueueFull`` and creates no
    handle; ``submit_with_retry(drive=True)`` steps until room frees."""
    def scenario(which):
        s = pair42.serve(which, num_slots=1, slots_len=64, max_queue=2)
        reqs = script(which)
        hs = [s.submit(reqs[0]), s.submit(reqs[1])]
        full = QueueFull if which == "port" else JQueueFull
        with pytest.raises(full, match="admission queue is full"):
            s.submit(reqs[2])
        retry = submit_with_retry if which == "port" else jsubmit_with_retry
        hs.append(retry(s, reqs[2], attempts=50, drive=True))
        s.drain(cancel_queued=False)
        hl = health(s)
        s.close()
        return hs, hl, None

    hs, hl = _both(pair42, scenario)
    assert hl["queue_rejections"] >= 2
    assert all(h.error is None for h in hs)


def test_deadline_shedding(pair42):
    """``deadline_s=0`` and ``ttft_deadline_s=0`` queued requests resolve
    with ``DeadlineExceeded`` before admission; the other serves."""
    def scenario(which):
        s = pair42.serve(which, num_slots=1, slots_len=64)
        R = request_cls(which)
        hs = [s.submit(R(prompt_tokens=[1, 2, 3], max_new_tokens=3,
                         request_id="ok")),
              s.submit(R(prompt_tokens=[4, 5], max_new_tokens=3,
                         deadline_s=0.0, request_id="doomed")),
              s.submit(R(prompt_tokens=[6], max_new_tokens=3,
                         ttft_deadline_s=0.0, request_id="doomed2"))]
        s.drain(cancel_queued=False)
        hl = health(s)
        s.close()
        return hs, hl, None

    hs, hl = _both(pair42, scenario)
    assert hl["deadline_shed"] == 2
    for h in hs[1:]:
        with pytest.raises(DeadlineExceeded, match="shed"):
            h.result(drive=False)


def test_in_flight_deadline_eviction(pair42):
    """An admitted request past ``deadline_s`` is evicted at the next
    boundary like a cancel: a partial result with ``deadline_expired``
    and one ``deadline_evictions`` (wall-clock driven: flags only)."""
    s = pair42.serve("port", num_slots=1, slots_len=256)
    h = s.submit(request_cls("port")(
        prompt_tokens=[1, 2, 3, 4], max_new_tokens=150, deadline_s=0.3))
    s.step()                                  # admit + first chunk
    assert s.health().in_flight == 1
    time.sleep(max(0.0, h.submit_t + 0.35 - time.perf_counter()))
    while s.step():
        pass
    s.close()
    res = h.result(drive=False)
    assert res.cancelled and res.deadline_expired
    assert 0 < len(res.tokens) < 150
    assert s.health().deadline_evictions == 1


def test_close_resolves_every_handle(pair42):
    """``close()`` with a finished, an in-flight and a queued request:
    the finished keeps its result, the others resolve with
    ``SessionClosed`` (their streams end), submit then raises, and the
    session's decode state goes back to the engine."""
    def scenario(which):
        s = pair42.serve(which, num_slots=1, slots_len=64)
        reqs = script(which)
        done = s.submit(dataclasses.replace(reqs[0], max_new_tokens=1))
        s.step()
        inflight = s.submit(dataclasses.replace(reqs[1], max_new_tokens=40))
        s.step()
        queued = s.submit(reqs[2])
        s.close()
        closed = SessionClosed if which == "port" else JSessionClosed
        with pytest.raises(closed):
            s.submit(reqs[3])
        return [done, inflight, queued], health(s), None

    (done, inflight, queued), hl = _both(pair42, scenario)
    assert hl["status"] == "closed"
    assert done.error is None
    for h in (inflight, queued):
        assert isinstance(h.error, SessionClosed)
    assert not any(st.held for st in pair42.port._decode_batched.states())


def test_serve_retires_the_session_before_it(pair42):
    """A second ``serve()`` closes the engine's open session: its queued
    handle resolves with ``SessionClosed``; ``engine.submit`` /
    ``engine.step`` / ``engine.health`` then drive the new one."""
    def scenario(which):
        eng = getattr(pair42, which)
        first = pair42.serve(which, num_slots=1, slots_len=64)
        old = first.submit(script(which)[0])
        second = pair42.serve(which, num_slots=1, slots_len=64)
        assert first.closed and eng._session is second
        new = eng.submit(script(which)[1])
        while eng.step():
            pass
        hl = dataclasses.asdict(eng.health())
        second.close()
        return [old, new], hl, None

    (old, new), hl = _both(pair42, scenario)
    assert isinstance(old.error, SessionClosed) and new.error is None
    assert hl["submitted"] == 1
