"""The port's SLO policy layer (``serving/policy.py``) against the JAX
package's: ``estimate_service_s`` over the 12 ``ARCH_IDS``, the
degradation ladder's hysteresis, EDF order and ``make_policy`` on the same
inputs; then sessions on the tiny MoE of ``tests/test_faults.py`` on the
CPU against the JAX session with ``pipeline=False``: FIFO and SLO-free
EDF equal to the default session, a priority preemption resuming with the
same tokens and a stream without repeats, infeasible requests shed with
``DeadlineExceeded(infeasible=True)``, and every ladder rung leaving the
tokens unchanged with modeled numbers equal to JAX's. Tolerance: none —
``==`` throughout (the estimate is the same host arithmetic)."""
import numpy as np
import pytest

from _torch_bridge import port_cfg
from _torch_serving import Pair, events, health, outcome, request_cls, \
    script
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.serving import Request as JRequest
from repro.serving import policy as jpol
from repro.serving.cost_model import EdgeCostModel as JCost
from repro.serving.cost_model import EdgeProfile as JProfile
from repro_torch.serving import Request
from repro_torch.serving import policy as tpol
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile

BOTH = ("jax", "port")
MODS = {"jax": jpol, "port": tpol}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_service_s_equals_reference(arch):
    jcfg = jget_config(arch).reduced()
    tcfg = port_cfg(jcfg)
    jc, tc = JCost(jcfg, JProfile()), EdgeCostModel(tcfg, EdgeProfile())
    for p, m in ((1, 1), (7, 2), (64, 33), (513, 128)):
        jr = JRequest(prompt_tokens=[1] * p, max_new_tokens=m)
        tr = Request(prompt_tokens=[1] * p, max_new_tokens=m)
        assert tpol.estimate_service_s(tc, tcfg, tr) == \
            jpol.estimate_service_s(jc, jcfg, jr)


def test_ladder_edf_order_and_make_policy_equal_reference():
    rng = np.random.default_rng(0)
    depths = rng.integers(0, 10, 60)
    walks = {}
    for which in BOTH:
        m = MODS[which]
        lad = m.DegradationLadder()
        rung, walk = 0, []
        for d in depths:
            head = [None, -0.5, 2.0][int(d) % 3]
            rung = lad.rung_for(m.SLOPressure(
                queue_depth=int(d), in_flight=2, slots=2,
                min_headroom_s=head), rung)
            walk.append(rung)
        walks[which] = walk
        with pytest.raises(ValueError, match="hysteresis"):
            m.DegradationLadder(engage=(1.0,), release=(1.0,), overrides=(
                lad.overrides[0],))
        assert isinstance(m.make_policy(None), m.FIFOPolicy)
        assert isinstance(m.make_policy("edf"), m.EDFPolicy)
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            m.make_policy("lifo")
    assert walks["port"] == walks["jax"]
    assert len(set(walks["port"])) == 4                 # every rung met

    class H:
        def __init__(self, i, pr=0, dl=None, ttft=None):
            self.index, self.submit_t = i, float(i) * 0.25
            self.request = Request(prompt_tokens=[1], priority=pr,
                                   deadline_s=dl, ttft_deadline_s=ttft)

    hs = [H(0), H(1, pr=1), H(2, dl=0.5), H(3, dl=9.0), H(4, ttft=0.1),
          H(5, pr=1, dl=3.0), H(6)]
    order = [h.index for h in tpol.EDFPolicy().order(hs, 0.0)]
    assert order == [h.index for h in jpol.EDFPolicy().order(hs, 0.0)]
    assert order == [5, 1, 2, 4, 3, 0, 6]
    assert [tpol.effective_deadline(h.request) for h in hs] == \
        [jpol.effective_deadline(h.request) for h in hs]


@pytest.fixture(scope="module")
def pair():
    return Pair(low_bits=2)


def _run(pair, which, policy, reqs, faults=(), num_slots=2):
    s = pair.serve(which, faults=faults, num_slots=num_slots, slots_len=96,
                   policy=policy)
    hs = [s.submit(r) for r in reqs]
    s.drain(cancel_queued=False)
    hl = health(s)
    s.close()
    return hs, hl


def test_fifo_and_slo_free_edf_equal_default(pair):
    """The explicit FIFO policy and EDF without preemption or ladder, on
    requests with no priority or deadline, are the default session: each
    equal to the JAX session under the same policy, and to the default."""
    runs = {}
    for name in ("default", "fifo", "edf"):
        for which in BOTH:
            policy = {"default": None, "fifo": "fifo",
                      "edf": MODS[which].EDFPolicy(ladder=None)}[name]
            hs, hl = _run(pair, which, policy, script(which))
            runs[name, which] = ([outcome(h) for h in hs], hl)
        assert runs[name, "port"] == runs[name, "jax"]
    assert runs["fifo", "port"] == runs["default", "port"]
    assert runs["edf", "port"][0] == runs["default", "port"][0]
    assert runs["edf", "port"][1]["preemptions"] == 0


def test_preemption_resumes_with_same_tokens(pair):
    """Two long bulk rows fill both slots; an urgent priority request
    preempts one. The victim's final tokens equal its unpreempted run's,
    its stream concatenates to them without a repeat, and the session
    equals JAX's (tokens, preempted counts, events, health)."""
    got = {}
    for which in BOTH:
        R = request_cls(which)
        bulk = [R(prompt_tokens=list(range(1 + i, 9 + i)), max_new_tokens=16,
                  request_id=f"bulk{i}") for i in range(2)]
        base, _ = _run(pair, which, "fifo", bulk)
        s = pair.serve(which, num_slots=2, slots_len=96,
                       policy=MODS[which].EDFPolicy())
        hs = [s.submit(r) for r in bulk]
        while s.health().in_flight < 2:
            s.step()
        hs.append(s.submit(R(prompt_tokens=list(range(40, 44)),
                             max_new_tokens=2, request_id="urgent",
                             priority=5)))
        s.drain(cancel_queued=False)
        got[which] = ([outcome(h) for h in hs], [events(h) for h in hs],
                      health(s), [outcome(h)[1] for h in base])
        s.close()
    assert got["port"] == got["jax"]
    outs, evs, hl, base_tokens = got["port"]
    assert hl["preemptions"] >= 1
    assert any(o[6] > 0 for o in outs[:2])          # a row was preempted
    for o, ev, want in zip(outs[:2], evs[:2], base_tokens):
        assert o[1] == want
        assert sum((e[2] for e in ev), []) == want  # no repeats


def test_infeasible_requests_shed_typed(pair):
    """A queued request whose modeled service bound exceeds its deadline
    budget resolves with ``DeadlineExceeded(infeasible=True)`` before
    admission; its siblings serve (an injected estimate: a deadline
    against the cost model's microseconds would race the wall clock)."""
    for estimate in (lambda r: 1e9 if r.max_new_tokens > 10 else 0.0,):
        got = {}
        for which in BOTH:
            R = request_cls(which)
            pol = MODS[which].EDFPolicy(preempt_enabled=False, ladder=None,
                                        service_estimate_fn=estimate)
            reqs = [R(prompt_tokens=[1, 2], max_new_tokens=3,
                      request_id="ok", deadline_s=60.0),
                    R(prompt_tokens=[3, 4], max_new_tokens=20,
                      request_id="doomed", deadline_s=60.0),
                    R(prompt_tokens=[5, 6], max_new_tokens=3,
                      request_id="free")]
            hs, hl = _run(pair, which, pol, reqs, num_slots=1)
            got[which] = ([outcome(h) for h in hs], hl)
        assert got["port"] == got["jax"]
        outs, hl = got["port"]
        assert outs[1] == ("doomed", "DeadlineExceeded", True)
        assert hl["infeasible_shed"] == 1 and hl["deadline_shed"] == 0
        assert outs[0][1] and outs[2][1]


@pytest.mark.parametrize("rung", [0, 1, 2, 3])
def test_tokens_unchanged_at_every_rung(pair, rung):
    """The session held at one ladder rung (0 = the default ladder walking
    on queue depth): tokens equal the FIFO run's; modeled numbers (which a
    rung changes) equal JAX's at the same rung."""
    got = {}
    for which in BOTH:
        m = MODS[which]

        class Held(m.EDFPolicy):
            def rung_for(self, pressure, current):
                return rung

        pol = m.EDFPolicy() if rung == 0 else Held(preempt_enabled=False)
        hs, hl = _run(pair, which, pol, script(which))
        base, _ = _run(pair, which, "fifo", script(which))
        got[which] = ([outcome(h) for h in hs], hl,
                      [outcome(h)[1] for h in base])
    assert got["port"] == got["jax"]
    outs, hl, base_tokens = got["port"]
    assert [o[1] for o in outs] == base_tokens
    assert hl["rung_transitions"] >= (2 if rung == 0 else 1)
