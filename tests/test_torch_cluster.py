"""The port's multi-replica tier (``repro_torch.serving.cluster``), ported
from ``tests/test_cluster.py`` without its mesh tests, on the CPU, on the
tiny MoE of ``tests/_torch_serving.py`` (2 layers, d_model 64, 4 experts
top-2) from numpy-made params, with short requests: the tier is host code
over the session, so its cases need few device steps.

  * tokens: every request's equal the solo engine's, for 1, 2 and 4
    replicas, in order and shuffled, greedy and sampled; under driver
    threads; with concurrent submitters;
  * a 1-replica cluster equals a plain session (tokens and modeled
    numbers); a routed subsequence equals a standalone session serving
    it, and equals the JAX package's router (``pipeline=False``) request
    for request, placements included;
  * ``QueueFull`` reroutes before it surfaces; stream and cancel are
    sticky; merged health; a replay fault drains and cold-restarts its
    replica, sync and threaded, every handle resolving.

The routers here run the session's default, the pipelined replay (the
JAX router of the parity case replays inline: the modeled numbers are the
same either way); ``tests/test_torch_pipeline.py`` holds a pipelined
router to the JAX package's pipelined one.

Tolerance: none — tokens and modeled numbers are compared with ``==``.
"""
import random
import threading
import time

import jax
import pytest

from _torch_bridge import numpy_init, port, port_cfg
from _torch_serving import tiny_cfg
from repro.models import init_params as jinit_params
from repro.serving import ClusterRouter as JRouter
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeProfile as JProfile
from repro_torch.serving import ClusterRouter, ContinuousBatchingScheduler, \
    DyMoEEngine, EdgeProfile, EngineConfig, FaultInjector, FaultSpec, \
    QueueFull, Request, SamplingParams, ServingError

SLOTS_LEN = 64


@pytest.fixture(scope="module")
def model():
    cfg = tiny_cfg()
    return cfg, numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))


def _engine(model):
    cfg, params = model
    return DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
        profile=EdgeProfile().with_vram(12), decode_chunk=4), device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    return _engine(model)


def req(i, n_prompt=8, max_new=5, cls=Request, **kw):
    kw.setdefault("request_id", f"req-{i}")
    return cls(prompt_tokens=list(range(1 + i, n_prompt + 1 + i)),
               max_new_tokens=max_new, **kw)


def sampled_req(i, **kw):
    return req(i, sampling=SamplingParams(temperature=0.7, top_k=8,
                                          seed=100 + i), **kw)


_SOLO = {}


def solo(engine, i, sampled=False, **kw):
    """The solo engine's tokens for request i (memoized per module)."""
    key = (i, sampled, tuple(sorted(kw.items())))
    if key not in _SOLO:
        r = sampled_req(i, **kw) if sampled else req(i, **kw)
        _SOLO[key] = engine.generate(r).tokens
    return _SOLO[key]


# ------------------------------------------------------------ parity gates


@pytest.mark.parametrize("n_replicas,shuffle_seed",
                         [(1, None), (2, 7), (4, None), (4, 7)])
def test_token_parity_vs_solo_any_replica_count(engine, n_replicas,
                                                shuffle_seed):
    """Greedy and sampled requests, any replica count, shuffled order."""
    reqs = {i: (sampled_req(i) if i % 3 == 2 else req(i))
            for i in range(8)}
    want = {i: solo(engine, i, i % 3 == 2) for i in reqs}
    order = list(reqs)
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(order)
    with ClusterRouter.replicate(engine, n_replicas, num_slots=2,
                                 slots_len=SLOTS_LEN) as router:
        handles = {i: router.submit(reqs[i]) for i in order}
        results = {i: h.result() for i, h in handles.items()}
    assert {i: r.tokens for i, r in results.items()} == want
    assert all(r.ttft_s > 0 and r.tpot_s > 0 for r in results.values())


def test_single_replica_cluster_is_a_plain_session(engine):
    reqs = [req(i, max_new=4 + (i % 3)) for i in range(5)]
    base = ContinuousBatchingScheduler(engine, num_slots=2)
    base._ensure_started(slots_len=SLOTS_LEN)
    want = [h.result() for h in [base.submit(r) for r in reqs]]
    base.close()
    with ClusterRouter.replicate(engine, 1, num_slots=2,
                                 slots_len=SLOTS_LEN) as router:
        got = [h.result() for h in [router.submit(r) for r in reqs]]
    for g, w in zip(got, want):
        assert (g.tokens, g.ttft_s, g.tpot_s) == (w.tokens, w.ttft_s,
                                                  w.tpot_s)


def test_routed_subsequence_matches_standalone_and_jax(model, engine):
    """Each replica's routed subsequence reproduces a standalone session
    serving exactly those requests, modeled numbers included; and the
    whole routed run equals the JAX package's router (``pipeline=False``,
    its inline replay) from the same params: placements, tokens, modeled
    TTFT and TPOT."""
    reqs = [req(i, max_new=4 + (i % 4)) for i in range(8)]
    with ClusterRouter.replicate(engine, 2, num_slots=2,
                                 slots_len=SLOTS_LEN) as router:
        handles = [router.submit(r) for r in reqs]
        results = [h.result() for h in handles]
        placements = [h.replica for h in handles]
    assert set(placements) == {0, 1}
    for ridx in range(2):
        sub = [i for i, p in enumerate(placements) if p == ridx]
        ref = ContinuousBatchingScheduler(engine, num_slots=2)
        ref._ensure_started(slots_len=SLOTS_LEN)
        want = [h.result() for h in [ref.submit(reqs[i]) for i in sub]]
        ref.close()
        for i, w in zip(sub, want):
            got = results[i]
            assert (got.tokens, got.ttft_s, got.tpot_s) == \
                (w.tokens, w.ttft_s, w.tpot_s), (ridx, i)

    cfg, params = model
    jeng = JEngine(cfg, params, JEngineConfig(
        profile=JProfile().with_vram(12), decode_chunk=4))
    with JRouter.replicate(jeng, 2, num_slots=2, slots_len=SLOTS_LEN,
                           pipeline=False) as jrouter:
        jhandles = [jrouter.submit(req(i, max_new=4 + (i % 4), cls=JRequest))
                    for i in range(8)]
        jresults = [h.result() for h in jhandles]
    assert [h.replica for h in jhandles] == placements
    assert [(r.tokens, r.ttft_s, r.tpot_s) for r in results] == \
        [(r.tokens, r.ttft_s, r.tpot_s) for r in jresults]


def test_threaded_drivers_token_parity(engine):
    """One driver thread per replica: their device work serializes on the
    engine's lock; tokens equal solo and the counters add up."""
    reqs = [req(i) for i in range(8)]
    want = [solo(engine, i) for i in range(8)]
    router = ClusterRouter.replicate(engine, 2, num_slots=2,
                                     slots_len=SLOTS_LEN, threaded=True)
    try:
        results = [h.result() for h in [router.submit(r) for r in reqs]]
        health = router.health()
    finally:
        router.close()
    assert [r.tokens for r in results] == want
    assert health.submitted == 8 and health.completed == 8


def test_threaded_concurrent_submitters(engine):
    want = {i: solo(engine, i) for i in range(12)}
    router = ClusterRouter.replicate(engine, 3, num_slots=2,
                                     slots_len=SLOTS_LEN, threaded=True)
    out, errs = {}, []

    def client(i):
        try:
            out[i] = router.submit(req(i)).result().tokens
        except Exception as e:  # noqa: BLE001 — surfaced in the assert
            errs.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        router.close()
    assert not errs
    assert out == want


# ------------------------------------------------- placement + backpressure


def test_least_loaded_placement_round_robins_an_idle_pool(engine):
    with ClusterRouter.replicate(engine, 3, num_slots=1,
                                 slots_len=SLOTS_LEN) as router:
        handles = [router.submit(req(i)) for i in range(6)]
        assert [h.replica for h in handles] == [0, 1, 2, 0, 1, 2]
        for h in handles:
            h.result()


def test_queue_full_reroutes_before_surfacing(engine):
    with ClusterRouter.replicate(engine, 2, num_slots=1,
                                 slots_len=SLOTS_LEN, max_queue=1,
                                 placement="round_robin") as router:
        direct = router.replicas[0].submit(req(0))
        rerouted = router.submit(req(1))
        assert rerouted.replica == 1            # skipped the full replica
        assert router.health().reroutes == 1
        n_before = len(router._handles)
        with pytest.raises(QueueFull):
            router.submit(req(99))
        assert len(router._handles) == n_before
        health = router.health()
        got = rerouted.result()
    assert health.merged.queue_rejections >= 3  # 1 rerouted + 2 surfaced
    assert got.tokens == solo(engine, 1)
    assert direct.result(drive=False).tokens == solo(engine, 0)


def test_stream_and_cancel_are_sticky(engine):
    with ClusterRouter.replicate(engine, 2, num_slots=1,
                                 slots_len=SLOTS_LEN) as router:
        long = router.submit(req(0, max_new=24))
        short = router.submit(req(1, max_new=4))
        assert (long.replica, short.replica) == (0, 1)
        streamed = []
        for ev in short.stream():
            streamed.extend(ev.tokens)
        assert streamed == short.result().tokens
        for _ in range(2):
            router.step()
        long.cancel()
        r = long.result()
    assert r.cancelled and 0 < len(r.tokens) < 24
    assert short.result().tokens == solo(engine, 1, max_new=4)


# ------------------------------------------------------- health aggregation


def test_cluster_health_merges_counters(engine):
    with ClusterRouter.replicate(engine, 2, num_slots=1,
                                 slots_len=SLOTS_LEN) as router:
        handles = [router.submit(req(i)) for i in range(4)]
        for h in handles:
            h.result()
        health = router.health()
    assert health.status == "ok"
    assert len(health.replicas) == 2
    assert health.submitted == 4 and health.completed == 4
    assert [s.submitted for s in health.replicas] == [2, 2]
    assert health.merged.submitted == sum(
        s.submitted for s in health.replicas)
    assert router.health().status == "closed"


# ------------------------------------------------ replica fault + restart


def test_replica_fault_drains_and_cold_restarts(model, engine):
    """One replica's chunk replay faults: its session degrades, is
    quarantined, drained and cold-restarted while the other keeps
    serving; every handle resolves, results keep solo tokens, and the
    restarted replica takes new traffic. The replica's health stays
    lifetime-monotonic across the restart."""
    faulty = FaultInjector([FaultSpec(site="replay.chunk", at=1)])
    fresh = _engine(model)   # the fault's engine: no other test's state
    router = ClusterRouter.replicate(fresh, 2, num_slots=1,
                                     slots_len=SLOTS_LEN,
                                     faults=[None, faulty])
    try:
        first = [router.submit(req(i)) for i in range(6)]
        results1 = {}
        for h in first:
            try:
                results1[int(h.request_id[4:])] = h.result()
            except ServingError:
                pass
        assert all(h.done for h in first)
        assert len(results1) < 6            # the fault failed some
        assert router.health().restarts >= 1
        for i, r in results1.items():
            assert r.tokens == solo(engine, i), i
        second = [router.submit(req(6 + i)) for i in range(4)]
        results = [h.result() for h in second]
        placements = {h.replica for h in second}
        health = router.health()
    finally:
        router.close()
    assert 1 in placements                  # rejoined the pool
    assert [r.tokens for r in results] == [solo(engine, 6 + i)
                                           for i in range(4)]
    assert health.status == "ok"
    assert health.merged.replay_faults >= 1
    assert health.submitted == 10 and health.completed == 10


def test_threaded_replica_fault_recovers(model, engine):
    """The same fault under driver threads: the owning driver drains and
    restarts its replica; every handle resolves, and those that resolved
    with a result keep solo tokens."""
    faulty = FaultInjector([FaultSpec(site="replay.chunk", at=1)])
    router = ClusterRouter.replicate(_engine(model), 2, num_slots=1,
                                     slots_len=SLOTS_LEN,
                                     faults=[None, faulty], threaded=True)
    try:
        handles = [router.submit(req(i)) for i in range(8)]
        done = {}
        for i, h in enumerate(handles):
            try:
                done[i] = h.result()
            except ServingError:
                pass
        assert all(h.done for h in handles)
        assert done and len(done) < 8
        for _ in range(500):                # the driver restarts it idle
            if router.health().restarts:
                break
            time.sleep(0.01)
        assert router.health().restarts == 1
    finally:
        router.close()
    for i, r in done.items():
        assert r.tokens == solo(engine, i), i
