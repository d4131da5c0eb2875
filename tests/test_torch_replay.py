"""Port parity for the serving path's system half: the edge cost model,
the mixed-precision LRU cache and the orchestrator give the JAX package's
numbers exactly on the same numpy telemetry (every ablation flag, "4/2"
and "4/0", a ``DegradeOverride``); ``generate_batch`` on the tiny MoE
gives the JAX engine's modeled TTFT/TPOT, cache stats and weight bytes
exactly; and the scheduler replays once per admission wave and per decode
chunk, inline. Tolerance: none — every number is compared with
``==``, because the replay is the same host arithmetic on equal inputs."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_bridge import numpy_init, port, port_cfg
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.core.orchestrator import DegradeOverride as JDegrade
from repro.core.orchestrator import DynamicExpertOrchestrator as JOrch
from repro.core.orchestrator import OrchestratorConfig as JOrchConfig
from repro.models import init_params as jinit_params
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeCostModel as JCost
from repro.serving.cost_model import EdgeProfile as JProfile
from repro.serving.cost_model import expert_bytes as jexpert_bytes
from repro_torch.core.orchestrator import DegradeOverride, \
    DynamicExpertOrchestrator, OrchestratorConfig
from repro_torch.serving import DyMoEEngine, EngineConfig, Request
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile, \
    expert_bytes


def _plain(x):
    """StepTiming / LayerTiming (or lists of them) as plain dicts: the two
    packages' dataclasses are different classes, so compare their fields."""
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_model_equals_reference(arch):
    jcfg = jget_config(arch).reduced()
    tcfg = port_cfg(jcfg)
    jc, tc = JCost(jcfg, JProfile()), EdgeCostModel(tcfg, EdgeProfile())
    for bits in (2, 4, 8, 16):
        assert expert_bytes(tcfg, bits) == jexpert_bytes(jcfg, bits)
    rng = np.random.default_rng(0)
    n_hi = rng.integers(0, 8, (5, tcfg.num_layers))
    n_lo = rng.integers(0, 8, (5, tcfg.num_layers))
    s_ctx = rng.integers(1, 4096, (5, 1))
    assert np.array_equal(tc.moe_weight_bytes(n_hi, n_lo),
                          jc.moe_weight_bytes(n_hi, n_lo))
    assert tc.dual_dispatch_weight_bytes() == jc.dual_dispatch_weight_bytes()
    for phase, s_q in (("decode", 1), ("prefill", 37)):
        kw = dict(phase=phase, s_ctx=s_ctx, s_q=s_q, active_experts_hi=n_hi,
                  active_experts_lo=n_lo, tokens_routed=s_q)
        got, want = tc.layer_compute_s(**kw), jc.layer_compute_s(**kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tc.layer_compute_s(phase=phase, s_ctx=513, s_q=s_q) == \
            jc.layer_compute_s(phase=phase, s_ctx=513, s_q=s_q)
    assert tc.nonexpert_overlap_window_s(s_ctx=300, s_q=1) == \
        jc.nonexpert_overlap_window_s(s_ctx=300, s_q=1)


_ABLATIONS = {
    "default": {}, "no-cache": dict(enable_cache=False),
    "no-prefetch": dict(enable_prefetch=False),
    "no-dyquant": dict(enable_dyquant=False),
}


def _telemetry(seed, t=24, l=4, e=16):
    """Random (T, L, E) Critical / active masks and look-ahead predictions,
    with some all-zero prediction rows (must prefetch nothing) and ties."""
    rng = np.random.default_rng(seed)
    active = rng.random((t, l, e)) < 0.4
    crit = active & (rng.random((t, l, e)) < 0.5)
    pred = np.round(rng.random((t, l, e)) * 4) / 4 * (rng.random((t, l, e))
                                                      < 0.6)
    pred[3] = 0.0
    pred[:, -1] = 0.0
    compute = rng.random((t, l)) * 1e-3
    return crit, active, pred.astype(np.float32), compute


@pytest.mark.parametrize("low", ["4/2", "4/0"])
@pytest.mark.parametrize("ablation", list(_ABLATIONS))
def test_orchestrator_replay_equals_reference(ablation, low):
    kw = dict(num_layers=4, num_experts=16, experts_per_token=2,
              bytes_high=1000, bytes_low=0 if low == "4/0" else 400,
              # room for ~1.5 layers' experts: evictions and promotions
              vram_budget_bytes=24_000, pcie_bw=1e6,
              low_is_skip=low == "4/0", prefetch_topk=3,
              **_ABLATIONS[ablation])
    jo, to = JOrch(JOrchConfig(**kw)), DynamicExpertOrchestrator(
        OrchestratorConfig(**kw))
    for seed in range(3):
        crit, active, pred, compute = _telemetry(seed)
        got = to.step_batch(crit, active, pred, compute)
        want = jo.step_batch(crit, active, pred, compute)
        assert _plain(got) == _plain(want)
        assert dataclasses.asdict(to.cache.stats) == \
            dataclasses.asdict(jo.cache.stats)
        # the scalar walk, one step at a time, on the same shared state
        for t in range(2):
            assert _plain(to.step(crit[t], active[t], pred[t], compute[t])) \
                == _plain(jo.step(crit[t], active[t], pred[t], compute[t]))
        assert dataclasses.asdict(to.cache.stats) == \
            dataclasses.asdict(jo.cache.stats)
    assert (to._now, to._dma_tail) == (jo._now, jo._dma_tail)
    stats = dataclasses.asdict(to.cache.stats)
    assert stats["misses"] and stats["hits"]
    if ablation != "no-prefetch":
        assert stats["prefetch_bytes"]


@pytest.mark.parametrize("override", [
    dict(critical_keep=0.5), dict(prefetch_topk=0),
    dict(critical_keep=0.34, prefetch_topk=1, force_skip=True)])
def test_orchestrator_degrade_override_equals_reference(override):
    kw = dict(num_layers=4, num_experts=16, experts_per_token=2,
              bytes_high=1000, bytes_low=400, vram_budget_bytes=24_000,
              pcie_bw=1e6, prefetch_topk=3)
    jo, to = JOrch(JOrchConfig(**kw)), DynamicExpertOrchestrator(
        OrchestratorConfig(**kw))
    jo.set_degrade(JDegrade(**override))
    to.set_degrade(DegradeOverride(**override))
    crit, active, pred, compute = _telemetry(7)
    assert _plain(to.step_batch(crit, active, pred, compute)) == \
        _plain(jo.step_batch(crit, active, pred, compute))
    assert dataclasses.asdict(to.cache.stats) == \
        dataclasses.asdict(jo.cache.stats)
    got, want = to.degrade.apply(crit, active), jo.degrade.apply(crit, active)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _moe_cfg(low_bits):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


def _recording(engine, log):
    """Wrap ``engine._replay`` to log each call's telemetry (in call
    order) before replaying it."""
    inner = engine._replay

    def rec(crit, active, pred, **kw):
        log.append((kw["phase"], np.asarray(crit, bool),
                    np.asarray(active, bool), np.asarray(pred)))
        return inner(crit, active, pred, **kw)

    engine._replay = rec


_FIELDS = ("ttft_s", "tpot_s", "cache_stats", "prefill_timing",
           "decode_timings", "prefill_weight_bytes",
           "decode_weight_bytes_per_tok")


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
def test_generate_batch_modeled_numbers_equal_jax_engine(low_bits):
    """Ragged requests over 2 slots (batched and solo waves, eviction and
    admission mid-run) and a small expert cache (evictions): the replay's
    inputs first — Critical / active masks equal and the prefetch order
    (``argsort(-pred)``, its top ``prefetch_topk``) equal — then every
    modeled field."""
    cfg = _moe_cfg(low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (12, 9), (3, 1), (9, 4), (12, 6)]
    prompts = [[int(v) for v in rng.integers(1, cfg.vocab_size, s)]
               for s, _ in shapes]
    # 8 high-bit expert blobs of this config: the LRU must evict
    vram = 8 * jexpert_bytes(cfg, 4) * 10 // 6
    jeng = JEngine(cfg, params, JEngineConfig(
        decode_chunk=4, profile=JProfile().with_vram(1), max_cache_fraction=
        vram / (1 << 30)))
    jlog = []
    _recording(jeng, jlog)
    jout = jeng.generate_batch([JRequest(prompt_tokens=p, max_new_tokens=m)
                                for p, (_, m) in zip(prompts, shapes)],
                               num_slots=2)
    eng = DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
        decode_chunk=4, profile=EdgeProfile().with_vram(1),
        max_cache_fraction=vram / (1 << 30)), device="cpu")
    tlog = []
    _recording(eng, tlog)
    tout = eng.generate_batch([Request(prompt_tokens=p, max_new_tokens=m)
                               for p, (_, m) in zip(prompts, shapes)],
                              num_slots=2)
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert len(tlog) == len(jlog)
    topk = cfg.dymoe.prefetch_topk
    for (tp, tc, ta, tpred), (jp, jc, ja, jpred) in zip(tlog, jlog):
        assert tp == jp
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(
            np.argsort(-tpred.astype(float), axis=-1)[..., :topk],
            np.argsort(-jpred.astype(float), axis=-1)[..., :topk])
        np.testing.assert_array_equal(tpred > 0, jpred > 0)
    for tr, jr in zip(tout, jout):
        for f in _FIELDS:
            assert _plain(getattr(tr, f)) == _plain(getattr(jr, f)), f
    assert tout[0].cache_stats["evictions"] > 0
    assert all(np.isfinite(r.ttft_s) and r.ttft_s > 0 for r in tout)
    assert eng.last_stats["replay_jobs"] >= len(shapes)


def test_replay_runs_once_per_wave_and_chunk():
    """The scheduler replays each admission wave's and each decode chunk's
    telemetry once, inline; a result's clocks stop at the sync that
    fetched its last token, and its decode clock starts at the one that
    fetched its first."""
    cfg = port_cfg(_moe_cfg(2))
    params = port(numpy_init(lambda: jinit_params(_moe_cfg(2),
                                                  jax.random.PRNGKey(0))))
    eng = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=3),
                      device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, s)], max_new_tokens=m)
        for s, m in ((5, 7), (9, 1), (4, 10), (6, 3))]
    out = eng.generate_batch(reqs, num_slots=2)
    st = eng.last_stats
    assert st["replay_jobs"] == \
        st["waves_batched"] + st["waves_solo"] + st["chunks"]
    assert st["replay_s"] > 0
    for r, q in zip(out, reqs):
        assert len(r.tokens) == q.max_new_tokens
        assert 0 <= r.decode_wall_s <= r.wall_s
        assert (r.decode_timings is None) == (q.max_new_tokens == 1)
