"""Port parity for the non-MoE architectures end to end: every one of the
12 ``ARCH_IDS`` is served (the engine refuses none of their
``.reduced()`` configs), and on ``qwen3_0p6b`` (dense), ``zamba2_1p2b``
(Mamba2 + shared attention), ``falcon_mamba_7b`` (Mamba1) and
``musicgen_medium`` (GELU, sinusoidal positions) ``.reduced()`` the port's
engine on the CPU equals the JAX engine from the same numpy-made params:
``generate_batch`` (ragged requests over 2 slots; batched admission waves
for the dense kinds, one solo prefill per request for the SSM kinds) and
``generate``; ``generate_reference`` on the hybrid; an open session
(staggered submits, a cancel in flight) on Mamba1. Without experts the
replay is the cost model alone: no timings, cache stats or weight bytes.
Tolerance: none — tokens, modeled TTFT/TPOT and every result field are
compared with ``==``."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import numpy_init, port, port_cfg
from _torch_serving import events, outcome
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import quantize_model as jquantize_model
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.models.model import decode_step, init_decode_state, \
    init_params, prefill
from repro_torch.serving import DyMoEEngine, EngineConfig, Request

ENGINE = ["qwen3_0p6b", "zamba2_1p2b", "falcon_mamba_7b", "musicgen_medium"]
_FIELDS = ("tokens", "ttft_s", "tpot_s", "cache_stats", "prefill_timing",
           "decode_timings", "prefill_weight_bytes",
           "decode_weight_bytes_per_tok", "cancelled", "preempted")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_is_served(arch):
    """Init, quantize, prefill and one decode step of every reduced config
    (a tiny depth and vocabulary: this checks the dispatch, not numbers)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = DyMoEEngine(cfg, params, device="cpu")
    logits, caches, _ = prefill(eng.params, cfg,
                                torch.tensor([[3, 4, 5, 6]]),
                                qparams=eng.qparams, cache_slots=8)
    assert logits.shape == (1, 64) and torch.isfinite(logits).all()
    state = init_decode_state(cfg, 1, 8, "cpu")
    assert set(state) == set(caches)
    logits, _, _ = decode_step(eng.params, cfg, torch.tensor([7]), caches,
                               qparams=eng.qparams)
    assert torch.isfinite(logits).all()


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """The JAX engine and the port's of one reduced config, built once a
    module: the fixture's tests and the single-arch tests below share them
    (and the JAX engine's compiles)."""
    cfg = jget_config(arch).reduced()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return (JEngine(cfg, params, JEngineConfig(decode_chunk=4), qparams=qp),
            DyMoEEngine(port_cfg(cfg), port(params),
                        EngineConfig(decode_chunk=4), device="cpu",
                        qparams=port(qp)))


@pytest.fixture(scope="module", params=ENGINE)
def engines(request):
    return _engines(request.param)


def _requests(cls, vocab):
    """Ragged prompts of two lengths (one compile each on the JAX side),
    more requests than slots, a one-token request."""
    rng = np.random.default_rng(5)
    return [cls(prompt_tokens=[int(v) for v in rng.integers(1, vocab, s)],
                max_new_tokens=m)
            for s, m in ((7, 6), (12, 9), (7, 1), (12, 5))]


def _fields(r):
    return [dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
            for x in (getattr(r, f) for f in _FIELDS)]


def test_generate_batch_and_generate_equal_jax_engine(engines):
    jeng, teng = engines
    v = teng.cfg.vocab_size
    jout = jeng.generate_batch(_requests(JRequest, v), num_slots=2)
    tout = teng.generate_batch(_requests(Request, v), num_slots=2)
    assert [_fields(r) for r in tout] == [_fields(r) for r in jout]
    assert all(r.ttft_s > 0 and (r.tpot_s > 0) == (len(r.tokens) > 1)
               for r in tout)
    assert tout[0].cache_stats is None and tout[0].prefill_timing is None
    st = teng.last_stats
    if teng.cfg.block_kinds()[0] == "ssm":   # one solo prefill a request
        assert st["waves_batched"] == 0 and st["waves_solo"] == 4
    else:
        assert st["waves_batched"] >= 1
    req = _requests(Request, v)[1]
    jr = jeng.generate(_requests(JRequest, v)[1])
    assert _fields(teng.generate(req)) == _fields(jr)


def test_generate_reference_equals_jax_and_generate():
    """The hybrid's reference path (eager ``decode_many``: shared-site KV
    and SSM state, K2 from the tier's packed codes) against the JAX
    engine's, and the port's ``generate`` against it (TPOT to 1e-12:
    the session sums step times with Python's compensated ``sum``)."""
    jeng, teng = _engines("zamba2_1p2b")
    v = teng.cfg.vocab_size
    jr = jeng.generate_reference(_requests(JRequest, v)[1])
    ref = teng.generate_reference(_requests(Request, v)[1])
    assert _fields(ref) == _fields(jr)
    got = teng.generate(_requests(Request, v)[1])
    assert got.tokens == ref.tokens and got.ttft_s == ref.ttft_s
    assert got.tpot_s == pytest.approx(ref.tpot_s, rel=1e-12)


def test_open_session_on_ssm_arch_equals_jax():
    """Mamba1 in an open session: three submits on 2 slots, a step, a
    cancel of an in-flight request, a late submit, drain. Outcomes and
    stream events equal the JAX session's (``pipeline=False``)."""
    jeng, teng = _engines("falcon_mamba_7b")
    v = teng.cfg.vocab_size

    def run(eng, cls, **kw):
        s = eng.serve(num_slots=2, slots_len=64, **kw)
        reqs = [dataclasses.replace(r, request_id=f"r{i}")
                for i, r in enumerate(_requests(cls, v))]
        hs = [s.submit(r) for r in reqs[:3]]
        s.step()
        hs[1].cancel()
        s.step()
        hs.append(s.submit(reqs[3]))
        s.drain(cancel_queued=False)
        s.close()
        return [outcome(h) for h in hs], [events(h) for h in hs]

    want = run(jeng, JRequest, pipeline=False)
    got = run(teng, Request)
    assert got == want
    assert got[0][1][0] == "r1" and got[0][1][4]     # cancelled in flight
