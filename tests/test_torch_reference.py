"""Port parity for the single-sequence reference path, on the tiny MoE of
``tests/test_decode_many.py::_moe_cfg`` ("4/2" and "4/0") from
numpy-made params: ``decode_step(per_row_moe=False)`` (one batch-mean
Critical set a layer, experts through ``moe_apply`` — K2 on the card)
gives the JAX package's logits, masks and caches; ``decode_many`` its
tokens, greedy and sampled; the engine's ``generate_reference`` the JAX
engine's tokens and modeled numbers; and the port's ``generate`` (a
one-slot session) its own ``generate_reference``'s. (These sit beside
``tests/test_torch_model.py``, whose model cases already take most of a
file's time budget.) Tolerances: tokens, masks, cache positions and
modeled numbers exact (but see ``test_generate_equals_generate_reference``);
f32 logits, gates and caches allclose at atol = rtol = 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import jit_run, n, port_caches, t
from _torch_serving import plain
from repro.models import prefill as jprefill
from repro.models.model import decode_many as jdecode_many
from repro.models.model import decode_step as jdecode_step
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.model import decode_many, decode_step
from repro_torch.serving import DyMoEEngine, EngineConfig, Request
from repro_torch.serving.sampler import PRNGKey
from test_torch_model import STEPS, TOL, _check_caches, _check_info, \
    _setup

NAMES = ["tiny-4/2", "tiny-4/0"]


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_shared_critical_matches(name):
    """Three rows: each layer's Critical set from the batch-mean gate."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(name)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, (3, 9))
    logits, caches, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=qp, cache_slots=12))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    tcaches = port_caches(caches)
    jl, jc, ji = jit_run(lambda: jdecode_step(
        params, cfg, jnp.asarray(tok0), caches, qparams=qp))
    tl, tc, ti = decode_step(tparams, tcfg, t(tok0), tcaches, qparams=tqp)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    assert ti.critical_masks.shape == (cfg.num_layers, cfg.num_experts)
    _check_info(ti, ji)
    _check_caches(tc, jc)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_decode_many_matches(name, sampled):
    """One sequence, ``STEPS`` steps from ``start_step`` 3: sampled step i
    draws with ``fold_in(key, 3 + i)`` (temperature 0.8, top_k 5)."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(name)
    prompt = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 11))
    logits, caches, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=qp,
        cache_slots=11 + STEPS))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    kw = dict(rng_key=jax.random.PRNGKey(7), temperature=0.8, top_k=5) \
        if sampled else {}
    tkw = dict(kw, rng_key=PRNGKey(7)) if sampled else {}
    tcaches = port_caches(caches)
    jt, jc, ji = jit_run(lambda: jdecode_many(
        params, cfg, jnp.asarray(tok0), caches, num_steps=STEPS,
        start_step=3, qparams=qp, **kw))
    tt, tc, ti = decode_many(tparams, tcfg, t(tok0), tcaches,
                             num_steps=STEPS, start_step=3, qparams=tqp,
                             **tkw)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    assert ti.critical_masks.shape == (STEPS, cfg.num_layers,
                                       cfg.num_experts)
    _check_info(ti, ji)
    _check_caches(tc, jc)


_MODELED = ("ttft_s", "cache_stats", "prefill_weight_bytes",
            "decode_weight_bytes_per_tok", "prefill_timing",
            "decode_timings")


@pytest.fixture(scope="module", params=NAMES)
def engines(request):
    cfg, params, qp, tcfg, tparams, tqp = _setup(request.param)
    return (JEngine(cfg, params, JEngineConfig(decode_chunk=4)),
            DyMoEEngine(tcfg, tparams, EngineConfig(decode_chunk=4),
                        device="cpu", qparams=tqp))


def _requests(cls, rng, eos=None):
    """A greedy request and a seeded sampled one (temperature 0.8, top_k
    5), 9 new tokens each; ``eos`` gives the sampled one a stop token."""
    return [cls(prompt_tokens=[int(v) for v in rng.integers(1, 256, 9)],
                max_new_tokens=9),
            cls(prompt_tokens=[int(v) for v in rng.integers(1, 256, 12)],
                max_new_tokens=9, temperature=0.8, top_k=5, seed=3,
                eos_token=eos)]


def test_generate_reference_equals_jax(engines):
    """Greedy, sampled, and sampled stopping at its own 4th token."""
    jeng, teng = engines
    jreqs = _requests(JRequest, np.random.default_rng(6))
    jout = [jeng.generate_reference(r) for r in jreqs]
    eos = jout[1].tokens[3]
    jreqs.append(dataclasses.replace(jreqs[1], eos_token=eos))
    jout.append(jeng.generate_reference(jreqs[2]))
    assert len(jout[2].tokens) <= 4
    treqs = _requests(Request, np.random.default_rng(6))
    treqs.append(dataclasses.replace(treqs[1], eos_token=eos))
    for tr, jr in zip([teng.generate_reference(r) for r in treqs], jout):
        assert tr.tokens == jr.tokens
        assert tr.tpot_s == jr.tpot_s
        for f in _MODELED:
            assert plain(getattr(tr, f)) == plain(getattr(jr, f)), f


def test_generate_equals_generate_reference(engines):
    """The port's ``generate`` (a one-slot session) against its own
    ``generate_reference``: tokens, TTFT, cache stats, weight bytes and
    every step's timing exact; TPOT to 1e-12 relative, because the session
    averages the step times with Python's ``sum`` (compensated since 3.12)
    and the reference path adds them one by one — the JAX engine's pair
    differs in the same last bit."""
    _, teng = engines
    for req in _requests(Request, np.random.default_rng(6)):
        ref, got = teng.generate_reference(req), teng.generate(req)
        assert got.tokens == ref.tokens and len(got.tokens) == 9
        assert got.tpot_s == pytest.approx(ref.tpot_s, rel=1e-12)
        for f in _MODELED:
            assert plain(getattr(got, f)) == plain(getattr(ref, f)), f
