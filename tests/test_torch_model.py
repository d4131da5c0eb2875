"""Port parity for the model entry points — the ROADMAP's first gate.

``decode_many_batched`` from the same params and caches (made by the JAX
package) gives the same greedy tokens, done/emitted masks and every
``DyMoEInfo`` leaf, with dead rows and ``live_cap < B``; ``prefill`` solo,
ragged, and ragged row-local (the admission wave) gives the same logits,
telemetry and caches. Wave is compared with wave and solo with solo.
Tolerances: tokens, masks, loads and cache positions exact; f32 logits,
activations and caches allclose at atol = rtol = 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import jit_run, n, numpy_init, port, port_caches, \
    port_cfg, t
from repro.configs import get_config as jget_config
from repro.models import decode_many_batched as jdecode_many_batched
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import quantize_model as jquantize_model
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.models.layers.moe import _capacity
from repro_torch.models.model import decode_many_batched, prefill

TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 6


def _moe_cfg(low_bits):
    """``tests/test_decode_many.py::_moe_cfg`` in "4/2" or "4/0"."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


def _olmoe_reduced(low_bits):
    cfg = jget_config("olmoe_1b_7b").reduced()
    return dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=low_bits))


CFGS = {"tiny-4/2": lambda: _moe_cfg(2), "tiny-4/0": lambda: _moe_cfg(0),
        "olmoe_reduced-4/2": lambda: _olmoe_reduced(2),
        "olmoe_reduced-4/0": lambda: _olmoe_reduced(0),
        # shared experts; the paper's two evaluation models
        "qwen2_moe_reduced-4/2": lambda: jget_config(
            "qwen2_moe_a2p7b").reduced(),
        "mixtral_reduced-4/2": lambda: jget_config("mixtral_8x7b").reduced(),
        "qwen3_30b_reduced-4/2": lambda: jget_config(
            "qwen3_30b_a3b").reduced()}


def _setup(name):
    cfg = CFGS[name]()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return cfg, params, qp, port_cfg(cfg), port(params), port(qp)


def _check_caches(tc, jc):
    for f in ("positions", "length", "offset"):
        np.testing.assert_array_equal(n(getattr(tc["layers"], f)),
                                      np.asarray(getattr(jc["layers"], f)),
                                      err_msg=f)
    for f in ("k", "v"):
        np.testing.assert_allclose(n(getattr(tc["layers"], f)),
                                   np.asarray(getattr(jc["layers"], f)),
                                   **TOL, err_msg=f)


def _check_info(ti, ji, exact=("critical_masks", "active_masks",
                               "expert_load", "expert_hh_load")):
    for f in ("critical_masks", "active_masks", "expert_load",
              "expert_hh_load", "gate_mean", "predicted_next",
              "token_importance", "aux_loss", "dropped_frac"):
        jv = getattr(ji, f)
        if jv is None:
            continue
        got = n(getattr(ti, f))
        if f in exact:
            np.testing.assert_array_equal(got, np.asarray(jv), err_msg=f)
        else:
            np.testing.assert_allclose(got, np.asarray(jv), **TOL, err_msg=f)


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_many_batched_matches(name):
    """Greedy chunk over 4 slots: two dead rows (so live_cap 2 < B 4),
    per-row limits that stop rows mid-chunk."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(name)
    b = 4
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (b, 10))
    logits, caches, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=qp,
        cache_slots=10 + STEPS + 1))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    done = np.array([False, True, True, False])
    kw = dict(num_steps=STEPS, n_emitted=np.ones(b, np.int32),
              limits=np.array([10, 10, 10, 4], np.int32),
              eos_tokens=np.full(b, -1, np.int32))
    tcaches = port_caches(caches)
    jt, jc, ji, jd, je = jit_run(lambda: jdecode_many_batched(
        params, cfg, jnp.asarray(tok0), caches, done=jnp.asarray(done),
        qparams=qp, live_cap=2, **{k: jnp.asarray(v) if k != "num_steps"
                                   else v for k, v in kw.items()}))
    tt, tc, ti, td, te = decode_many_batched(
        tparams, tcfg, t(tok0), tcaches, done=t(done), qparams=tqp,
        live_cap=2, **{k: t(v) if k != "num_steps" else v
                       for k, v in kw.items()})
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(te), np.asarray(je))
    assert ti.critical_masks.shape == (STEPS, cfg.num_layers, b,
                                       cfg.num_experts)
    _check_info(ti, ji)
    _check_caches(tc, jc)


@pytest.mark.parametrize("name,mode", [
    (name, mode) for name in CFGS for mode in ("solo", "ragged", "wave")
    if not (mode == "ragged" and not name.startswith("tiny"))])
def test_prefill_matches(name, mode):
    """solo: one shared Critical set (K2 path); ragged: right-aligned
    batch with one shared set (off the scheduler's path, so on the tiny
    config only); wave: ragged row-local with exact host row capacities
    (the scheduler's admission wave, K1 path)."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(name)
    rng = np.random.default_rng(2)
    if mode == "solo":
        prompt = rng.integers(1, cfg.vocab_size, (1, 13))
        jkw, tkw = {}, {}
    else:
        lens = np.array([11, 4, 7], np.int32)
        prompt = np.zeros((3, 11), np.int64)
        for i, s in enumerate(lens):
            prompt[i, 11 - s:] = rng.integers(1, cfg.vocab_size, s)
        jkw = dict(lengths=jnp.asarray(lens))
        tkw = dict(lengths=t(lens))
        if mode == "wave":
            caps = np.array([_capacity(cfg, int(s)) for s in lens], np.int32)
            jkw.update(row_local=True, row_capacities=jnp.asarray(caps))
            tkw.update(row_local=True, row_capacities=t(caps))
    jl, jc, ji = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt, jnp.int32), qparams=qp,
        cache_slots=20, **jkw))
    tl, tc, ti = prefill(tparams, tcfg, t(prompt).long(), qparams=tqp,
                         cache_slots=20, **tkw)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_info(ti, ji)
    _check_caches(tc, jc)
