"""Port parity for full-precision serving, DyMoE off.

* ``DyMoEPolicy(enabled=False)`` with ``qparams`` given: ``prefill`` and
  ``decode_step`` run the float weights, as the JAX package's do
  (``dymoe_on = qparams is not None and cfg.dymoe.enabled``), on the tiny
  MoE (solo, ragged row-local wave, shared and per-row decode), the
  reduced qwen3_0p6b (dense) and the reduced falcon_mamba_7b (Mamba1).
* ``EngineConfig(use_dymoe=False)``: ``generate_batch`` and an open
  session equal the JAX engine's, tokens and modeled TTFT/TPOT.
* ``generate_batch(static=True)``, the lockstep baseline: rows equal the
  JAX engine's static rows, "4/2" and off, greedy and sampled; off, each
  row also equals the port's own ``generate_reference`` (the reference's
  contract in the row-independent full-precision regime).

Tolerances: tokens, masks, loads and cache positions exact; f32 logits,
gates and caches allclose at atol = rtol = 1e-5; modeled numbers ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import jit_run, n, numpy_init, port, port_caches, \
    port_cfg, t
from _torch_serving import outcome
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import quantize_model as jquantize_model
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.models.layers.moe import _capacity
from repro.models.model import decode_step as jdecode_step
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.kv_cache import cache_tensors
from repro_torch.models.model import decode_step, prefill
from repro_torch.serving import DyMoEEngine, EngineConfig, Request

TOL = dict(atol=1e-5, rtol=1e-5)


def _tiny(low_bits=2, enabled=True):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75,
                          enabled=enabled))


def _disabled(cfg):
    return dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, enabled=False))


CFGS = {"tiny_moe": lambda: _disabled(_tiny()),
        "qwen3_0p6b": lambda: _disabled(jget_config("qwen3_0p6b").reduced()),
        "falcon_mamba_7b": lambda: _disabled(
            jget_config("falcon_mamba_7b").reduced())}


def _check_caches(tc, jc):
    assert set(tc) == set(jc)
    for part in jc:
        for f, x in cache_tensors(tc[part]):
            got = n(x)
            want = np.asarray(getattr(jc[part], f))
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, **TOL, err_msg=f)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)


def _check_info(ti, ji):
    for f in ("critical_masks", "active_masks", "expert_load",
              "expert_hh_load", "gate_mean", "predicted_next",
              "token_importance", "aux_loss", "dropped_frac"):
        jv = getattr(ji, f)
        assert (getattr(ti, f) is None) == (jv is None), f
        if jv is None:
            continue
        got, want = n(getattr(ti, f)), np.asarray(jv)
        if want.dtype == bool or f in ("expert_load", "expert_hh_load"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=f)


@pytest.mark.parametrize("name", list(CFGS))
def test_disabled_policy_runs_full_precision(name):
    """``enabled=False`` with a packed store given: solo prefill of 3 rows
    and a decode step equal the JAX package's full-precision ones (and,
    on the MoE, the per-row decode and the ragged row-local wave, whose
    telemetry reports every expert Critical and no heavy hitters). The
    parent tree ran the packed store here, so its logits differed."""
    cfg = CFGS[name]()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    tcfg, tparams, tqp = port_cfg(cfg), port(params), port(qp)
    moe = cfg.is_moe
    b, s = 3, 9
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (b, s))
    lens = np.array([9, 4, 6], np.int32)
    wave = np.zeros((b, s), np.int64)
    for i, m in enumerate(lens):
        wave[i, s - m:] = prompt[i, :m]
    caps = np.array([_capacity(cfg, int(m)) for m in lens], np.int32) \
        if moe else None

    def jax_side():
        out = {"solo": jprefill(params, cfg, jnp.asarray(prompt, jnp.int32),
                                qparams=qp, cache_slots=s + 2)}
        tok0 = jnp.argmax(out["solo"][0], axis=-1).astype(jnp.int32)
        out["step"] = jdecode_step(params, cfg, tok0, out["solo"][1],
                                   qparams=qp)
        if moe:
            out["rows"] = jdecode_step(
                params, cfg, tok0, out["solo"][1], qparams=qp,
                per_row_moe=True, live_rows=jnp.asarray([True, False, True]))
            out["wave"] = jprefill(
                params, cfg, jnp.asarray(wave, jnp.int32), qparams=qp,
                cache_slots=s + 2, lengths=jnp.asarray(lens), row_local=True,
                row_capacities=jnp.asarray(caps))
        return out

    want = jit_run(jax_side)
    tl, tc, ti = prefill(tparams, tcfg, t(prompt).long(), qparams=tqp,
                         cache_slots=s + 2)
    jl, jc, ji = want["solo"]
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_caches(tc, jc)
    _check_info(ti, ji)
    tok0 = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    assert n(tl.argmax(-1)).tolist() == tok0.tolist()
    if moe:   # every expert Critical, no heavy hitters
        assert bool(ti.critical_masks.all())
        assert not bool(ti.expert_hh_load.any())

    steps = [("step", {})]
    if moe:
        steps.append(("rows", dict(per_row_moe=True,
                                   live_rows=t(np.array([True, False,
                                                         True])))))
    for key, kw in steps:
        caches = port_caches(jc)
        sl, sc, si = decode_step(tparams, tcfg, t(tok0), caches,
                                 qparams=tqp, **kw)
        jsl, jsc, jsi = want[key]
        np.testing.assert_allclose(n(sl), np.asarray(jsl), **TOL,
                                   err_msg=key)
        assert n(sl.argmax(-1)).tolist() == \
            np.asarray(jnp.argmax(jsl, -1)).tolist()
        _check_caches(sc, jsc)
        _check_info(si, jsi)
    if moe:
        wl, wc, wi = prefill(tparams, tcfg, t(wave).long(), qparams=tqp,
                             cache_slots=s + 2, lengths=t(lens),
                             row_local=True, row_capacities=t(caps))
        jwl, jwc, jwi = want["wave"]
        np.testing.assert_allclose(n(wl), np.asarray(jwl), **TOL)
        _check_caches(wc, jwc)
        _check_info(wi, jwi)
        assert wi.critical_masks.shape == (cfg.num_layers, b,
                                           cfg.num_experts)


# ------------------------------------------------------------- the engine

_FIELDS = ("tokens", "ttft_s", "tpot_s", "cache_stats",
           "prefill_weight_bytes", "decode_weight_bytes_per_tok")


@pytest.fixture(scope="module")
def params():
    cfg = _tiny()
    return numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))


def _engines(params, low_bits=2, use_dymoe=True):
    cfg = _tiny(low_bits, enabled=use_dymoe)
    return (JEngine(cfg, params, JEngineConfig(use_dymoe=use_dymoe,
                                               decode_chunk=4)),
            DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
                use_dymoe=use_dymoe, decode_chunk=4), device="cpu"))


@pytest.fixture(scope="module")
def off_engines(params):
    return _engines(params, use_dymoe=False)


def _requests(cls, sampled=False):
    """Ragged prompts of two lengths (few JAX compiles), more requests
    than slots, a one-token request; ``sampled`` makes every other request
    a seeded sampled one."""
    rng = np.random.default_rng(5)
    out = []
    for i, (s, m) in enumerate(((7, 6), (12, 9), (7, 1), (12, 5))):
        kw = dict(temperature=0.8, top_k=5, seed=10 + i) \
            if sampled and i % 2 else {}
        out.append(cls(prompt_tokens=[int(v) for v in
                                      rng.integers(1, 256, s)],
                       max_new_tokens=m, **kw))
    return out


def test_use_dymoe_false_serves_like_jax(off_engines):
    """``generate_batch`` over 2 slots (batched waves) and an open session
    with a submit between steps: tokens and every modeled field equal the
    JAX engine's; no packed store exists on either side. (Sampled rows at
    full precision: ``test_static_batch_equals_jax[off]``.)"""
    jeng, teng = off_engines
    assert teng.qparams is None and jeng.qparams is None
    jout = jeng.generate_batch(_requests(JRequest), num_slots=2)
    tout = teng.generate_batch(_requests(Request), num_slots=2)
    for f in _FIELDS:
        assert [getattr(r, f) for r in tout] == \
            [getattr(r, f) for r in jout], f
    assert teng.last_stats["waves_batched"] >= 1

    def session(eng, cls, **kw):
        s = eng.serve(num_slots=2, slots_len=32, **kw)
        reqs = _requests(cls)
        hs = [s.submit(r) for r in reqs[:3]]
        s.step()
        hs += [s.submit(r) for r in reqs[3:]]
        while s.step():
            pass
        s.flush()
        out = [outcome(h) for h in hs]
        s.close()
        return out

    assert session(teng, Request) == session(jeng, JRequest, pipeline=False)


@pytest.mark.parametrize("mode", ["4/2", "off"])
def test_static_batch_equals_jax(params, off_engines, mode):
    """The lockstep baseline, greedy and sampled: rows equal the JAX
    engine's static rows, modeled numbers NaN. Off, each row equals the
    port's ``generate_reference`` too."""
    jeng, teng = off_engines if mode == "off" else _engines(params)
    for sampled in (False, True):
        jout = jeng.generate_batch(_requests(JRequest, sampled), static=True)
        tout = teng.generate_batch(_requests(Request, sampled), static=True)
        assert [r.tokens for r in tout] == [r.tokens for r in jout]
        assert [len(r.tokens) for r in tout] == [6, 9, 1, 5]
        assert all(np.isnan(r.ttft_s) and np.isnan(r.tpot_s)
                   and r.wall_s > 0 for r in tout)
        if mode == "off":
            assert [r.tokens for r in tout] == [
                teng.generate_reference(r).tokens
                for r in _requests(Request, sampled)]
