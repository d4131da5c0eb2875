"""The port's data-local MoE dispatch (``cfg.moe_dispatch_shards`` D > 1,
``moe_apply_sharded``) and the sequence-sharded residual
(``cfg.act_seq_shard``) on the CPU, against the JAX package from the same
numpy-made params:

  * ``moe_apply_sharded`` at D 2 and 4, and D 7 (which does not divide the
    64 tokens: the ``moe_apply`` fallback), at full precision and in "4/2"
    and "4/0" with a Critical mask, an ``hh_mask`` and ``token_valid``, at a
    capacity factor of 0.5, so each group's own capacity drops tokens:
    outputs and statistics against the reference's; and the folded call
    (one capacity buffer of D·C_d rows a expert) bitwise equal to a loop of
    ``moe_apply`` over the D groups, on the plain kernel versions;
  * the model with ``moe_dispatch_shards=2`` (capacity factor 1.0):
    solo and ragged ``prefill``, ``decode_step`` with ``per_row_moe``
    both ways, the engine's ``generate_reference`` (tokens and modeled
    numbers), and ``loss_fn`` with its grads;
  * ``act_seq_shard=True`` (a sharding constraint in the JAX package,
    numerically the identity): the port's loss and grads bitwise its own
    ``False`` run's, and equal to the reference's ``False`` run and to its
    ``True`` run under a (1, 1) ("data", "model") CPU mesh.

Tolerances: tokens, masks and expert loads exact; f32 activations and
logits at atol = rtol = 1e-5; grads at the training tests' rtol 1e-4 /
atol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_bridge import jit_run, n, numpy_init, port, port_caches, \
    port_cfg, t
from _torch_serving import plain
from test_torch_model import TOL, _check_caches, _check_info, _moe_cfg
from test_torch_train import GRAD_TOL, _batch, _jpaths, _port_grads, \
    _tiny_moe
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.models import prefill as jprefill
from repro.models import quantize_model as jquantize_model
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.models.layers import moe as jmoe
from repro.models.model import decode_step as jdecode_step
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.model import decode_step, prefill
from repro_torch.serving import DyMoEEngine, EngineConfig, Request

T = 64


def _layer(mode, d):
    low = {"fp": 2, "4/2": 2, "4/0": 0}[mode]
    cfg = ModelConfig(
        name="s", arch_type="moe", num_layers=1, d_model=32, vocab_size=64,
        num_heads=2, num_kv_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=48, capacity_factor=0.5,
        dtype="float32", remat="none", moe_dispatch_shards=d,
        dymoe=DyMoEPolicy(low_bits=low, group_size=16))
    p = numpy_init(lambda: jmoe.init_moe(cfg, jax.random.PRNGKey(1),
                                         jnp.float32), 1)
    return cfg, p, (None if mode == "fp" else jmoe.quantize_moe(p, cfg))


@pytest.mark.parametrize("mode", ["fp", "4/2", "4/0"])
@pytest.mark.parametrize("d", [2, 4, 7])
def test_moe_apply_sharded_matches(mode, d):
    cfg, p, qw = _layer(mode, d)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    crit = None if qw is None else np.array([True, False, True, False])
    hh = (rng.random(T) < 0.3).astype(np.float32)
    tv = rng.random(T) < 0.85
    jy, js = jit_run(lambda: jmoe.moe_apply_sharded(
        p, cfg, jnp.asarray(x), hh_mask=jnp.asarray(hh),
        critical_mask=None if crit is None else jnp.asarray(crit),
        qweights=qw, token_valid=jnp.asarray(tv)))
    tcfg, tp = port_cfg(cfg), port(p)
    tq = None if qw is None else port(qw)
    kw = dict(critical_mask=None if crit is None else t(crit), qweights=tq)
    ty, ts = tmoe.moe_apply_sharded(tp, tcfg, t(x), hh_mask=t(hh),
                                    token_valid=t(tv), **kw)
    np.testing.assert_allclose(n(ty), np.asarray(jy), **TOL)
    for f in ("expert_load", "expert_hh_load"):
        np.testing.assert_array_equal(n(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("router_logits", "gate_mean", "aux_loss", "dropped_frac"):
        np.testing.assert_allclose(n(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), **TOL,
                                   err_msg=f)
    assert float(ts.dropped_frac) > 0          # group capacities bind
    if T % d:
        return
    # the folded call is a loop of moe_apply over the groups, bitwise
    s = T // d
    one = dataclasses.replace(tcfg, moe_dispatch_shards=0)
    parts = [tmoe.moe_apply(tp, one, t(x[i * s:(i + 1) * s]),
                            hh_mask=t(hh[i * s:(i + 1) * s]),
                            token_valid=t(tv[i * s:(i + 1) * s]), **kw)
             for i in range(d)]
    assert torch.equal(ty, torch.cat([y for y, _ in parts]))
    for f, merge in (("expert_load", "sum"), ("expert_hh_load", "sum"),
                     ("gate_mean", "mean"), ("aux_loss", "mean"),
                     ("dropped_frac", "mean")):
        want = getattr(torch.stack([getattr(st, f) for _, st in parts]),
                       merge)(0)
        assert torch.equal(getattr(ts, f), want), f


# ------------------------------------------------------------- model level


def _sharded(low_bits=2):
    return dataclasses.replace(_moe_cfg(low_bits), moe_dispatch_shards=2,
                               capacity_factor=1.0)


@pytest.fixture(scope="module", params=[2, 0], ids=["4/2", "4/0"])
def model(request):
    cfg = _sharded(request.param)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return cfg, params, qp, port_cfg(cfg), port(params), port(qp)


@pytest.mark.parametrize("mode", ["solo", "ragged"])
def test_prefill_matches(model, mode):
    """Solo: 32 tokens, two groups of 16; ragged: 2 rows of 20,
    right-aligned, one shared Critical set, two groups of 20."""
    cfg, params, qp, tcfg, tparams, tqp = model
    rng = np.random.default_rng(2)
    if mode == "solo":
        prompt = rng.integers(1, cfg.vocab_size, (1, 32))
        jkw, tkw = {}, {}
    else:
        lens = np.array([20, 13], np.int32)
        prompt = np.zeros((2, 20), np.int64)
        for i, ln in enumerate(lens):
            prompt[i, 20 - ln:] = rng.integers(1, cfg.vocab_size, ln)
        jkw, tkw = dict(lengths=jnp.asarray(lens)), dict(lengths=t(lens))
    jl, jc, ji = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=qp, cache_slots=40, **jkw))
    tl, tc, ti = prefill(tparams, tcfg, t(prompt), qparams=tqp,
                         cache_slots=40, **tkw)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_info(ti, ji)
    _check_caches(tc, jc)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "rows"])
def test_decode_step_matches(model, per_row):
    cfg, params, qp, tcfg, tparams, tqp = model
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, (4, 9))
    logits, caches, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=qp, cache_slots=12))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    tcaches = port_caches(caches)
    jl, jc, ji = jit_run(lambda: jdecode_step(
        params, cfg, jnp.asarray(tok0), caches, qparams=qp,
        per_row_moe=per_row))
    tl, tc, ti = decode_step(tparams, tcfg, t(tok0), tcaches, qparams=tqp,
                             per_row_moe=per_row)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_info(ti, ji)
    _check_caches(tc, jc)


def test_generate_reference_matches(model):
    """A 24-token prompt (two groups of 12), 9 new tokens: tokens and
    every modeled number equal the JAX engine's."""
    cfg, params, qp, tcfg, tparams, tqp = model
    prompt = [int(v) for v in np.random.default_rng(6).integers(1, 256, 24)]
    jr = JEngine(cfg, params, JEngineConfig(decode_chunk=4)
                 ).generate_reference(JRequest(prompt_tokens=prompt,
                                               max_new_tokens=9))
    tr = DyMoEEngine(tcfg, tparams, EngineConfig(decode_chunk=4),
                     device="cpu", qparams=tqp).generate_reference(
        Request(prompt_tokens=prompt, max_new_tokens=9))
    assert tr.tokens == jr.tokens
    for f in ("ttft_s", "tpot_s", "cache_stats", "prefill_weight_bytes",
              "decode_weight_bytes_per_tok", "prefill_timing",
              "decode_timings"):
        assert plain(getattr(tr, f)) == plain(getattr(jr, f)), f


# ----------------------------------------------------------------- training


def _train_cfg(**over):
    return dataclasses.replace(_tiny_moe(), capacity_factor=0.5, **over)


def _jloss(cfg, params, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, cfg, bt), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        _jpaths(grads)


def _check_loss(got, want):
    loss, metrics, grads = got
    jloss, jmetrics, jgrads = want
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k],
                                   rtol=1e-5)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k, **GRAD_TOL)


def test_loss_and_grads_match_with_dispatch_shards():
    cfg = _train_cfg(moe_dispatch_shards=2)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    _check_loss(_port_grads(port(params), port_cfg(cfg), batch),
                _jloss(cfg, params, batch))


def test_act_seq_shard_is_the_identity():
    cfg = _train_cfg()
    seq = dataclasses.replace(cfg, act_seq_shard=True)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    base = _port_grads(port(params), port_cfg(cfg), batch)
    got = _port_grads(port(params), port_cfg(seq), batch)
    assert got[0].item() == base[0].item()
    assert all(np.array_equal(got[2][k], base[2][k]) for k in base[2])
    want = _jloss(cfg, params, batch)
    _check_loss(got, want)
    with Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")):
        want_seq = _jloss(seq, params, batch)
    _check_loss(got, want_seq)
