"""Port parity for the layers of the serving path: attention (prefill and
decode, ``kv_valid``, received-attention mass), the KV cache, importance
and Critical selection, prefetch, and the three MoE dispatches. The same
numpy inputs go through the JAX function and its ``repro_torch``
counterpart. Tolerances: f32 activations allclose at atol = rtol = 1e-5;
masks, slots, loads and cache positions exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jit_run, n, numpy_init, port, port_cfg, t
from repro.configs import get_config as jget_config
from repro.core import importance as jimp
from repro.core.prefetch import prefetch_targets as jprefetch_targets
from repro.models import kv_cache as jkv
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.models.layers import attention as jattn
from repro.models.layers import moe as jmoe
from repro_torch.core import importance as timp
from repro_torch.core.prefetch import prefetch_targets
from repro_torch.models import kv_cache as tkv
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)


def _tiny(low_bits=2):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


def _cfgs():
    return {"tiny_gqa": _tiny(), "olmoe_reduced": jget_config(
        "olmoe_1b_7b").reduced()}


def _attn_params(cfg, seed):
    return numpy_init(lambda: jattn.init_attention(
        cfg, jax.random.PRNGKey(seed), jnp.float32), seed)


def _ragged(b, s, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    lens[0] = s
    offs = s - lens
    idx = np.arange(s)[None]
    valid = idx >= offs[:, None]
    pos = np.maximum(idx - offs[:, None], 0).astype(np.int32)
    return lens, offs.astype(np.int32), valid, pos


@pytest.mark.parametrize("name", ["tiny_gqa", "olmoe_reduced"])
@pytest.mark.parametrize("ragged", [False, True])
def test_attention_train_matches(name, ragged):
    cfg = _cfgs()[name]
    p = _attn_params(cfg, 1)
    b, s = 3, 12
    x = np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if ragged:
        _, _, valid, pos = _ragged(b, s, 3)
        kw_j = dict(positions=jnp.asarray(pos), kv_valid=jnp.asarray(valid))
        kw_t = dict(positions=t(pos), kv_valid=t(valid))
    jo, jti, (jk, jv) = jit_run(lambda: jattn.attention_train(
        p, cfg, jnp.asarray(x), want_token_importance=True, **kw_j))
    to, tti, (tk, tv) = tattn.attention_train(
        port(p), port_cfg(cfg), t(x), want_token_importance=True, **kw_t)
    for got, ref in ((to, jo), (tti, jti), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["tiny_gqa", "olmoe_reduced"])
def test_kv_cache_and_attention_decode_match(name):
    """Ragged prefill fill (offsets) then two decode steps with a dead
    row: outputs allclose, positions/lengths/offsets exact."""
    cfg = _cfgs()[name]
    tcfg = port_cfg(cfg)
    p = _attn_params(cfg, 4)
    tp = port(p)
    b, s, slots = 3, 8, 12
    hk, d = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    lens, offs, _, _ = _ragged(b, s, 6)
    kseq = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    vseq = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    jc = jit_run(lambda: jkv.fill_kv_cache(
        jkv.init_kv_cache(b, hk, slots, d, jnp.float32), jnp.asarray(kseq),
        jnp.asarray(vseq), lengths=jnp.asarray(lens),
        offsets=jnp.asarray(offs)))
    tc = tkv.fill_kv_cache(
        tkv.init_kv_cache(b, hk, slots, d, torch.float32), t(kseq), t(vseq),
        lengths=t(lens), offsets=t(offs))
    live = np.array([True, False, True])
    for step in range(2):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jit_run(lambda: jattn.attention_decode(
            p, cfg, jnp.asarray(x), jc, live=jnp.asarray(live)))
        to, tc = tattn.attention_decode(tp, tcfg, t(x), tc, live=t(live))
        np.testing.assert_allclose(n(to)[live], np.asarray(jo)[live], **TOL)
    for f in ("positions", "length", "offset"):
        np.testing.assert_array_equal(n(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ("k", "v"):
        np.testing.assert_allclose(n(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), **TOL)


def test_importance_and_critical_selection_with_ties():
    """Ties are broken by the lower index on both sides (stable sorts)."""
    rng = np.random.default_rng(7)
    imp = rng.integers(0, 4, (6, 16)).astype(np.float32)   # many ties
    for t_l in (1, 5, 16):
        np.testing.assert_array_equal(
            n(timp.select_critical_rows(t(imp), t_l)),
            np.asarray(jimp.select_critical_rows(jnp.asarray(imp), t_l)))
        np.testing.assert_array_equal(
            n(timp.select_critical(t(imp[0]), t_l)),
            np.asarray(jimp.select_critical(jnp.asarray(imp[0]), t_l)))
    ti = rng.integers(0, 5, (3, 20)).astype(np.float32)
    for frac in (0.1, 0.2, 0.5):
        np.testing.assert_array_equal(
            n(timp.heavy_hitter_mask(t(ti), frac)),
            np.asarray(jimp.heavy_hitter_mask(jnp.asarray(ti), frac)))
    hh = rng.integers(0, 3, (4, 8)).astype(np.float32)
    load = hh + rng.integers(0, 3, (4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        n(timp.prefill_expert_importance_rows(t(hh), t(load))),
        np.asarray(jimp.prefill_expert_importance_rows(jnp.asarray(hh),
                                                       jnp.asarray(load))),
        **TOL)


@pytest.mark.parametrize("valid", [False, True])
def test_prefetch_targets_match(valid):
    rng = np.random.default_rng(8)
    g = rng.random((10, 8)).astype(np.float32)
    g[:, 3] = g[:, 5]                              # tied experts
    tv = rng.random(10) < 0.7
    jtop, jfreq = jprefetch_targets(jnp.asarray(g), 2, 3,
                                    token_valid=jnp.asarray(tv) if valid
                                    else None)
    ttop, tfreq = prefetch_targets(t(g), 2, 3,
                                   token_valid=t(tv) if valid else None)
    np.testing.assert_allclose(n(tfreq), np.asarray(jfreq), **TOL)
    np.testing.assert_array_equal(n(ttop), np.asarray(jtop))


def _moe(low_bits, seed=0):
    cfg = ModelConfig(
        name="s", arch_type="moe", num_layers=1, d_model=32, vocab_size=64,
        num_heads=2, num_kv_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=48, capacity_factor=1.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, group_size=16))
    p = numpy_init(lambda: jmoe.init_moe(cfg, jax.random.PRNGKey(seed),
                                         jnp.float32), seed)
    return cfg, p, jmoe.quantize_moe(p, cfg)


def _close_stats(ts, js, exact=("active", "load")):
    for k, v in js.items():
        got = n(ts[k])
        if k in exact:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(got, np.asarray(v), **TOL, err_msg=k)


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
@pytest.mark.parametrize("padded", [False, True])
def test_moe_apply_matches(low_bits, padded):
    """Solo-admission MoE (K2 path), capacity 1.0 so some tokens drop."""
    cfg, p, qw = _moe(low_bits, seed=1)
    rng = np.random.default_rng(9)
    tt = 24
    x = rng.standard_normal((tt, cfg.d_model)).astype(np.float32)
    crit = np.array([True, False, True, False])
    hh = (rng.random(tt) < 0.3).astype(np.float32)
    tv = rng.random(tt) < 0.8 if padded else None
    jy, js = jit_run(lambda: jmoe.moe_apply(
        p, cfg, jnp.asarray(x), hh_mask=jnp.asarray(hh),
        critical_mask=jnp.asarray(crit), qweights=qw,
        token_valid=None if tv is None else jnp.asarray(tv)))
    ty, ts = tmoe.moe_apply(port(p), port_cfg(cfg), t(x),
                            critical_mask=t(crit), qweights=port(qw),
                            hh_mask=t(hh),
                            token_valid=None if tv is None else t(tv))
    np.testing.assert_allclose(n(ty), np.asarray(jy), **TOL)
    for f in ("expert_load", "expert_hh_load"):
        np.testing.assert_array_equal(n(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    for f in ("router_logits", "gate_mean", "aux_loss", "dropped_frac"):
        np.testing.assert_allclose(n(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), **TOL)


@pytest.mark.parametrize("low_bits,fused,dead", [
    (2, True, 0), (2, True, 5), (0, True, 0), (0, True, 5), (2, False, 5),
    (0, False, 5)], ids=["4/2-fused-0", "4/2-fused-5", "4/0-fused-0",
                         "4/0-fused-5", "4/2-oracle-5", "4/0-oracle-5"])
def test_moe_apply_rows_matches(low_bits, fused, dead):
    """Decode MoE (K1 path): per-row Critical sets, dead rows, the
    scheduler's power-of-two capacity; dead rows come back zero. The
    ``fused=False`` oracle runs with dead rows only, its harder case."""
    cfg, p, qw = _moe(low_bits, seed=2)
    rng = np.random.default_rng(10 + dead)
    b = 8
    x = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    crit = rng.random((b, cfg.num_experts)) < 0.5
    live = np.ones(b, bool)
    live[rng.choice(b, dead, replace=False)] = False
    cap = None if not dead else 4
    jy, js = jit_run(lambda: jmoe.moe_apply_rows(
        p, cfg, jnp.asarray(x), jnp.asarray(crit), qw,
        live=jnp.asarray(live), capacity=cap, fused=fused))
    ty, ts = tmoe.moe_apply_rows(port(p), port_cfg(cfg), t(x), t(crit),
                                 port(qw), live=t(live), capacity=cap,
                                 fused=fused)
    np.testing.assert_allclose(n(ty), np.asarray(jy), **TOL)
    assert not n(ty)[~live].any()
    _close_stats(ts, js)


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
@pytest.mark.parametrize("fused", [True, False])
def test_moe_apply_prefill_rows_matches(low_bits, fused):
    """Admission-wave MoE (K1 path): row-local regions, ragged padding,
    exact host row capacities; padded tokens come back zero."""
    cfg, p, qw = _moe(low_bits, seed=3)
    rows, s = 3, 10
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows * s, cfg.d_model)).astype(np.float32)
    crit = rng.random((rows, cfg.num_experts)) < 0.5
    valid = np.ones((rows, s), bool)
    valid[1, :4] = False
    valid[2, :9] = False
    valid = valid.reshape(-1)
    hh = (rng.random(rows * s) < 0.3).astype(np.float32) * valid
    lens = valid.reshape(rows, s).sum(1)
    caps = np.array([jmoe._capacity(cfg, int(v)) for v in lens], np.int32)
    assert [tmoe._capacity(port_cfg(cfg), int(v)) for v in lens] == \
        caps.tolist()
    jy, js = jit_run(lambda: jmoe.moe_apply_prefill_rows(
        p, cfg, jnp.asarray(x), jnp.asarray(crit), qw, rows=rows,
        hh_mask=jnp.asarray(hh), token_valid=jnp.asarray(valid),
        row_capacities=jnp.asarray(caps), fused=fused))
    ty, ts = tmoe.moe_apply_prefill_rows(
        port(p), port_cfg(cfg), t(x), t(crit), port(qw), rows=rows,
        hh_mask=t(hh), token_valid=t(valid), row_capacities=t(caps),
        fused=fused)
    np.testing.assert_allclose(n(ty), np.asarray(jy), **TOL)
    assert not n(ty)[~valid].any()
    _close_stats(ts, js, exact=("active", "load", "hh_load"))
