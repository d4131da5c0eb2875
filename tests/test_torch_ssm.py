"""Port parity for the SSM architectures: the log-depth scan, Mamba1
(falcon-mamba) and Mamba2 (zamba2) prefill and decode with dense and
packed (both tiers, "4/2" and "4/0") in/out projections and the caches
they leave, and the model entry points on ``.reduced()`` of
``falcon_mamba_7b`` and ``zamba2_1p2b`` (also at 4 layers: two shared
attention sites) — solo ``prefill``, then ``decode_many_batched`` with
dead rows, whose SSM state must freeze — against the JAX package on the
same numpy-made params. Tolerances: greedy tokens, done/emitted masks,
lengths and cache positions exact; f32 activations, logits and states
allclose at atol = rtol = 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jit_run, n, numpy_init, port, port_cache, \
    port_caches, port_cfg, t
from repro.configs import get_config as jget_config
from repro.models import decode_many_batched as jdecode_many_batched
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import quantize_model as jquantize_model
from repro.models.kv_cache import SSMCache as JSSMCache
from repro.models.layers import ssm as jssm
from repro.quant.qtensor import MixedPrecisionWeights as JMixed
from repro_torch.models.kv_cache import SSMCache
from repro_torch.models.layers import ssm as tssm
from repro_torch.models.model import decode_many_batched, prefill

TOL = dict(atol=1e-5, rtol=1e-5)
SSM = ["falcon_mamba_7b", "zamba2_1p2b"]


def _cfg(arch, low_bits=2, **over):
    cfg = jget_config(arch).reduced(**over)
    return dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=low_bits))


@pytest.mark.parametrize("shape", [(2, 1, 3), (1, 2, 5), (2, 7, 4),
                                   (1, 16, 3), (2, 33, 2)])
@pytest.mark.parametrize("broadcast", [False, True])
def test_assoc_scan_matches(shape, broadcast):
    """Odd and even lengths; ``a`` broadcast along the state dim (Mamba2's
    per-head decay) or full."""
    rng = np.random.default_rng(shape[1])
    b_ = rng.standard_normal(shape).astype(np.float32)
    a_shape = shape[:2] + (1,) if broadcast else shape
    a = rng.uniform(0.5, 1.0, a_shape).astype(np.float32)
    h0 = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    want = jssm._assoc_scan(jnp.broadcast_to(jnp.asarray(a), shape),
                            jnp.asarray(b_), jnp.asarray(h0))
    got = tssm._assoc_scan(t(a), t(b_), t(h0))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def _layer(arch, low_bits):
    """Layer 0's SSM params of the reduced config, and its packed store."""
    cfg = _cfg(arch, low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    p = jax.tree.map(lambda x: x[0], params["layers"]["ssm"])
    pol = cfg.dymoe
    q = {name: JMixed.build(p[name], pol.high_bits, pol.low_bits or None,
                            pol.group_size) for name in ("in_proj",
                                                         "out_proj")}
    return cfg, p, q


def _check_ssm(tc, jc):
    np.testing.assert_array_equal(n(tc.length), np.asarray(jc.length))
    for f in ("conv_state", "ssm_state"):
        np.testing.assert_allclose(n(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), **TOL,
                                   err_msg=f)


@pytest.mark.parametrize("proj", ["dense", "4/2-hi", "4/2-lo", "4/0-lo"])
@pytest.mark.parametrize("arch", SSM)
def test_mamba_prefill_and_decode_match(arch, proj):
    """Prefill 9 tokens from a non-zero state, then 3 decode steps: out
    and the cache after each. ``live`` freezes a row's state exactly.
    Packed projections run at the tier's precision ("4/0": high always)."""
    cfg, p, q = _layer(arch, 0 if proj.startswith("4/0") else 2)
    tcfg = port_cfg(cfg)
    jp, tp = p, port(p)
    if proj != "dense":
        tier = proj.endswith("hi")
        jp = dict(p, in_proj=(q["in_proj"], jnp.asarray(tier)),
                  out_proj=(q["out_proj"], jnp.asarray(tier)))
        tq = port(q)
        tp = dict(tp, in_proj=(tq["in_proj"], tier),
                  out_proj=(tq["out_proj"], tier))
    rng = np.random.default_rng(7)
    b = 2
    c0 = jssm.init_ssm_cache(cfg, b)
    c0 = JSSMCache(conv_state=c0.conv_state, length=c0.length,
                   ssm_state=jnp.asarray(rng.standard_normal(
                       c0.ssm_state.shape), jnp.float32))
    x = rng.standard_normal((b, 9, cfg.d_model)).astype(np.float32)
    jo, jc = jit_run(lambda: jssm.mamba_prefill(jp, cfg, jnp.asarray(x), c0))
    to, tc = tssm.mamba_prefill(tp, tcfg, t(x), port_cache(c0))
    np.testing.assert_allclose(n(to), np.asarray(jo), **TOL)
    _check_ssm(tc, jc)
    jdecode = jax.jit(lambda x1, c: jssm.mamba_decode(jp, cfg, x1, c))
    for step in range(3):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jdecode(jnp.asarray(x1), jc)
        to, tc = tssm.mamba_decode(tp, tcfg, t(x1), tc)
        np.testing.assert_allclose(n(to), np.asarray(jo), **TOL)
        _check_ssm(tc, jc)
    frozen = SSMCache(*(v.clone() for v in dataclasses.astuple(tc)))
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jo, jc = jdecode(jnp.asarray(x1), jc)
    to, tc = tssm.mamba_decode(tp, tcfg, t(x1), tc,
                               live=torch.tensor([True, False]))
    np.testing.assert_allclose(n(to), np.asarray(jo), **TOL)
    for f in ("conv_state", "ssm_state", "length"):
        np.testing.assert_allclose(n(getattr(tc, f))[0],
                                   np.asarray(getattr(jc, f))[0], **TOL)
        assert torch.equal(getattr(tc, f)[1], getattr(frozen, f)[1]), f


@pytest.mark.parametrize("arch", SSM)
def test_prefill_scan_blocks_do_not_change_results(arch, monkeypatch):
    """Scanning in blocks of channels / heads (the memory bound at full
    width) gives the same numbers as one block, to the last bits of the
    state contraction (a one-channel block takes another matmul path)."""
    cfg, p, _ = _layer(arch, 2)
    tcfg, tp = port_cfg(cfg), port(p)
    x = t(np.random.default_rng(8).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32))
    outs = []
    for budget in (1 << 40, 1):       # one block; one channel / head each
        monkeypatch.setattr(tssm, "SCAN_BLOCK_BYTES", budget)
        c = tssm.init_ssm_cache(tcfg, 1)
        outs.append((tssm.mamba_prefill(tp, tcfg, x, c)[0], c))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(outs[0][1].ssm_state, outs[1][1].ssm_state,
                               rtol=0, atol=0)


def _setup(cfg):
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return params, qp, port_cfg(cfg), port(params), port(qp)


def _check_caches(tc, jc):
    _check_ssm(tc["layers"], jc["layers"])
    assert set(tc) == set(jc)
    if "shared" in jc:
        for f in ("positions", "length", "offset"):
            np.testing.assert_array_equal(n(getattr(tc["shared"], f)),
                                          np.asarray(getattr(jc["shared"], f)))
        for f in ("k", "v"):
            np.testing.assert_allclose(n(getattr(tc["shared"], f)),
                                       np.asarray(getattr(jc["shared"], f)),
                                       **TOL)


@pytest.mark.parametrize("name,cfg_fn", [
    ("falcon_mamba", lambda: _cfg("falcon_mamba_7b")),
    ("falcon_mamba-4/0", lambda: _cfg("falcon_mamba_7b", 0)),
    ("zamba2", lambda: _cfg("zamba2_1p2b")),
    ("zamba2-4layers-2sites", lambda: _cfg("zamba2_1p2b", num_layers=4))])
def test_prefill_and_decode_many_batched_match(name, cfg_fn):
    """Solo prefill of 3 rows, then a greedy chunk with a dead row and a
    limit that stops a row mid-chunk: logits, the SSM (and shared-site KV)
    caches — frozen rows' states unchanged — tokens, done, emitted."""
    cfg = cfg_fn()
    params, qp, tcfg, tparams, tqp = _setup(cfg)
    b, s, steps = 3, 9, 5
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (b, s))
    jl, jc, ji = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt, jnp.int32), qparams=qp,
        cache_slots=s + steps + 1))
    tl, tc, ti = prefill(tparams, tcfg, t(prompt).long(), qparams=tqp,
                         cache_slots=s + steps + 1)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_caches(tc, jc)
    assert ti.critical_masks is None and ji.critical_masks is None
    tok0 = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    done = np.array([False, True, False])
    kw = dict(n_emitted=np.ones(b, np.int32),
              limits=np.array([10, 10, 3], np.int32),
              eos_tokens=np.full(b, -1, np.int32))
    jt, jc2, _, jd, je = jit_run(lambda: jdecode_many_batched(
        params, cfg, jnp.asarray(tok0), jc, num_steps=steps,
        done=jnp.asarray(done), qparams=qp, live_cap=2,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    tc_in = port_caches(jc)
    dead_before = tc_in["layers"].ssm_state[:, 1].clone()
    tt, tc2, _, td, te = decode_many_batched(
        tparams, tcfg, t(tok0), tc_in, num_steps=steps, done=t(done),
        qparams=tqp, live_cap=2, **{k: t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(te), np.asarray(je))
    _check_caches(tc2, jc2)
    assert torch.equal(tc2["layers"].ssm_state[:, 1], dead_before)
