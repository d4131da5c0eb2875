"""Port parity for the dense architectures (dense, VLM, audio): the dense
FFN (``mlp``, ``quantize_mlp``, ``mlp_quantized`` at both tiers in "4/2"
and "4/0"), ``sinusoidal_embedding``, and the model entry points on
``.reduced()`` of the six dense ``ARCH_IDS`` — solo ``prefill`` (from
``embeds=`` for the VLM and the audio model), the ragged row-local
admission wave, and ``decode_many_batched`` with dead rows — against the
JAX package on the same numpy-made params. Tolerances: packed codes and
scales, greedy tokens, done/emitted masks and cache positions exact; f32
logits, activations and caches allclose at atol = rtol = 1e-5."""
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
from repro.models.layers import mlp as jmlp
from repro.models.layers.rotary import sinusoidal_embedding as jsinusoidal
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers.rotary import sinusoidal_embedding
from repro_torch.models.model import _layer_tier_flags, \
    decode_many_batched, prefill

TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 5
DENSE = ["qwen3_0p6b", "qwen3_32b", "phi3_medium_14b", "qwen1p5_32b",
         "internvl2_26b", "musicgen_medium"]
EMBEDS = ("internvl2_26b", "musicgen_medium")   # frontend stubs


def _cfg(arch, low_bits=2):
    cfg = jget_config(arch).reduced()
    return dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=low_bits))


def test_sinusoidal_embedding_matches():
    """Positions up to the reduced configs' ``max_seq_len``: XLA's and
    torch's f32 ``exp`` differ by one ulp on some frequencies, which moves
    the angle by about position × 6e-8."""
    pos = np.array([[0, 1, 7, 64], [5, 0, 0, 127]], np.int32)
    for dim in (256, 96):
        np.testing.assert_allclose(
            n(sinusoidal_embedding(t(pos), dim)),
            np.asarray(jsinusoidal(jnp.asarray(pos), dim)), **TOL)


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "musicgen_medium"])
def test_mlp_and_quantize_mlp_match(arch):
    """SwiGLU (qwen3) and tanh-GELU (musicgen): the plain FFN, and the
    packed codes and scales of ``quantize_mlp`` bitwise."""
    cfg = _cfg(arch)
    p = numpy_init(lambda: jmlp.init_mlp(cfg, jax.random.PRNGKey(0),
                                         jnp.float32), 3)
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        n(tmlp.mlp(port(p), port_cfg(cfg), t(x))),
        np.asarray(jmlp.mlp(p, cfg, jnp.asarray(x))), **TOL)
    tq = tmlp.quantize_mlp(port(p), port_cfg(cfg))
    jq = port(jmlp.quantize_mlp(p, cfg))
    assert set(tq) == set(jq)
    for name in tq:
        for prec in ("high", "low"):
            a, b = getattr(tq[name], prec), getattr(jq[name], prec)
            np.testing.assert_array_equal(n(a.packed), n(b.packed))
            np.testing.assert_array_equal(n(a.scales), n(b.scales))


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
@pytest.mark.parametrize("critical", [True, False])
@pytest.mark.parametrize("arch", ["qwen3_0p6b", "musicgen_medium"])
def test_mlp_quantized_matches(arch, critical, low_bits):
    """Both tiers; under "4/0" the sub-critical FFN is exactly zero."""
    cfg = _cfg(arch, low_bits)
    p = numpy_init(lambda: jmlp.init_mlp(cfg, jax.random.PRNGKey(0),
                                         jnp.float32), 5)
    jq = jmlp.quantize_mlp(p, cfg)
    x = np.random.default_rng(6).standard_normal(
        (3, 4, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmlp.mlp_quantized(jq, cfg, jnp.asarray(x),
                                         jnp.asarray(critical)))
    got = n(tmlp.mlp_quantized(port(jq), port_cfg(cfg), t(x), critical))
    np.testing.assert_allclose(got, want, **TOL)
    if low_bits == 0 and not critical:
        assert not got.any()


def test_layer_tier_flags_match():
    from repro.models.model import _layer_tier_flags as jflags
    for arch in DENSE + ["zamba2_1p2b", "falcon_mamba_7b"]:
        for cfg in (jget_config(arch), _cfg(arch)):
            assert _layer_tier_flags(port_cfg(cfg)) == \
                np.asarray(jflags(cfg)).tolist()


def _setup(arch, low_bits=2):
    cfg = _cfg(arch, low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return cfg, params, qp, port_cfg(cfg), port(params), port(qp)


def _check_kv(tc, jc):
    for f in ("positions", "length", "offset"):
        np.testing.assert_array_equal(n(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ("k", "v"):
        np.testing.assert_allclose(n(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), **TOL,
                                   err_msg=f)


@pytest.mark.parametrize("arch,low_bits", [(a, 2) for a in DENSE]
                         + [("qwen3_0p6b", 0)])
def test_prefill_and_decode_many_batched_match(arch, low_bits):
    """Solo prefill of 4 rows (from ``embeds`` for the VLM and audio
    stubs), then a greedy chunk over them with two dead rows and a limit
    that stops one row mid-chunk: logits, caches, tokens, done, emitted;
    the telemetry leaves are None on both sides."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(arch, low_bits)
    b, s = 4, 10
    rng = np.random.default_rng(1)
    if arch in EMBEDS:
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        jin, tin = dict(embeds=jnp.asarray(emb)), dict(embeds=t(emb))
    else:
        tok = rng.integers(1, cfg.vocab_size, (b, s))
        jin = dict(tokens=jnp.asarray(tok, jnp.int32))
        tin = dict(tokens=t(tok).long())
    jl, jc, ji = jit_run(lambda: jprefill(
        params, cfg, qparams=qp, cache_slots=s + STEPS + 1, **jin))
    tl, tc, ti = prefill(tparams, tcfg, qparams=tqp,
                         cache_slots=s + STEPS + 1, **tin)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_kv(tc["layers"], jc["layers"])
    assert ji.critical_masks is None and ti.critical_masks is None

    tok0 = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    done = np.array([False, True, True, False])
    kw = dict(n_emitted=np.ones(b, np.int32),
              limits=np.array([10, 10, 10, 3], np.int32),
              eos_tokens=np.full(b, -1, np.int32))
    jt, jc2, ji2, jd, je = jit_run(lambda: jdecode_many_batched(
        params, cfg, jnp.asarray(tok0), jc, num_steps=STEPS,
        done=jnp.asarray(done), qparams=qp, live_cap=2,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    tt, tc2, ti2, td, te = decode_many_batched(
        tparams, tcfg, t(tok0), port_caches(jc),
        num_steps=STEPS, done=t(done), qparams=tqp, live_cap=2,
        **{k: t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(te), np.asarray(je))
    assert ti2.critical_masks is None and ji2.critical_masks is None
    _check_kv(tc2["layers"], jc2["layers"])


@pytest.mark.parametrize("arch", DENSE)
def test_row_local_wave_prefill_matches(arch):
    """The scheduler's admission wave for a dense arch: right-aligned
    ragged rows (positions, and musicgen's sinusoidal embeddings, from
    each row's offset), ``row_local=True`` (a no-op without experts)."""
    cfg, params, qp, tcfg, tparams, tqp = _setup(arch)
    rng = np.random.default_rng(2)
    lens = np.array([11, 4, 7], np.int32)
    prompt = np.zeros((3, 11), np.int64)
    for i, s in enumerate(lens):
        prompt[i, 11 - s:] = rng.integers(1, cfg.vocab_size, s)
    jl, jc, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt, jnp.int32), qparams=qp,
        cache_slots=20, lengths=jnp.asarray(lens), row_local=True))
    tl, tc, _ = prefill(tparams, tcfg, t(prompt).long(), qparams=tqp,
                        cache_slots=20, lengths=t(lens), row_local=True)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    _check_kv(tc["layers"], jc["layers"])
