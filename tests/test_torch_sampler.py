"""Port parity for sampling: the torch threefry2x32 gives ``jax.random``'s
keys, bits and uniforms bitwise (partitionable threefry, 64-bit mode off,
as the JAX package runs); Gumbels agree to 1 ulp of max(1, |g|) (the two
``log`` implementations differ by an ulp, and the outer log's argument is
near 1); ``categorical``, ``sample_token`` and ``sample_token_rows`` give
the same tokens on the same numpy logits; and seeded sampled serving on
the tiny MoE gives the JAX engine's tokens, solo and in a batch, for
``decode_chunk`` 1 and 4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import numpy_init, port, port_cfg
from repro.models import init_params as jinit_params
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import sampler as jsampler
from repro_torch.serving import DyMoEEngine, EngineConfig, Request
from repro_torch.serving import sampler

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5, -3]
FOLDS = [0, 1, 7, 1000, 2 ** 31 + 5]


def _u32(x):
    return sampler.raw_key_data(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniform_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), sampler.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for d in FOLDS:
        np.testing.assert_array_equal(_u32(sampler.fold_in(tk, d)),
                                      np.asarray(jax.random.fold_in(jk, d)))
    # a (B, 2) stack of keys folds a (B,) tensor of counts at once
    rows = np.stack([np.asarray(jax.random.fold_in(jk, d)) for d in FOLDS])
    np.testing.assert_array_equal(
        _u32(sampler.fold_in(tk.expand(len(FOLDS), 2), torch.tensor(FOLDS))),
        rows)
    for shape in [(1, 50304), (3, 7), (5,)]:
        np.testing.assert_array_equal(
            sampler.bits(tk, shape).numpy().astype(np.uint32),
            np.asarray(jax.random.bits(jk, shape)))
        for lo, hi in [(0.0, 1.0), (1.5, 3.25), (-2.0, 0.3)]:
            got = sampler.uniform(tk, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                                 maxval=hi))
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        g = sampler.gumbel(tk, shape).numpy()
        jg = np.asarray(jax.random.gumbel(jk, shape))
        ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
        assert np.all(np.abs(g - jg) <= ulp)
    # per-row stacks: row i's bits are bits(keys[i], shape)
    keys = sampler.fold_in(tk.expand(3, 2), torch.arange(3))
    np.testing.assert_array_equal(
        sampler.bits(keys, (1, 300)).numpy().astype(np.uint32),
        np.stack([np.asarray(jax.random.bits(jnp.asarray(_u32(k)), (1, 300)))
                  for k in keys]))


def _logits(rng, b, v):
    x = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    x[0, [5, 9]] = x[0].max() + 1.0           # a tie at the maximum
    return x


def test_categorical_and_sample_token_equal_jax():
    rng = np.random.default_rng(0)
    logits = _logits(rng, 4, 300)
    for seed in range(6):
        jk, tk = jax.random.PRNGKey(seed), sampler.PRNGKey(seed)
        assert np.array_equal(
            sampler.categorical(tk, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(jk, jnp.asarray(logits))))
        for temp in (0.0, 0.3, 0.7, 1.0, 2.0):
            for top_k in (0, 1, 20, 301):
                got = sampler.sample_token(torch.from_numpy(logits), tk,
                                           temperature=temp, top_k=top_k)
                want = jsampler.sample_token(jnp.asarray(logits), jk,
                                             temperature=temp, top_k=top_k)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # greedy: the first maximum, as jnp.argmax
    g = sampler.sample_token(torch.from_numpy(logits)).numpy()
    assert g[0] == 5 and np.array_equal(g, np.argmax(logits, axis=-1))


def test_sample_token_rows_equal_jax():
    """Mixed temperatures, top_k 0 / 1 / 20 / > V and greedy rows, batched
    in one call; row i also equals the solo ``sample_token`` of row i."""
    rng = np.random.default_rng(1)
    temps = np.array([0.7, 0.0, 1.0, 0.3, 2.0, 0.7, 0.0, 1.3], np.float32)
    topks = np.array([0, 20, 1, 20, 400, 0, 0, 1], np.int32)
    jrows = jax.jit(jsampler.sample_token_rows)   # as the engine runs it
    for trial in range(10):
        logits = _logits(rng, 8, 300)
        keys = np.stack([np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(100 * trial + i), trial)) for i in range(8)])
        got = sampler.sample_token_rows(
            torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(temps), torch.from_numpy(topks))
        want = np.asarray(jrows(jnp.asarray(logits), jnp.asarray(keys),
                                jnp.asarray(temps), jnp.asarray(topks)))
        np.testing.assert_array_equal(got.numpy(), want)
        for i in range(8):
            solo = sampler.sample_token(
                torch.from_numpy(logits[i:i + 1]), keys[i],
                temperature=float(temps[i]), top_k=int(topks[i]))
            assert int(solo[0]) == int(got[i])


def test_keyless_sampled_request_warns_and_is_greedy():
    req = Request(prompt_tokens=[1, 2], temperature=0.8)
    with pytest.warns(UserWarning, match="falling back to greedy"):
        assert sampler.resolve_sampling(req, context="t") == (0.0, 0, None)
    with pytest.warns(UserWarning, match="falling back to greedy"):
        out = sampler.sample_token(torch.tensor([[0.0, 2.0, 1.0]]),
                                   temperature=0.8)
    assert out.tolist() == [1]


def _moe_cfg():
    """``tests/test_decode_many.py::_moe_cfg`` in "4/2"."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=2, retention=0.75))


def test_sampled_serving_equals_jax_engine():
    """Seeded sampled requests (temperature 0.7, top_k 0 and 20; one
    greedy; one sampled without a seed, rooted at ``fold_in(rng_key, i)``)
    over 2 slots: the port's tokens equal the JAX engine's, and a sampled
    request's solo ``generate``, ``decode_chunk`` 1 and a keyless sampled
    request (greedy, with a warning) agree with their batch rows."""
    cfg = _moe_cfg()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    specs = [(7, 9, 0.7, 0, 11), (12, 6, 0.7, 20, 12), (5, 8, 0.0, 0, None),
             (9, 7, 0.7, 20, None), (4, 10, 1.3, 0, 13)]
    prompts = [[int(v) for v in rng.integers(1, cfg.vocab_size, s)]
               for s, *_ in specs]

    def reqs(cls):
        return [cls(prompt_tokens=p, max_new_tokens=m, temperature=t,
                    top_k=k, seed=sd)
                for p, (_, m, t, k, sd) in zip(prompts, specs)]

    root = 77
    jout = JEngine(cfg, params, JEngineConfig(decode_chunk=4)).generate_batch(
        reqs(JRequest), jax.random.PRNGKey(root), num_slots=2)
    tcfg, tparams = port_cfg(cfg), port(params)
    eng = DyMoEEngine(tcfg, tparams, EngineConfig(decode_chunk=4),
                      device="cpu")
    tout = eng.generate_batch(reqs(Request), sampler.PRNGKey(root),
                              num_slots=2)
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert [len(r.tokens) for r in tout] == [m for _, m, *_ in specs]
    greedy = eng.generate_batch([Request(prompt_tokens=p, max_new_tokens=m)
                                 for p, (_, m, *_) in zip(prompts, specs)],
                                num_slots=2)
    assert tout[0].tokens != greedy[0].tokens      # sampling took effect
    assert tout[2].tokens == greedy[2].tokens      # the greedy row
    one = reqs(Request)[1]
    assert eng.generate(one).tokens == tout[1].tokens
    eng1 = DyMoEEngine(tcfg, tparams, EngineConfig(decode_chunk=1),
                       device="cpu", qparams=eng.qparams)
    assert [r.tokens for r in eng1.generate_batch(
        reqs(Request), sampler.PRNGKey(root), num_slots=3)] == \
        [r.tokens for r in tout]
    with pytest.warns(UserWarning, match="falling back to greedy"):
        keyless = eng.generate(Request(prompt_tokens=prompts[0],
                                       max_new_tokens=9, temperature=0.7))
    assert keyless.tokens == greedy[0].tokens
