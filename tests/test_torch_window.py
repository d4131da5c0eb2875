"""Port parity for sliding-window ring caches on every path that serves or
trains a windowed config.

Reduced configs get ``sliding_window=8`` (as the JAX package's own tests
give them one), and prompts of 2–3× the window, so every ring wraps at
prefill and again during decode. The same numpy-made params go through
the JAX package and the port on the CPU:

* ``update_kv_cache`` / ``fill_kv_cache`` on ring caches (frozen rows,
  S < slots, S == slots, S > slots): k, v, positions and length bitwise;
* solo ``prefill`` and ``decode_many_batched`` (dead rows, ``live_cap <
  B``) on reduced OLMoE in "4/2" and "4/0": tokens, masks and cache
  positions exact, f32 logits and caches at 1e-5; decoding through the
  ring equals the windowed prefill's logits (the reference's own check,
  ``tests/test_consistency.py``, 2e-3);
* the engine (``generate_batch`` continuous with solo admissions and
  ``static=True``, ``generate``, ``generate_reference``, an open session)
  on reduced OLMoE, qwen3_0p6b (dense, K2 at E = 1) and zamba2_1p2b (the
  hybrid's shared sites) against the JAX engine with ``==``: tokens and
  modeled TTFT/TPOT;
* ``loss_fn`` and its grads on windowed reduced OLMoE, at the training
  tests' tolerances."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jit_run, n, numpy_init, port, port_caches, \
    port_cfg, quantized_pair, t
from _torch_serving import events, outcome, plain
from test_torch_train import GRAD_TOL, _batch, _jpaths, _port_grads
from repro.configs import get_config as jget_config
from repro.models import decode_many_batched as jdecode_many_batched
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.models import prefill as jprefill
from repro.models.kv_cache import fill_kv_cache as jfill
from repro.models.kv_cache import init_kv_cache as jinit_kv
from repro.models.kv_cache import update_kv_cache as jupdate
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.kv_cache import fill_kv_cache, init_kv_cache, \
    update_kv_cache
from repro_torch.models.model import decode_many_batched, decode_step, \
    init_decode_state, prefill
from repro_torch.serving import DyMoEEngine, EngineConfig, Request

W = 8
TOL = dict(atol=1e-5, rtol=1e-5)
_KV = ("k", "v", "positions", "length", "offset")


def _win(arch, low_bits=2):
    cfg = jget_config(arch).reduced()
    return dataclasses.replace(cfg, sliding_window=W, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=low_bits))


@functools.lru_cache(maxsize=None)
def _model(arch, low_bits=2):
    """(config, params, qparams) of a windowed reduced config, made once a
    module; the packed store is ``quantized_pair``'s, bitwise the
    reference's eager ``quantize_model``."""
    cfg = _win(arch, low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params, quantized_pair(params, cfg)[0]


# ------------------------------------------------------------ ring caches


@pytest.mark.parametrize("s", [5, W, 13, 3 * W])
def test_ring_cache_ops_match(s):
    """A ring of W slots filled with S keys (below, at and above W; 3W
    wraps to slot 0), then 11 decode writes with rows frozen at random:
    every field bitwise the JAX package's after every write."""
    rng = np.random.default_rng(s)
    b, h, d = 3, 2, 4
    k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(2))
    jc = jfill(jinit_kv(b, h, W, d, jnp.float32, ring=True),
               jnp.asarray(k), jnp.asarray(v))
    tc = fill_kv_cache(init_kv_cache(b, h, W, d, torch.float32, ring=True),
                       t(k), t(v))
    for step in range(12):
        assert tc.ring and jc.ring
        for f in _KV:
            np.testing.assert_array_equal(n(getattr(tc, f)),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f"{f} after {step}")
        kn, vn = (rng.standard_normal((b, h, 1, d)).astype(np.float32)
                  for _ in range(2))
        live = rng.random(b) > 0.3
        jc = jupdate(jc, jnp.asarray(kn), jnp.asarray(vn),
                     live=jnp.asarray(live))
        assert update_kv_cache(tc, t(kn), t(vn), live=t(live)) is tc
    assert (n(tc.positions) >= s - W).all()


def test_ring_fill_refusals():
    """More keys than slots need a ring, and a ring takes no ragged
    offsets; a windowed config's decode state is a ring of W slots only
    when asked for at least W (the reference's min(seq_len, W))."""
    k = torch.zeros((1, 1, W + 1, 2))
    with pytest.raises(AssertionError):
        fill_kv_cache(init_kv_cache(1, 1, W, 2, torch.float32), k, k)
    with pytest.raises(AssertionError):
        fill_kv_cache(init_kv_cache(1, 1, W, 2, torch.float32, ring=True),
                      k, k, offsets=torch.zeros(1, dtype=torch.int32))
    cfg = port_cfg(_win("zamba2_1p2b"))
    for seq_len, slots, ring in ((5, 5, False), (W, W, True),
                                 (64, W, True)):
        st = init_decode_state(cfg, 2, seq_len, "cpu")
        assert st["shared"].k.shape[-2] == slots
        assert st["shared"].ring == ring
        assert st["shared"].index(0).ring == ring


@pytest.mark.parametrize("over", [
    dict(sliding_window=W), dict(moe_dispatch_shards=2),
    dict(act_seq_shard=True)],
    ids=["window", "dispatch_shards", "act_seq_shard"])
def test_check_supported_refuses_only_sharding(over):
    """Nothing the JAX package serves on one device is refused any more: a
    window, the data-local MoE dispatch (2 token groups of 10) and the
    sequence-sharded residual each prefill a 20-token prompt ("4/2") to
    the JAX package's logits and telemetry."""
    cfg = dataclasses.replace(jget_config("olmoe_1b_7b").reduced(), **over)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    jqp, tqp = quantized_pair(params, cfg)
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size, (1, 20))
    slots = cfg.sliding_window or 24
    jl, _, ji = jit_run(lambda: jprefill(params, cfg, jnp.asarray(prompt),
                                         qparams=jqp, cache_slots=slots))
    tl, _, ti = prefill(port(params), port_cfg(cfg), t(prompt), qparams=tqp,
                        cache_slots=slots)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    for f in ("critical_masks", "active_masks", "expert_load"):
        np.testing.assert_array_equal(n(getattr(ti, f)),
                                      np.asarray(getattr(ji, f)), err_msg=f)


# ------------------------------------------------- prefill and decode chunk


@pytest.mark.parametrize("low_bits", [2, 0])
def test_prefill_and_decode_many_batched_match(low_bits):
    """Reduced OLMoE: a batch of 4 prompts of 2.5 W through the solo
    prefill (one Critical set; its ring keeps the last W keys), then 6
    steps of ``decode_many_batched`` over the ring with two dead rows
    (``live_cap`` 2 < B 4) and one row stopping mid-chunk."""
    cfg, params, qp = _model("olmoe_1b_7b", low_bits)
    tcfg, tparams, tqp = port_cfg(cfg), port(params), port(qp)
    b, s, steps = 4, 20, 6
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, (b, s))
    jl, jc, ji = jit_run(lambda: jprefill(params, cfg, jnp.asarray(prompt),
                                          qparams=qp))
    tl, tc, ti = prefill(tparams, tcfg, t(prompt), qparams=tqp)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    for f in ("critical_masks", "active_masks", "expert_load",
              "expert_hh_load"):
        np.testing.assert_array_equal(n(getattr(ti, f)),
                                      np.asarray(getattr(ji, f)), err_msg=f)
    assert jc["layers"].ring and tc["layers"].ring
    assert tc["layers"].k.shape[-2] == W

    def check_caches(tc, jc):
        for f in ("positions", "length", "offset"):
            np.testing.assert_array_equal(n(getattr(tc["layers"], f)),
                                          np.asarray(getattr(jc["layers"], f)),
                                          err_msg=f)
        for f in ("k", "v"):
            np.testing.assert_allclose(n(getattr(tc["layers"], f)),
                                       np.asarray(getattr(jc["layers"], f)),
                                       **TOL, err_msg=f)

    check_caches(tc, jc)
    tok0 = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    done = np.array([False, True, True, False])
    kw = dict(n_emitted=np.ones(b, np.int32),
              limits=np.array([12, 12, 12, 4], np.int32),
              eos_tokens=np.full(b, -1, np.int32))
    tcaches = port_caches(jc)
    jt, jc2, ji2, jd, je = jit_run(lambda: jdecode_many_batched(
        params, cfg, jnp.asarray(tok0), jc, num_steps=steps,
        done=jnp.asarray(done), qparams=qp, live_cap=2,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    tt, tc2, ti2, td, te = decode_many_batched(
        tparams, tcfg, t(tok0), tcaches, num_steps=steps, done=t(done),
        qparams=tqp, live_cap=2, **{k: t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(te), np.asarray(je))
    for f in ("critical_masks", "active_masks"):
        np.testing.assert_array_equal(n(getattr(ti2, f)),
                                      np.asarray(getattr(ji2, f)), err_msg=f)
    for f in ("gate_mean", "predicted_next"):
        np.testing.assert_allclose(n(getattr(ti2, f)),
                                   np.asarray(getattr(ji2, f)), **TOL,
                                   err_msg=f)
    check_caches(tc2, jc2)
    # row 0 wrote positions s .. s + 5, wrapping again: it holds the last W
    assert sorted(n(tc2["layers"].positions[0, 0])) == \
        list(range(s + steps - W, s + steps))


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "olmoe_1b_7b"])
def test_ring_decode_equals_windowed_prefill(arch):
    """``tests/test_consistency.py::test_ring_cache_matches_windowed_prefill``
    on the port: one decode step through a ring that has wrapped twice
    gives the logits of a windowed prefill of one more token (2e-3)."""
    jcfg, jparams, _ = _model(arch)
    cfg, params = port_cfg(jcfg), port(jparams)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 3 * W + 1)))
    full, _, _ = prefill(params, cfg, toks)
    _, caches, _ = prefill(params, cfg, toks[:, :3 * W])
    dec, _, _ = decode_step(params, cfg, toks[:, 3 * W], caches)
    assert (full - dec).abs().max().item() < 2e-3


# ----------------------------------------------------------------- engine


def _requests(cls, cfg):
    """More requests than slots, prompts of 2.5 W (the ring wraps at
    prefill and again in decode); on OLMoE one of W (the ring fills at
    prefill and wraps at the first decode step). The other families take
    one prompt length: one prefill compile of the JAX engine."""
    rng = np.random.default_rng(5)
    mid = W if cfg.is_moe else 20
    return [cls(prompt_tokens=[int(x) for x in rng.integers(
        1, cfg.vocab_size, s)], max_new_tokens=m, request_id=f"r{i}")
            for i, (s, m) in enumerate(((20, 9), (mid, 6), (20, 3)))]


@pytest.fixture(scope="module", params=["olmoe_1b_7b", "qwen3_0p6b",
                                        "zamba2_1p2b"])
def engines(request):
    cfg, params, qp = _model(request.param)
    return (JEngine(cfg, params, JEngineConfig(decode_chunk=4), qparams=qp),
            DyMoEEngine(port_cfg(cfg), port(params),
                        EngineConfig(decode_chunk=4), device="cpu",
                        qparams=port(qp)))


_FIELDS = ("tokens", "ttft_s", "tpot_s", "cache_stats", "prefill_timing",
           "decode_timings", "prefill_weight_bytes",
           "decode_weight_bytes_per_tok")


def _fields(r):
    return [plain(getattr(r, f)) for f in _FIELDS]


def test_engine_paths_equal_jax_engine(engines):
    """``generate_batch`` on 2 slots (solo admissions only: a ring takes
    no ragged wave; every session's cache is a ring of W slots) and
    ``generate_reference`` of the longest request equal the JAX engine's,
    and ``generate`` equals ``generate_reference``."""
    jeng, teng = engines
    v = teng.cfg
    jout = jeng.generate_batch(_requests(JRequest, v), num_slots=2)
    tout = teng.generate_batch(_requests(Request, v), num_slots=2)
    assert [_fields(r) for r in tout] == [_fields(r) for r in jout]
    st = teng.last_stats
    assert st["waves_batched"] == 0 and st["waves_solo"] == 3
    assert [s.slots_len for s in teng._decode_batched.states()] == [W]
    jr = jeng.generate_reference(_requests(JRequest, v)[0])
    ref = teng.generate_reference(_requests(Request, v)[0])
    assert _fields(ref) == _fields(jr)
    got = teng.generate(_requests(Request, v)[0])
    assert got.tokens == ref.tokens and got.ttft_s == ref.ttft_s
    assert got.tpot_s == pytest.approx(ref.tpot_s, rel=1e-12)


@pytest.mark.parametrize("engines", ["olmoe_1b_7b"], indirect=True)
def test_static_batch_and_open_session_equal_jax(engines):
    """On the OLMoE pair (the session's machinery is the same for every
    family):
    ``generate_batch(static=True)`` over two equal-length prompts (a ring
    takes no ragged batch), and an open session with a default slot
    budget (the window): three submits on 2 slots, a step, a cancel in
    flight, a late submit, drain — outcomes and streams with ``==``."""
    jeng, teng = engines
    v = teng.cfg

    def static(cls):
        return [dataclasses.replace(r, max_new_tokens=m) for r, m in
                zip(_requests(cls, v)[::2], (7, 5))]

    jout = jeng.generate_batch(static(JRequest), static=True)
    tout = teng.generate_batch(static(Request), static=True)
    assert [r.tokens for r in tout] == [r.tokens for r in jout]

    def run(eng, cls, **kw):
        s = eng.serve(num_slots=2, **kw)
        reqs = _requests(cls, v)
        late = dataclasses.replace(reqs[0], request_id="late",
                                   max_new_tokens=5)
        hs = [s.submit(r) for r in reqs]
        s.step()
        hs[0].cancel()
        hs.append(s.submit(late))
        s.drain(cancel_queued=False)
        return [outcome(h) for h in hs], [events(h) for h in hs]

    assert run(teng, Request) == run(jeng, JRequest, pipeline=False)
    assert teng._session._slots_len == W


# --------------------------------------------------------------- training


def test_windowed_loss_and_grads_match_reference():
    """``loss_fn`` and every gradient leaf on windowed reduced OLMoE (a
    16-token batch: the window masks half of each row's keys) against
    ``jax.value_and_grad`` of the reference's."""
    cfg, params, _ = _model("olmoe_1b_7b")
    batch = _batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, cfg, bt), has_aux=True))(
            params, {k: jnp.asarray(x) for k, x in batch.items()})
    loss, metrics, grads = _port_grads(port(params), port_cfg(cfg), batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5)
    jflat = _jpaths(jgrads)
    assert set(grads) == set(jflat)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jflat[k], err_msg=k, **GRAD_TOL)
