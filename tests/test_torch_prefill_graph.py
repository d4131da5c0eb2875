"""The compiled prefill (``repro_torch/serving/compiled.py::CompiledPrefill``,
the engine's ``_prefill``) on the CPU, where it runs its static-input,
fixed-output protocol with an eager prefill in place of a CUDA graph
replay: one entry per key (prompt shape, ``cache_slots``, ``row_local``,
which inputs are given); a key's first call returns a plain eager
prefill's outputs, its second sets up the key's fixed outputs (a capture
on the card), and each later call overwrites them.

Against the JAX engine's jitted ``_prefill`` from the same numpy-made
params, three calls of one key each (the third overwrites the second's
outputs): the tiny MoE of ``tests/test_decode_many.py::_moe_cfg`` as a
row-local ragged wave and as a solo prefill, "4/2" and "4/0"; reduced
qwen3_0p6b as a wave; reduced zamba2_1p2b (shared-attention KV) and
falcon_mamba_7b solo. Tolerances: greedy tokens, Critical/active masks,
expert loads and cache positions/lengths/offsets exact; logits, the float
telemetry and the cache leaves within atol = rtol = 1e-5 (f32). Then: a
call equals a fresh eager ``prefill`` bitwise (tokens and ``embeds``);
the entries stay bounded, least recently used dropped;
``generate_reference`` prefills through it; on a warm engine, two
admissions of one boundary with one prompt length (one key) on a Mamba
config each get their own caches, tokens and modeled numbers equal to
the JAX engine's; an out-of-memory error from the prefill halves the
wave through the admission ladder, as an injected ``admit.alloc`` fault
does in the JAX session, and leaves the session's decode state
untouched. (The graph
replay against the eager prefill on the card is in
``tests/test_torch_cuda.py``.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import n, numpy_init, port, port_cfg
from _torch_serving import Pair, health, outcome, script
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import quantize_model as jquantize_model
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.models.layers.moe import _capacity
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.kv_cache import cache_tensors
from repro_torch.models.model import prefill
from repro_torch.serving import ContinuousBatchingScheduler, DyMoEEngine, \
    EngineConfig, Request
from repro_torch.serving import compiled as compiled_mod

TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS = 20
_EXACT = ("critical_masks", "active_masks", "expert_load", "expert_hh_load",
          "positions", "length", "offset")


def _moe_cfg(low_bits):
    """``tests/test_decode_many.py::_moe_cfg`` in "4/2" or "4/0"."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


def _engines(cfg, decode_chunk=4):
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    qp = jquantize_model(params, cfg)
    return (JEngine(cfg, params, JEngineConfig(decode_chunk=decode_chunk),
                    qparams=qp),
            DyMoEEngine(port_cfg(cfg), port(params),
                        EngineConfig(decode_chunk=decode_chunk),
                        device="cpu", qparams=port(qp)))


# case -> (config, "wave" | "solo")
CASES = {"tiny-4/2-wave": (lambda: _moe_cfg(2), "wave"),
         "tiny-4/0-wave": (lambda: _moe_cfg(0), "wave"),
         "tiny-4/2-solo": (lambda: _moe_cfg(2), "solo"),
         "tiny-4/0-solo": (lambda: _moe_cfg(0), "solo"),
         "qwen3_0p6b-wave": (lambda: jget_config("qwen3_0p6b").reduced(),
                             "wave"),
         "zamba2_1p2b-solo": (lambda: jget_config("zamba2_1p2b").reduced(),
                              "solo"),
         "falcon_mamba_7b-solo": (
             lambda: jget_config("falcon_mamba_7b").reduced(), "solo")}


def _inputs(cfg, mode, seed):
    """A solo prompt (1, 13), or a right-aligned wave of lengths 11, 4, 7
    with its lengths and (MoE) exact host row capacities."""
    rng = np.random.default_rng(seed)
    if mode == "solo":
        return rng.integers(1, cfg.vocab_size, (1, 13)), {}
    lens = np.array([11, 4, 7], np.int32)
    prompt = np.zeros((3, 11), np.int64)
    for i, s in enumerate(lens):
        prompt[i, 11 - s:] = rng.integers(1, cfg.vocab_size, s)
    kw = dict(lengths=lens, row_local=True)
    if cfg.arch_type == "moe":
        kw["row_capacities"] = np.array([_capacity(cfg, int(s))
                                         for s in lens], np.int64)
    return prompt, kw


def _check(out, jl, jc, ji):
    """The port's fixed outputs against the JAX engine's prefill."""
    np.testing.assert_array_equal(n(out.logits).argmax(-1),
                                  np.asarray(jnp.argmax(jl, axis=-1)))
    np.testing.assert_allclose(n(out.logits), np.asarray(jl), **TOL)
    assert sorted(out.caches) == sorted(jc)
    pairs = [(f"{part}.{f}", x, getattr(jc[part], f))
             for part, c in out.caches.items()
             for f, x in cache_tensors(c)]
    pairs += [(f.name, getattr(out.info, f.name), getattr(ji, f.name))
              for f in dataclasses.fields(out.info)]
    for name, got, want in pairs:
        if want is None:
            assert got is None, name
        elif name.split(".")[-1] in _EXACT:
            np.testing.assert_array_equal(n(got), np.asarray(want),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(n(got), np.asarray(want), **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_prefill_equals_jax_prefill(case):
    """Three calls of one key (new prompts each time): each call's outputs
    equal the JAX engine's jitted prefill of its inputs; the first call's
    are its own, the second sets up the key's fixed outputs and the third
    returns the same tensors, overwritten."""
    make, mode = CASES[case]
    cfg = make()
    jeng, teng = _engines(cfg)
    first = None
    for seed in (2, 3, 4):
        prompt, kw = _inputs(cfg, mode, seed)
        jkw = {k: jnp.asarray(v, jnp.int32) if k != "row_local" else v
               for k, v in kw.items()}
        jl, jc, ji = jeng._prefill(jeng.params, tokens=jnp.asarray(
            prompt, jnp.int32), qparams=jeng.qparams, cache_slots=SLOTS,
            **jkw)
        out = teng._prefill(prompt, cache_slots=SLOTS, **kw)
        _check(out, jl, jc, ji)
        if seed == 3:
            first = out.tensors()
        elif seed == 4:
            assert all(a is b for a, b in zip(out.tensors(), first))
    assert teng._prefill.compiles == 1
    (key,) = teng._prefill.entries()
    assert key == (*prompt.shape, SLOTS, mode == "wave", mode == "wave",
                   "row_capacities" in kw, None)


def _tiny_port(low_bits=2):
    return _engines(_moe_cfg(low_bits))[1]


def test_second_call_equals_fresh_eager_prefill():
    """Every call of a key (tokens), and of an ``embeds`` key — the first,
    the second that sets up the fixed outputs and the third into them —
    gives what a fresh eager ``prefill`` of the same inputs gives,
    bitwise; ``generate_reference`` prefills through the engine's
    compiled prefill with ``cache_slots`` = prompt + new (a new key: no
    fixed outputs yet)."""
    eng = _tiny_port()
    cp, cfg = eng._prefill, eng.cfg
    rng = np.random.default_rng(4)

    def eager(**kw):
        logits, caches, info = prefill(eng.params, cfg, qparams=eng.qparams,
                                       cache_slots=SLOTS, **kw)
        return compiled_mod.PrefillOut(logits, caches, info).tensors()

    for call in range(3):
        prompt = rng.integers(1, cfg.vocab_size, (2, 9))
        embeds = torch.from_numpy(rng.standard_normal(
            (1, 6, cfg.d_model)).astype(np.float32))
        got = cp(prompt, cache_slots=SLOTS).tensors()
        want = eager(tokens=torch.from_numpy(prompt))
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = cp(embeds=embeds, cache_slots=SLOTS).tensors()
        assert all(torch.equal(a, b)
                   for a, b in zip(got, eager(embeds=embeds)))
    assert cp.compiles == 2 and len(cp.entries()) == 2
    req = Request(prompt_tokens=[5, 6, 7, 8, 9], max_new_tokens=4)
    eng.generate_reference(req)
    assert cp.compiles == 2
    key, entry = list(cp.entries().items())[-1]
    assert key == (1, 5, 9, False, False, False, None)
    assert entry.out is None


def test_entries_stay_bounded():
    """With ``max_entries`` 3, prompts of five lengths keep the three most
    recently used keys; a kept key met again sets up its fixed outputs
    (a compile), a dropped one met again starts over with an eager call,
    and compiles at its next call."""
    eng = _tiny_port()
    cp = eng._prefill
    cp.max_entries = 3
    rng = np.random.default_rng(5)
    for s in (4, 5, 6, 7, 8, 6):
        cp(rng.integers(1, 256, (1, s)), cache_slots=SLOTS)
        assert len(cp.entries()) <= 3
    assert cp.compiles == 1
    assert [k[1] for k in cp.entries()] == [7, 8, 6]
    assert [e.out is not None for e in cp.entries().values()] == \
        [False, False, True]
    cp(rng.integers(1, 256, (1, 4)), cache_slots=SLOTS)
    assert cp.compiles == 1
    assert [k[1] for k in cp.entries()] == [8, 6, 4]
    cp(rng.integers(1, 256, (1, 4)), cache_slots=SLOTS)
    assert cp.compiles == 2
    assert cp.pool_bytes() == 0             # no graphs on the CPU


_FIELDS = ("tokens", "ttft_s", "tpot_s", "cache_stats", "prefill_timing",
           "decode_timings", "prefill_weight_bytes",
           "decode_weight_bytes_per_tok")


def test_same_length_admissions_on_ssm_each_get_their_caches(monkeypatch):
    """Reduced falcon_mamba_7b (Mamba1) on 2 slots: the first boundary
    admits two requests of one prompt length, one solo prefill each, both
    of one key. The batch runs twice on one engine: the first run sets up
    the key's fixed outputs, so in the second both admissions replay into
    them. Each wave's rows are injected before the next wave's prefill
    overwrites the key's caches: at the second run's first decode chunk
    each slot holds its own request's prefill state, bitwise an eager
    ``prefill``'s, and every request's tokens and modeled numbers equal
    the JAX engine's in both runs."""
    jeng, teng = _engines(jget_config("falcon_mamba_7b").reduced())
    rng = np.random.default_rng(6)
    spec = [(rng.integers(1, teng.cfg.vocab_size, 9).tolist(), m)
            for m in (6, 5, 4)]
    inner, seen = ContinuousBatchingScheduler._dispatch_chunk, []

    def dispatch(self):
        c = self._state.caches["layers"]
        seen.append((c.conv_state.clone(), c.ssm_state.clone()))
        inner(self)

    monkeypatch.setattr(ContinuousBatchingScheduler, "_dispatch_chunk",
                        dispatch)

    def fields(r):
        return [dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
                for x in (getattr(r, f) for f in _FIELDS)]

    jout = jeng.generate_batch([JRequest(prompt_tokens=p, max_new_tokens=m)
                                for p, m in spec], num_slots=2)
    compiles = []
    for run in range(2):
        del seen[:]
        tout = teng.generate_batch([Request(prompt_tokens=p,
                                            max_new_tokens=m)
                                    for p, m in spec], num_slots=2)
        assert [fields(r) for r in tout] == [fields(r) for r in jout]
        assert teng.last_stats["waves_solo"] == 3
        compiles.append(teng.last_stats["prefill_compiles"])
    assert compiles == [1, 0]                     # one key
    conv, state = seen[0]
    for r, (p, m) in enumerate(spec[:2]):
        _, caches, _ = prefill(teng.params, teng.cfg, torch.tensor([p]),
                               qparams=teng.qparams, cache_slots=16)
        assert torch.equal(conv[:, r], caches["layers"].conv_state[:, 0])
        assert torch.equal(state[:, r], caches["layers"].ssm_state[:, 0])


def _snapshot(session):
    return [t.clone() for c in session._state.caches.values()
            for _, t in cache_tensors(c)]


def _serve_two_boundaries(pair, which, faults=(), on_start=None):
    """Two requests admitted and decoding, then three more into the two
    free slots and the queue: the second boundary's wave is of two."""
    s = pair.serve(which, faults=faults, num_slots=4, slots_len=64)
    if on_start is not None:
        on_start(s)
    reqs = script(which)
    hs = [s.submit(dataclasses.replace(r, max_new_tokens=12))
          for r in reqs[:2]]
    s.step()
    hs += [s.submit(r) for r in reqs[2:5]]
    s.drain(cancel_queued=False)
    hl = health(s)
    s.close()
    return [outcome(h) for h in hs], hl


def test_oom_from_prefill_halves_the_wave(monkeypatch):
    """A ``torch.OutOfMemoryError`` raised from the second boundary's
    prefill (a wave of two) is retried by the admission ladder as two solo
    waves: every handle and the health counters equal the JAX session's
    with an ``admit.alloc`` fault at that wave (but ``last_fault``), and
    the session's decode state is the same at the failed call as at the
    retry's."""
    pair = Pair(low_bits=2)
    want, jhealth = _serve_two_boundaries(
        pair, "jax", faults=[("admit.alloc", dict(at=1))])
    inner, calls, held = compiled_mod.prefill, [], {}

    def flaky(params, cfg, tokens=None, **kw):
        calls.append(_snapshot(held["s"]))
        if len(calls) == 2:
            assert tokens.shape[0] == 2            # the second wave
            raise torch.OutOfMemoryError("out of memory")
        return inner(params, cfg, tokens, **kw)

    monkeypatch.setattr(compiled_mod, "prefill", flaky)
    got, thealth = _serve_two_boundaries(
        pair, "port", on_start=lambda s: held.update(s=s))
    assert got == want
    assert thealth["admission_retries"] == 1 == jhealth["admission_retries"]
    assert "OutOfMemoryError" in thealth["last_fault"]
    assert {k: v for k, v in thealth.items() if k != "last_fault"} == \
        {k: v for k, v in jhealth.items() if k != "last_fault"}
    # waves: 2; the failed 2; 1 and 1; the last request
    assert len(calls) == 5
    assert all(torch.equal(a, b) for a, b in zip(calls[1], calls[2]))
