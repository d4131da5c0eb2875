"""The compiled decode chunk (``repro_torch/serving/compiled.py``) on the
CPU, where it runs its static-buffer protocol with an eager call in place
of a CUDA graph replay: engine-owned decode states reused across sessions
(one per live session, the idle ones bounded), fixed outputs overwritten
in place, one entry per (num_steps, live_cap, sampled) key. On the tiny MoE of ``tests/test_decode_many.py::_moe_cfg``
two ``generate_batch`` sessions back to back on one engine each give the
JAX engine's tokens, Critical/active masks and modeled TTFT/TPOT exactly,
greedy and seeded sampled rows mixed, in "4/2" and "4/0". Tolerance: none
— tokens, masks and the modeled numbers are compared with ``==``. (The
graph replay against the eager chunk on the card is in
``tests/test_torch_cuda.py``.)"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import numpy_init, port, port_cfg
from repro.models import init_params as jinit_params
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.models.model import init_decode_state
from repro_torch.serving import DyMoEEngine, EngineConfig, Request
from repro_torch.serving.compiled import slot_bucket
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, \
    live_cap_for

# (prompt length, max_new_tokens, temperature, top_k, seed): two request
# sets with one slot budget (max prompt + new = 21, 32 slots), so both
# sessions run on the same engine-owned decode state
SET_A = [(7, 5, 0.0, 0, None), (12, 9, 0.7, 0, 11), (3, 12, 0.0, 0, None),
         (9, 4, 0.7, 20, 12), (12, 6, 0.0, 0, None)]
SET_B = [(10, 11, 0.7, 20, 21), (5, 7, 0.0, 0, None), (12, 9, 0.0, 0, None),
         (4, 3, 1.3, 0, 22), (8, 13, 0.0, 0, None)]
_FIELDS = ("ttft_s", "tpot_s", "cache_stats", "prefill_weight_bytes",
           "decode_weight_bytes_per_tok")


def _cfg(low_bits):
    """``tests/test_decode_many.py::_moe_cfg`` at ``low_bits``."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


def _requests(cls, spec, seed):
    rng = np.random.default_rng(seed)
    return [cls(prompt_tokens=[int(v) for v in rng.integers(1, 256, s)],
                max_new_tokens=m, temperature=t, top_k=k, seed=sd)
            for s, m, t, k, sd in spec]


def _recording(engine, log):
    """Log each ``engine._replay`` call's masks before replaying them."""
    inner = engine._replay

    def rec(crit, active, pred, **kw):
        log.append((kw["phase"], np.asarray(crit, bool),
                    np.asarray(active, bool)))
        return inner(crit, active, pred, **kw)

    engine._replay = rec


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _engine(low_bits, decode_chunk, qparams=None):
    cfg = _cfg(low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    return DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
        decode_chunk=decode_chunk), device="cpu", qparams=qparams), params


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
def test_two_sessions_on_one_engine_equal_jax_engine(low_bits):
    """Session A then session B on one port engine over 2 slots: each
    equals the JAX engine's run of the same requests (tokens, the masks of
    every replayed wave and chunk, every modeled field); B runs on A's
    decode state, reset, and reuses A's compiled entries."""
    eng, params = _engine(low_bits, 4)
    jeng = JEngine(_cfg(low_bits), params, JEngineConfig(decode_chunk=4))
    tlog, jlog = [], []
    _recording(eng, tlog)
    _recording(jeng, jlog)
    compiled = eng._decode_batched
    seen = set()
    for spec, seed in ((SET_A, 1), (SET_B, 2)):
        tlog.clear()
        jlog.clear()
        jout = jeng.generate_batch(_requests(JRequest, spec, seed),
                                   num_slots=2)
        tout = eng.generate_batch(_requests(Request, spec, seed),
                                  num_slots=2)
        assert [r.tokens for r in tout] == [r.tokens for r in jout]
        assert [len(r.tokens) for r in tout] == [m for _, m, *_ in spec]
        assert len(tlog) == len(jlog)
        for (tp, tc, ta), (jp, jc, ja) in zip(tlog, jlog):
            assert tp == jp
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(ta, ja)
        for tr, jr in zip(tout, jout):
            for f in _FIELDS:
                assert _plain(getattr(tr, f)) == _plain(getattr(jr, f)), f
        (state,) = compiled.states()           # one (slots, slots_len)
        keys = set(state.entries)
        assert eng.last_stats["compiles"] == len(keys - seen)
        seen = keys
    assert eng.last_stats["chunks"] > eng.last_stats["compiles"]
    assert {sampled for _, _, sampled in seen} == {False, True}


def test_chunk_length_invariance_through_compiled_chunk():
    """``decode_chunk`` 1 and 16 give the same tokens through the compiled
    chunk, greedy and sampled rows mixed, over 3 slots."""
    eng16, _ = _engine(2, 16)
    eng1, _ = _engine(2, 1, qparams=eng16.qparams)
    reqs = _requests(Request, SET_A + SET_B, 3)
    out16 = eng16.generate_batch(reqs, num_slots=3)
    out1 = eng1.generate_batch(reqs, num_slots=3)
    assert [r.tokens for r in out1] == [r.tokens for r in out16]
    assert {k[0] for s in eng1._decode_batched.states()
            for k in s.entries} == {1}
    assert {k[0] for s in eng16._decode_batched.states()
            for k in s.entries} == {16}


@pytest.mark.parametrize("num_slots", [3, 4])
def test_compiled_entries_bounded_after_ragged_run(num_slots):
    """After a ragged run (live rows draining from B to 1) a decode state
    holds at most (ceil(log2 B) + 1) × 2 entries per ``num_steps``, all on
    the live-cap ladder; a second identical run adds none, gives the same
    tokens and writes into the same fixed outputs, which a later call of
    each key returns, overwritten."""
    eng, _ = _engine(2, 2)
    reqs = _requests(Request, SET_B + SET_A, 4)
    first = [r.tokens for r in eng.generate_batch(reqs, num_slots=num_slots)]
    (state,) = eng._decode_batched.states()
    bound = (math.ceil(math.log2(num_slots)) + 1) * 2
    ladder = {live_cap_for(n, num_slots) for n in range(1, num_slots + 1)}
    assert len(state.entries) <= bound
    assert {cap for _, cap, _ in state.entries} <= ladder
    assert len({cap for _, cap, _ in state.entries}) > 1
    outs = {k: [t.data_ptr() for t in e.out.tensors()]
            for k, e in state.entries.items()}
    again = [r.tokens for r in eng.generate_batch(reqs, num_slots=num_slots)]
    assert again == first
    assert eng.last_stats["compiles"] == 0
    assert {k: [t.data_ptr() for t in e.out.tensors()]
            for k, e in state.entries.items()} == outs
    # a call of a known key returns that key's fixed outputs, overwritten
    for key, entry in state.entries.items():
        steps, cap, sampled = key
        b = num_slots
        kw = dict(done=np.ones(b, bool), n_emitted=np.zeros(b, np.int32),
                  limits=np.ones(b, np.int32),
                  eos_tokens=np.full(b, -1, np.int32))
        if sampled:
            kw.update(rng_keys=np.zeros((b, 2), np.int64),
                      temperatures=np.zeros(b, np.float32),
                      top_ks=np.zeros(b, np.int64))
        tok = torch.full((b,), 7, dtype=torch.int32)
        out = eng._decode_batched(state, tok, num_steps=steps, live_cap=cap,
                                  **kw)
        assert out is entry.out and bool((out.tokens == 7).all())


def test_tok_d_shares_no_storage_with_compiled_outputs():
    """The session's next-token buffer is its own: it shares storage with
    no compiled output and no static input (the next chunk overwrites
    those)."""
    eng, _ = _engine(0, 4)
    sched = ContinuousBatchingScheduler(eng, num_slots=2)
    sched.run(_requests(Request, SET_A, 5))
    ptr = sched._tok_d.untyped_storage().data_ptr()
    (state,) = eng._decode_batched.states()
    others = [t for e in state.entries.values() for t in e.out.tensors()]
    others += list(state.inputs.values())
    assert state.entries and all(
        t.untyped_storage().data_ptr() != ptr for t in others)


def test_acquire_resets_the_engine_owned_state():
    """``acquire`` after ``release`` hands out the same decode state for
    the same (slots, slots_len), reset to ``init_decode_state``'s values;
    while a session holds it, another acquire gets a state of its own."""
    eng, _ = _engine(2, 4)
    compiled = eng._decode_batched
    state = compiled.acquire(2, 16)
    c = state.caches["layers"]
    for t in (c.k, c.v, c.positions, c.length, c.offset):
        t.fill_(3)
    other = compiled.acquire(2, 16)
    assert other is not state and state.held and other.held
    compiled.release(state)
    assert not state.held and compiled.acquire(2, 16) is state
    fresh = init_decode_state(eng.cfg, 2, 16, "cpu")["layers"]
    for f in ("k", "v", "positions", "length", "offset"):
        assert torch.equal(getattr(c, f), getattr(fresh, f)), f


def test_interleaved_sessions_on_one_engine_keep_their_own_state():
    """Two sessions of the same (slots, slots_len) stepped in turns on one
    engine each hold a decode state of their own and give what each gives
    alone (tokens and every modeled field); closed, both states stay kept
    for later sessions."""
    eng, _ = _engine(2, 4)
    alone = [eng.generate_batch(_requests(Request, spec, seed), num_slots=2)
             for spec, seed in ((SET_A, 1), (SET_B, 2))]
    a = ContinuousBatchingScheduler(eng, num_slots=2)
    b = ContinuousBatchingScheduler(eng, num_slots=2)
    ha = [a.submit(r) for r in _requests(Request, SET_A, 1)]
    hb = [b.submit(r) for r in _requests(Request, SET_B, 2)]
    assert a._state is not b._state
    busy = True
    while busy:
        busy = a.step() | b.step()
    for handles, want in zip((ha, hb), alone):
        got = [h.result() for h in handles]
        assert [r.tokens for r in got] == [r.tokens for r in want]
        for tr, wr in zip(got, want):
            for f in _FIELDS:
                assert _plain(getattr(tr, f)) == _plain(getattr(wr, f)), f
    held = [a._state, b._state]
    a.close()
    b.close()
    kept = eng._decode_batched.states()
    assert all(any(s is k for k in kept) for s in held)
    assert not any(s.held for s in kept)
    with pytest.raises(RuntimeError, match="closed"):
        a.submit(Request(prompt_tokens=[1, 2], max_new_tokens=2))


def test_decode_states_stay_bounded_over_varied_lengths():
    """Sessions whose slot budgets all differ: each asks for its budget
    rounded up to a power of two, so keys recur, and the engine keeps at
    most ``max_idle_states`` decode states (least recently used dropped),
    each with at most (ceil(log2 B) + 1) × 2 entries."""
    assert [slot_bucket(n, 4096) for n in (1, 2, 3, 21, 32, 33, 547)] == \
        [1, 2, 4, 32, 32, 64, 1024]
    assert slot_bucket(3000, 2048) == 3000 and slot_bucket(1500, 1024) == 1500
    eng, _ = _engine(2, 4)
    compiled = eng._decode_batched
    compiled.max_idle_states = 2
    rng = np.random.default_rng(6)
    lens, buckets = set(), []
    for i in range(12):
        spec = [(int(rng.integers(2, 6 + 6 * i)), int(rng.integers(2, 6)),
                 0.0, 0, None) for _ in range(3)]
        need = max(p + m for p, m, *_ in spec)
        lens.add(need)
        out = eng.generate_batch(_requests(Request, spec, i), num_slots=2)
        assert [len(r.tokens) for r in out] == [m for _, m, *_ in spec]
        buckets.append(slot_bucket(need, eng.cfg.max_seq_len))
        states = compiled.states()
        assert len(states) <= 2 and not any(s.held for s in states)
        assert states[-1].slots_len == buckets[-1]
        assert all(len(s.entries) <= 2 * 2 for s in states)
    assert len(lens) > len(set(buckets)) > 2
