"""The compiled ``decode_many`` (``serving/compiled.py::CompiledDecodeMany``,
``engine._decode_many``: the chunks of ``generate_reference`` and of the
static batch) run through its static-buffer protocol on the CPU, where it
calls ``decode_many`` eagerly: a key's first call returns eager outputs,
its second sets up fixed outputs that later calls refill; a state's keys
and the idle states stay bounded; a state holds copies of the prefill's
caches, never the prefill's own outputs, and a held state goes to no
other caller; and ``decode_chunk`` 1 equals 16, for the reference and the
static batch. (The CUDA graph replay against eager is
``tests/test_torch_cuda.py::test_cuda_compiled_decode_many_equals_eager``;
parity with the JAX engine is in ``test_torch_reference.py`` and
``test_torch_fullprec.py``.) Tolerance: none."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models.config import DyMoEPolicy, ModelConfig
from repro_torch.models.kv_cache import cache_tensors
from repro_torch.models.model import decode_many, init_params, prefill
from repro_torch.serving import DyMoEEngine, EngineConfig, Request


def _cfg(enabled=True):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=2, d_model=64, vocab_size=128,
        num_heads=2, num_kv_heads=1, head_dim=32, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=2, retention=0.75, enabled=enabled))


@pytest.fixture(scope="module")
def params():
    return init_params(_cfg(), torch.Generator().manual_seed(0), "cpu")


def _engine(params, chunk=4, use_dymoe=True):
    return DyMoEEngine(_cfg(use_dymoe), params, EngineConfig(
        decode_chunk=chunk, use_dymoe=use_dymoe), device="cpu")


def _requests(n=4):
    rng = np.random.default_rng(2)
    return [Request(prompt_tokens=[int(v) for v in rng.integers(1, 128, s)],
                    max_new_tokens=m, **kw)
            for s, m, kw in ((7, 9, {}), (11, 6, dict(temperature=0.8,
                                                       top_k=5, seed=3)),
                             (4, 12, {}), (9, 5, dict(temperature=1.1,
                                                      seed=8)))[:n]]


def _ptrs(caches):
    return {x.untyped_storage().data_ptr()
            for c in caches.values() for _, x in cache_tensors(c)}


def test_key_protocol_equals_eager(params):
    """One state, one key called three times from a copy of the same
    prefill caches as an eager reference: the first call's outputs are
    eager ones (no compile), the second's are the key's fixed outputs
    (one compile), the third refills the same tensors; every call's
    tokens, telemetry and caches equal eager ``decode_many``'s."""
    eng = _engine(params)
    cm = eng._decode_many
    cfg = eng.cfg
    prompt = torch.tensor([[5, 9, 2, 7, 1, 3]])
    logits, rc, _ = prefill(eng.params, cfg, prompt, qparams=eng.qparams,
                            cache_slots=24)
    ref = {"layers": dataclasses.replace(rc["layers"], **{
        f: x.clone() for f, x in cache_tensors(rc["layers"])})}
    state = cm.acquire(1, 24, caches=rc)
    assert not _ptrs(rc) & _ptrs(state.caches)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    key = np.array([0, 4], np.int64)
    outs = []
    for call in range(3):
        start = 1 + 3 * call
        want_t, _, want_i = decode_many(
            eng.params, cfg, tok.clone(), ref, num_steps=3, start_step=start,
            qparams=eng.qparams, rng_key=torch.from_numpy(key),
            temperature=0.9, top_k=7)
        out = cm(state, tok, num_steps=3, start_step=start, rng_key=key,
                 temperature=0.9, top_k=7)
        assert torch.equal(out.tokens, want_t)
        assert torch.equal(out.info.critical_masks, want_i.critical_masks)
        assert torch.equal(out.info.gate_mean, want_i.gate_mean)
        for f in ("k", "v", "positions", "length"):
            assert torch.equal(getattr(state.caches["layers"], f),
                               getattr(ref["layers"], f)), f
        outs.append(out)
        assert cm.compiles == min(call, 1)
        tok = out.tokens[-1].clone()
    assert outs[1] is outs[2] and outs[0] is not outs[1]
    (entry,) = state.entries.values()
    assert entry.out is outs[1] and entry.graph is None
    cm.release(state)


def test_keys_and_states_stay_bounded(params):
    """Keys beyond ``max_entries`` in one state drop the least recently
    used; ``generate_reference`` over many prompt lengths (a state per
    cache size) keeps at most ``max_idle_states`` states once released;
    a held state goes to no other caller."""
    eng = _engine(params)
    cm = eng._decode_many
    cm.max_entries = 3
    st = cm.acquire(1, 16)
    tok = torch.tensor([3], dtype=torch.int32)
    for steps in (1, 2, 3, 4, 1, 5):
        cm(st, tok, num_steps=steps)
        assert len(st.entries) <= 3
    assert [k[0] for k in st.entries] == [4, 1, 5]
    other = cm.acquire(1, 16)
    assert other is not st
    cm.release(st)
    cm.release(other)
    assert cm.acquire(1, 16) in (st, other)
    cm.max_entries = 8
    rng = np.random.default_rng(4)
    for s in range(3, 12):
        eng.generate_reference(Request(
            prompt_tokens=[int(v) for v in rng.integers(1, 128, s)],
            max_new_tokens=3))
    assert len([x for x in cm.states() if not x.held]) <= \
        cm.max_idle_states


def test_reference_state_aliases_no_prefill_output(params):
    """``generate_reference`` and the static batch copy their prefill's
    caches into a state they hold: the state shares no storage with the
    compiled prefill's outputs, which the next prefill overwrites."""
    eng = _engine(params)
    seen = []
    prefill_call, acquire = eng._prefill.__call__, eng._decode_many.acquire

    class Spy:
        def __call__(self, *a, **kw):
            out = prefill_call(*a, **kw)
            seen.append(("prefill", _ptrs(out.caches)))
            return out

    def spy_acquire(*a, **kw):
        st = acquire(*a, **kw)
        seen.append(("state", _ptrs(st.caches)))
        return st

    eng._prefill = Spy()
    eng._decode_many.acquire = spy_acquire
    eng.generate_reference(_requests(1)[0])
    eng.generate_batch(_requests(), static=True)
    kinds = [k for k, _ in seen]
    assert kinds == ["prefill", "state", "prefill", "state"]
    for (_, pre), (_, st) in zip(seen[::2], seen[1::2]):
        assert not pre & st


@pytest.mark.parametrize("use_dymoe", [True, False], ids=["4/2", "off"])
def test_decode_chunk_1_equals_16(params, use_dymoe):
    """Chunking changes neither the reference's tokens and modeled numbers
    nor the static batch's tokens (counter-derived PRNG streams)."""
    e1 = _engine(params, chunk=1, use_dymoe=use_dymoe)
    e16 = _engine(params, chunk=16, use_dymoe=use_dymoe)
    for r in _requests():
        a, b = e1.generate_reference(r), e16.generate_reference(r)
        assert (a.tokens, a.ttft_s, a.tpot_s, a.cache_stats) == \
            (b.tokens, b.ttft_s, b.tpot_s, b.cache_stats)
    assert [r.tokens for r in e1.generate_batch(_requests(), static=True)] \
        == [r.tokens for r in e16.generate_batch(_requests(), static=True)]
