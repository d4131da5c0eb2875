"""Helpers the port's open-session parity tests share: one tiny MoE (the
JAX package's ``tests/test_faults.py`` fixture, 2 layers, d_model 64, 4
experts top-2) served by the JAX engine and by the port's engine on the
CPU (both ``pipeline=False``, the inline replay, unless a test asks for
the pipelined worker), from the same numpy-made
params; and the outcome of every handle as plain values, so the two
sessions compare with ``==`` (tokens, typed-error classes, result flags
and modeled numbers exactly; NaN stands for itself)."""
import dataclasses
import math

import jax
import numpy as np

from _torch_bridge import numpy_init, port, port_cfg
from repro.models import init_params as jinit_params
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeProfile as JProfile
from repro.serving.faults import FaultInjector as JInjector
from repro.serving.faults import FaultSpec as JSpec
from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig, \
    FaultInjector, FaultSpec, Request


def tiny_cfg(low_bits=2):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=2, d_model=64, vocab_size=128,
        num_heads=2, num_kv_heads=1, head_dim=32, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


class Pair:
    """The JAX engine and the port's engine (CPU) of one config, each with
    a 16 GiB edge profile and 4-step chunks, as ``tests/test_faults.py``
    has them. ``serve`` opens one session on each, with ``faults`` (a list
    of ``(site, kwargs)``) as a fresh injector of each package."""

    def __init__(self, low_bits=2, decode_chunk=4):
        cfg = tiny_cfg(low_bits)
        params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
        self.jax = JEngine(cfg, params, JEngineConfig(
            profile=JProfile().with_vram(16), decode_chunk=decode_chunk))
        self.port = DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
            profile=EdgeProfile().with_vram(16),
            decode_chunk=decode_chunk), device="cpu")

    def serve(self, which, faults=(), seed=0, pipeline=False, **kw):
        eng = getattr(self, which)
        if which == "jax":
            eng.faults = JInjector([JSpec(site=s, **k) for s, k in faults],
                                   seed=seed) if faults else None
            return eng.serve(pipeline=pipeline, **kw)
        eng.faults = FaultInjector([FaultSpec(site=s, **k)
                                    for s, k in faults],
                                   seed=seed) if faults else None
        return eng.serve(pipeline=pipeline, **kw)


def request_cls(which):
    return JRequest if which == "jax" else Request


def script(which, **extra):
    """``tests/test_faults.py``'s request script: ragged prompts, more
    requests than slots."""
    rng = np.random.default_rng(3)
    return [request_cls(which)(
        prompt_tokens=rng.integers(1, 128, n).tolist(), max_new_tokens=m,
        request_id=f"req-{i}", **extra)
        for i, (n, m) in enumerate(
            [(8, 6), (5, 4), (9, 8), (6, 3), (7, 5), (4, 7)])]


def _num(x):
    return "nan" if isinstance(x, float) and math.isnan(x) else x


def plain(x):
    if isinstance(x, list):
        return [plain(v) for v in x]
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def outcome(h):
    """A resolved handle as plain values: its typed error's class (and
    ``infeasible``), or its result's tokens, flags and modeled numbers."""
    assert h.done, f"{h.request_id} never resolved"
    if h.error is not None:
        return (h.request_id, type(h.error).__name__,
                getattr(h.error, "infeasible", None))
    r = h.result(drive=False)
    return (h.request_id, r.tokens, _num(r.ttft_s), _num(r.tpot_s),
            r.cancelled, r.deadline_expired, r.preempted, r.cache_stats,
            r.prefill_weight_bytes, r.decode_weight_bytes_per_tok,
            plain(r.prefill_timing), plain(r.decode_timings))


def events(h):
    """A finished handle's stream as (request_id, phase, tokens,
    modeled_s) tuples, in order."""
    return [(e.request_id, e.phase, list(e.tokens), e.modeled_s)
            for e in h.stream(drive=False)]


def health(session):
    return dataclasses.asdict(session.health())
