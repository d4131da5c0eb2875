"""The rank program of ``tests/test_torch_ssm_mesh.py``: every case of the
SSM-mesh file, run by each of 4 gloo ranks on the CPU in one world. It
imports the port only (no JAX: the ranks are spawned processes); the
parent compares what each rank returns with the JAX package's numbers."""
import dataclasses

import numpy as np
import torch

from _torch_ep_worker import plain
from repro_torch.kernels.quant_matmul import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as tmodel
from repro_torch.models.kv_cache import cache_tensors
from repro_torch.params import from_reference
from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig, \
    Request

SHAPES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}
MODES = ("4/2", "off")
LIVE = (True, False, True, True)   # the forward cases' decode rows


def requests():
    """Four requests on 4 slots, two prompt lengths (two exact-shape
    solo admissions to compile on the JAX side); request 1 ends at its
    first token, so request 2 takes slot 1, in the first data block, and
    request 3 slot 2, in the second."""
    return [Request(prompt_tokens=list(range(1 + i, 13 + 4 * (i // 2) + i)),
                    max_new_tokens=(4, 1, 5, 3)[i], request_id=f"req-{i}")
            for i in range(4)]


def mode_cfg(cfg, mode):
    return dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, enabled=mode != "off"))


def engine_cfg(mode):
    return EngineConfig(profile=EdgeProfile().with_vram(12), decode_chunk=4,
                        use_dymoe=mode != "off")


class CountK2:
    """Counts the packed-matmul (K2) calls made while it is entered."""

    def __enter__(self):
        self.n, self._real = 0, ops.expert_quant_matmul

        def counted(*a, **kw):
            self.n += 1
            return self._real(*a, **kw)

        ops.expert_quant_matmul = counted
        return self

    def __exit__(self, *exc):
        ops.expert_quant_matmul = self._real


class _CountedPrefill:
    """The engine's compiled prefill with each call's rows recorded."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, prompts, **kw):
        self.rows.append(len(prompts))
        return self.inner(prompts, **kw)


def served(cfg, params, mode, mesh=None):
    """``generate_batch`` of :func:`requests` on 4 slots: every request's
    tokens and modeled numbers, the run's K2 calls, the prefills this rank
    ran and, over a mesh, its collectives by axis."""
    engine = DyMoEEngine(mode_cfg(cfg, mode), params, engine_cfg(mode),
                         device="cpu", mesh=mesh)
    before = None if mesh is None else {
        a: v["collectives"] for a, v in mesh.collectives_by_axis.items()}
    engine._prefill = counted = _CountedPrefill(engine._prefill)
    with CountK2() as k2:
        res = engine.generate_batch(requests(), num_slots=4)
    engine._prefill = counted.inner
    out = dict(rows=[plain(r) for r in res], k2=k2.n, prefills=counted.rows,
               stats=dict(engine.last_stats))
    if mesh is not None:
        out["by_axis"] = {a: v["collectives"] - before[a]
                          for a, v in mesh.collectives_by_axis.items()}
        with engine.lock:
            st = engine._decode_batched.states()
        out["state_rows"] = sorted(s.caches["layers"].ssm_state.shape[1]
                                   for s in st)
    return out


def _caches(caches):
    """Every cache tensor as numpy (tensors do not cross the result
    queue)."""
    return {part: {name: t.numpy().copy() for name, t in cache_tensors(c)}
            for part, c in caches.items()}


def forward(cfg, params, qparams, fx, mesh):
    """``prefill`` of this rank's block of the 4-row prompt and one
    ``decode_step`` with row 1 dead: logits and every cache tensor (this
    rank's blocks) after each, and whether the dead row's state is bitwise
    the prefill's."""
    lo, hi = mesh.batch_block(fx["prompt"].shape[0])
    on = mesh.for_batch(fx["prompt"].shape[0])
    prompt = torch.from_numpy(fx["prompt"][lo:hi])
    logits, caches, _ = tmodel.prefill(params, cfg, prompt, qparams=qparams,
                                       cache_slots=fx["slots"], mesh=on)
    pre = dict(logits=logits.numpy(), caches=_caches(caches))
    live = torch.tensor(LIVE[lo:hi])
    dlogits, caches, _ = tmodel.decode_step(
        params, cfg, torch.from_numpy(fx["tok0"][lo:hi]), caches,
        qparams=qparams, per_row_moe=True, live_rows=live, mesh=on)
    dec = dict(logits=dlogits.numpy(), caches=_caches(caches))
    dead = [i for i in range(hi - lo) if not LIVE[lo + i]]
    frozen = all(np.array_equal(dec["caches"][part][name][:, i],
                                pre["caches"][part][name][:, i])
                 for part in pre["caches"] for name in pre["caches"][part]
                 for i in dead)
    return dict(rows=(lo, hi), prefill=pre, decode=dec, dead=len(dead),
                frozen=frozen)


def layout(engine, cfg, fx, mesh):
    """The engine's ``shard_decode_state`` of a whole 4-row decode state
    against ``init_decode_state`` of this rank's rows under the mesh:
    (name, shape, slot shards) of every cache tensor, both."""
    n = fx["prompt"].shape[0]
    lo, hi = mesh.batch_block(n)

    def shapes(caches):
        return sorted((f"{part}/{name}", tuple(t.shape),
                       getattr(c, "shards", None))
                      for part, c in caches.items()
                      for name, t in cache_tensors(c))

    laid = engine.shard_decode_state(
        tmodel.init_decode_state(cfg, n, fx["slots"], "cpu"))
    alloc = tmodel.init_decode_state(cfg, hi - lo, fx["slots"], "cpu",
                                     mesh=mesh.for_batch(n))
    return shapes(laid), shapes(alloc)


def run(rank, device, cases):
    torch.set_num_threads(1)
    out = {"rank": rank}
    for arch, (cfg, np_params, fx, shapes) in cases.items():
        params = from_reference(np_params, "cpu")
        qparams = tmodel.quantize_model(params, cfg)
        for name in shapes:
            mesh = Mesh(SHAPES[name], rank)
            got = {mode: served(cfg, params, mode, mesh) for mode in MODES}
            # the forward functions on this rank's blocks of the weights
            sp = DyMoEEngine(cfg, params, engine_cfg("4/2"), device="cpu",
                             qparams=qparams, mesh=mesh)
            got["forward"] = forward(cfg, sp.params, sp.qparams, fx, mesh)
            got["layout"] = layout(sp, cfg, fx, mesh)
            got["coords"] = (mesh.data_rank, mesh.model_rank)
            out[(arch, name)] = got
    return out
