"""The rank program of ``tests/test_torch_data_axis.py``: every case of the
data-axis file, run by each of 4 gloo ranks on the CPU in one world. It
imports the port only (no JAX: the ranks are spawned processes); the
parent compares what each rank returns with the JAX package's numbers."""
import dataclasses
import time

import numpy as np
import torch

from _torch_ep_worker import plain, recording, req
from repro_torch.launch.mesh import CollectiveMismatch, Mesh, \
    make_local_mesh
from repro_torch.models import model as tmodel
from repro_torch.models.layers import moe as tmoe
from repro_torch.params import from_reference
from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig


def ecfg():
    return EngineConfig(profile=EdgeProfile().with_vram(12), decode_chunk=4)


def session_requests():
    """Six ragged requests for a 4-slot session: request 1 ends at its
    first token, so in the first wave request 2's slot moves from the
    second data block into the first."""
    return [req(i, n_prompt=10 + 3 * i, max_new=1 if i == 1 else 3 + i)
            for i in range(6)]


def served(engine):
    """``generate`` of three requests and a 4-slot ``generate_batch`` of
    :func:`session_requests`, with every replay's masks."""
    masks = []
    inner = engine._replay
    recording(engine, masks)
    gen = [plain(engine.generate(req(i))) for i in range(3)]
    batch = [plain(r) for r in engine.generate_batch(session_requests(),
                                                      num_slots=4)]
    engine._replay = inner
    return dict(gen=gen, batch=batch, masks=masks,
                stats=dict(engine.last_stats))


def _info(info, fields=("critical_masks", "active_masks", "expert_load",
                        "expert_hh_load", "gate_mean", "predicted_next",
                        "token_importance", "aux_loss", "dropped_frac")):
    return {f: getattr(info, f).numpy() for f in fields
            if getattr(info, f) is not None}


def _prefill_decode(mesh, eng, cfg, fx, prompt, lo, hi):
    """A ragged prefill of rows ``lo:hi`` of ``fx[prompt]`` with one
    shared Critical set, then a decode step with one
    (``per_row_moe=False``)."""
    logits, caches, info = tmodel.prefill(
        eng.params, cfg, torch.from_numpy(fx[prompt][lo:hi]),
        qparams=eng.qparams, cache_slots=fx["cache_slots"],
        lengths=torch.from_numpy(fx["lens"][lo:hi]), mesh=mesh)
    pre = dict(logits=logits.numpy(), **_info(info))
    logits, _, info = tmodel.decode_step(
        eng.params, cfg, torch.from_numpy(fx["tok0"][lo:hi]), caches,
        qparams=eng.qparams, mesh=mesh)
    return pre, dict(logits=logits.numpy(), **_info(info))


def _forward(mesh, eng, cfg, fx):
    """The forward functions on this rank's block of a 4-row batch: a
    ragged prefill with one shared Critical set and a decode step with one
    (``per_row_moe=False``), first with the site's tokens gathered over
    "data", then at D 2 with the groups pinned to "data" (each rank
    dispatches its rows, the loads and look-ahead summed over "data"); and
    ``moe_apply_sharded`` at D 2 pinned to "data"."""
    lo, hi = mesh.batch_block(fx["prompt"].shape[0])
    out = {"rows": (lo, hi)}
    out["prefill"], out["decode"] = _prefill_decode(mesh, eng, cfg, fx,
                                                    "prompt", lo, hi)
    dcfg = dataclasses.replace(cfg, moe_dispatch_shards=2,
                               moe_dispatch_axes=("data",))
    out["prefill_local"], out["decode_local"] = _prefill_decode(
        mesh, eng, dcfg, fx, "prompt_local", lo, hi)

    t = fx["x"].shape[0]
    tl, tr = mesh.batch_block(t)
    p = {k: v[0] for k, v in eng.params["layers"]["moe"].items()}
    qw = tmodel._index_tree(eng.qparams["layers"]["moe"], 0)
    y, st = tmoe.moe_apply_sharded(
        p, dcfg, torch.from_numpy(fx["x"][tl:tr]),
        hh_mask=torch.from_numpy(fx["hh"][tl:tr]),
        critical_mask=torch.from_numpy(fx["crit"]), qweights=qw,
        token_valid=torch.from_numpy(fx["tv"][tl:tr]), mesh=mesh)
    out["moe"] = dict(y=y.numpy(), rows=(tl, tr), **{
        f: getattr(st, f).numpy() for f in (
            "router_logits", "expert_load", "expert_hh_load", "gate_mean",
            "aux_loss", "dropped_frac")})
    # the axes must name the mesh's batch axes, and D a multiple of them
    refused = []
    for bad in (dict(moe_dispatch_axes=("pod",)),
                dict(moe_dispatch_shards=3)):
        try:
            tmoe.moe_apply_sharded(
                p, dataclasses.replace(dcfg, **bad),
                torch.from_numpy(fx["x"][tl:tr]), mesh=mesh)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def run(rank, device, cfg, np_params, fx):
    torch.set_num_threads(1)
    params = from_reference(np_params, "cpu")
    mesh = Mesh({"data": 2, "model": 2}, rank)
    local = make_local_mesh()
    out = {"rank": rank, "coords": (mesh.data_rank, mesh.model_rank),
           "local_shape": dict(local.shape)}

    eng = DyMoEEngine(cfg, params, ecfg(), device="cpu", mesh=mesh,
                      expert_parallel=True)
    packed = eng.qparams["layers"]["moe"]["w_gate"].high.packed
    out["routed"] = (packed.dim, tuple(packed.local.shape))
    before = {a: dict(v) for a, v in mesh.collectives_by_axis.items()}
    out["ep"] = served(eng)
    out["by_axis"] = {a: mesh.collectives_by_axis[a]["collectives"]
                      - before[a]["collectives"] for a in before}
    with eng.lock:
        st = eng._decode_batched.states()
    out["state_slots"] = sorted((s.num_slots, s.caches["layers"].k.shape[1])
                                for s in st)
    out["forward"] = _forward(mesh, eng, cfg, fx)

    leng = DyMoEEngine(cfg, params, ecfg(), device="cpu", mesh=local)
    out["local"] = served(leng)

    # a mismatched collective on one data sub-group: ranks 0 and 2 (the
    # data group of model coordinate 0) disagree, ranks 1 and 3 agree
    t0 = time.perf_counter()
    try:
        if rank == 0:
            mesh.all_reduce(torch.ones(4), axis="data")
        elif rank == 2:
            mesh.broadcast(torch.ones(8), axis="data")
        else:
            mesh.all_reduce(torch.ones(4), axis="data")
        out["mismatch"] = None
    except CollectiveMismatch as e:
        out["mismatch"] = (time.perf_counter() - t0, str(e))
    return out
