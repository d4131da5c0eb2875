"""The rank program of ``tests/test_torch_seq_acts.py``: each of 4 gloo
ranks on the CPU runs every case's train step twice on one mesh, with the
residual whole between blocks and split along the sequence
(``act_seq_shard``), and the no-grad forward cases. It imports the port
only (no JAX: the ranks are spawned processes); a rank returns its
distances from the parent's JAX numbers and its own comparisons, never
whole trees."""
import dataclasses

import numpy as np
import torch

from _torch_train_worker import distance, no_grad_case, shard, step_case
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as tmodel
from repro_torch.params import from_reference

SHAPES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}


def saving(fn):
    """``fn()`` with every checkpoint of ``forward`` under
    ``saved_tensors_hooks``: (its result, the bytes of the distinct
    storages of the 3-D tensors — the residual — that the checkpoints
    save, and how many storages). Inside a checkpoint its own hooks take
    over, so these see only the inputs it keeps for the recompute."""
    seen = {}
    real = tmodel.checkpoint

    def pack(t):
        if t.dim() == 3:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return t

    def hooked(*args, **kwargs):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return real(*args, **kwargs)

    tmodel.checkpoint = hooked
    try:
        out = fn()
    finally:
        tmodel.checkpoint = real
    return out, sum(seen.values()), len(seen)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def seq_case(cfg, params, batch, want, mesh, ep) -> dict:
    """The step with the residual split against the same mesh's unsplit
    step (metrics, grads, the AdamW update's params and moments, bit for
    bit), its distance from the JAX grads, the residual bytes the
    checkpoints save in each, and the collectives by axis of each."""
    runs = {}
    for split in (False, True):
        c = dataclasses.replace(cfg, act_seq_shard=split)
        runs[split] = saving(lambda c=c: step_case(c, params, batch, mesh,
                                                   ep, False))
    (m0, g0, p0, mu0, nu0, by0), saved0, n0 = runs[False]
    (m1, g1, p1, mu1, nu1, by1), saved1, n1 = runs[True]
    return dict(
        metrics=m1, grads=distance(g1, want["grads"]),
        metrics_equal=m0 == m1, grads_equal=_equal(g0, g1),
        params_equal=_equal(p0, p1),
        moments_equal=_equal(mu0, mu1) and _equal(nu0, nu1),
        saved=(saved0, saved1), saved_storages=(n0, n1),
        by_axis=(by0, by1), coords=(mesh.data_rank, mesh.model_rank))


def no_grad_split(cfg, params, batch, mesh) -> dict:
    """The split forward without grads against its run with grads (the
    in-place collectives, in order, and the logits: ``no_grad_case``),
    and against the unsplit forward: the same logits, bitwise, and
    exactly its collectives plus one gather a layer and one after the
    last."""
    split = no_grad_case(dataclasses.replace(cfg, act_seq_shard=True),
                         params, batch, mesh)
    lo, hi = mesh.batch_block(batch["tokens"].shape[0])
    logits, counts = {}, {}
    sp = shard(params, mesh, False)
    for flag in (False, True):
        before = mesh.collectives_by_axis["model"]["collectives"]
        with torch.no_grad():
            logits[flag], _ = tmodel.forward(
                sp, dataclasses.replace(cfg, act_seq_shard=flag),
                batch["tokens"][lo:hi], mesh=mesh)
        counts[flag] = mesh.collectives_by_axis["model"]["collectives"] - \
            before
    return dict(split, unsplit_logits_equal=torch.equal(logits[False],
                                                        logits[True]),
                extra_gathers=counts[True] - counts[False])


def run(rank, device, cases, no_grad):
    torch.set_num_threads(1)
    meshes = {name: Mesh(shape, rank) for name, shape in SHAPES.items()}
    out = {"rank": rank}
    for key, (cfg, np_params, batch, want, names, ep) in cases.items():
        params = from_reference(np_params, "cpu")
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        for name in names:
            out[(key, name)] = seq_case(cfg, params, b, want, meshes[name],
                                        ep)
    out["no_grad"] = {}
    for case, name in no_grad:
        cfg, np_params, batch, *_ = cases[case]
        out["no_grad"][(case, name)] = no_grad_split(
            cfg, from_reference(np_params, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            meshes[name])
    return out
