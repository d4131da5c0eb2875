"""The rank program of ``tests/test_torch_train_mesh.py``: every case of
the train-under-a-mesh file, run by each of 4 gloo ranks on the CPU in one
world. It imports the port only (no JAX: the ranks are spawned
processes); the parent hands over the JAX package's numbers as numpy, and
a rank returns its distances from them (whole trees do not cross the
result queue: 4 ranks times every case would be hundreds of MB).

A 4-rank mesh spans the world; a 2-rank one ((1, 2), (2, 1)) runs on
each pair of ranks, {0, 1} and {2, 3}, over a group of its own."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as tmodel
from repro_torch.params import from_reference
from repro_torch.sharding.partition import Shard, param_shardings, \
    shard_tree, zero1_shardings
from repro_torch.training import AdamW, constant_lr
from repro_torch.tree import tree_map, tree_paths

SHAPES = {"1x2": {"data": 1, "model": 2}, "2x1": {"data": 2, "model": 1},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "4x1": {"data": 4, "model": 1}}
LR = 1e-2
WEIGHT_DECAY = 0.01
# AdamW cases: (name, grad_clip); the parent's grads have a global norm
# far above 1e-3 and far below 1e3
CLIPS = (("clip_binds", 1e-3), ("clip_free", 1e3))


def mesh_of(name: str, rank: int, pairs) -> Mesh:
    shape = SHAPES[name]
    if shape["data"] * shape["model"] == 4:
        return Mesh(shape, rank)
    return Mesh(shape, rank % 2, group=pairs[rank // 2])


def whole(tree, mesh: Mesh) -> dict:
    """{path: numpy} of a rank's tree with every Shard gathered whole."""
    def gather(x):
        if not isinstance(x, Shard):
            return x.detach()
        t = x.local.detach()
        for d, axes in x.splits.items():
            t = mesh.all_gather(t.contiguous(), d,
                                axis="model" if "model" in axes else "data")
        return t
    return {k: v.numpy() for k, v in
            tree_paths(tree_map(gather, tree)).items()}


def distance(got: dict, want: dict) -> dict:
    """{path: (max |got - want|, allclose at atol = rtol = 1e-5)}."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    return {k: (float(np.abs(got[k] - want[k]).max()),
                bool(np.allclose(got[k], want[k], atol=1e-5, rtol=1e-5)))
            for k in want}


class Recording:
    """AdamW that keeps the grads the step hands it."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params, specs=None, mesh=None):
        return self.opt.init(params, specs, mesh)

    def update(self, params, grads, state):
        self.grads = grads
        return self.opt.update(params, grads, state)


def shard(params, mesh, ep):
    return shard_tree(params, param_shardings(params, mesh,
                                              expert_parallel=ep), mesh)


def state_of(opt, sp, mesh, ep, zero1):
    if not zero1:
        return opt.init(sp)
    return opt.init(sp, zero1_shardings(sp, mesh, expert_parallel=ep), mesh)


def step_case(cfg, params, batch, mesh, ep, zero1):
    """One train step of this rank: (metrics, whole grads, whole new
    params, whole new moments, collectives by axis)."""
    sp = shard(params, mesh, ep)
    opt = Recording(AdamW(lr=constant_lr(LR), weight_decay=WEIGHT_DECAY))
    state = state_of(opt, sp, mesh, ep, zero1)
    lo, hi = mesh.batch_block(batch["tokens"].shape[0])
    before = {a: v["collectives"] for a, v in
              mesh.collectives_by_axis.items()}
    new, st, m = tmodel.train_step_fn(cfg, opt, mesh)(
        sp, state, {k: v[lo:hi] for k, v in batch.items()})
    by_axis = {a: v["collectives"] - before[a]
               for a, v in mesh.collectives_by_axis.items()}
    # the moment leaves split over "data" (ZeRO-1): one gather each
    by_axis["sliced"] = sum(
        isinstance(x, Shard) and any("model" not in a
                                     for a in x.splits.values())
        for x in tree_paths(st.mu).values())
    return (dict({k: float(v) for k, v in m.items()}, rows=(lo, hi)),
            whole(opt.grads, mesh), whole(new, mesh), whole(st.mu, mesh),
            whole(st.nu, mesh), by_axis)


def train_cases(cfg, params, batch, want, mesh, ep, extra) -> dict:
    """The step against the JAX package's value_and_grad; with "zero1",
    the same step with ZeRO-1 moments (params and moments bitwise equal);
    with "remat", under remat "block" (grads and params bitwise equal)."""
    m, g, p, mu, nu, by_axis = step_case(cfg, params, batch, mesh, ep,
                                         False)
    out = dict(metrics=m, grads=distance(g, want["grads"]), by_axis=by_axis,
               coords=(mesh.data_rank, mesh.model_rank))
    if "zero1" in extra:
        m1, g1, p1, mu1, nu1, by1 = step_case(cfg, params, batch, mesh, ep,
                                              True)
        out["zero1"] = dict(
            metrics_equal=m1 == m, by_axis=by1,
            grads_equal=all(np.array_equal(g1[k], g[k]) for k in g),
            params_equal=all(np.array_equal(p1[k], p[k]) for k in p),
            moments_equal=all(np.array_equal(a[k], b[k])
                              for a, b in ((mu1, mu), (nu1, nu)) for k in a))
    if "remat" in extra:
        rcfg = dataclasses.replace(cfg, remat="block")
        mr, gr, pr, _, _, byr = step_case(rcfg, params, batch, mesh, ep,
                                          False)
        out["remat"] = dict(
            metrics_equal=mr == m, by_axis=byr,
            grads_equal=all(np.array_equal(gr[k], g[k]) for k in g),
            params_equal=all(np.array_equal(pr[k], p[k]) for k in p))
    return out


def adamw_cases(params, grads, want, mesh, ep) -> dict:
    """The sharded ``AdamW.update``, twice, fed the JAX grads (this rank's
    blocks of them), with and without ZeRO-1, for each clip of ``CLIPS``:
    the distance of the gathered params and moments from the JAX
    update's, and ZeRO-1 against no ZeRO-1 (bitwise)."""
    specs = param_shardings(params, mesh, expert_parallel=ep)
    sp, sg = shard_tree(params, specs, mesh), shard_tree(grads, specs, mesh)
    out = {}
    for name, clip in CLIPS:
        got = {}
        for zero1 in (False, True):
            opt = AdamW(lr=constant_lr(LR), weight_decay=WEIGHT_DECAY,
                        grad_clip=clip)
            p, st = sp, state_of(opt, sp, mesh, ep, zero1)
            for _ in range(2):
                p, st = opt.update(p, sg, st)
            got[zero1] = dict(params=whole(p, mesh), mu=whole(st.mu, mesh),
                              nu=whole(st.nu, mesh))
        w = want[name]
        out[name] = dict(
            dist={part: {k: float(np.abs(got[False][part][k]
                                         - w[part][k]).max())
                         for k in w[part]}
                  for part in ("params", "mu", "nu")},
            zero1_equal=all(np.array_equal(got[True][part][k],
                                           got[False][part][k])
                            for part in got[False]
                            for k in got[False][part]))
    return out


def no_grad_case(cfg, params, batch, mesh) -> dict:
    """The inference path under a mesh stays the in-place one: without
    grads ``enter`` / ``count_once`` hand back their input and a SUM is
    in place; ``forward`` without grads issues the collectives (op, axis,
    dtype, size, in order) that its forward with grads issues, and the
    same logits, bitwise."""
    sp = shard(params, mesh, False)
    lo, hi = mesh.batch_block(batch["tokens"].shape[0])
    tokens = batch["tokens"][lo:hi]
    log = []
    real = mesh._run

    def logged(op, t, kind, axis):
        log.append((op, kind, axis, str(t.dtype), t.numel()))
        return real(op, t, kind, axis)

    x = torch.ones(3)
    same = (mesh.enter(x) is x and mesh.count_once(x, "model") is x
            and mesh.all_reduce(x) is x)
    mesh._run = logged
    try:
        with torch.no_grad():
            plain, _ = tmodel.forward(sp, cfg, tokens, mesh=mesh)
        seq_plain, log[:] = list(log), []
        tracked = tree_map(
            lambda p: Shard(p.local.detach().requires_grad_(True), p.splits,
                            p.mesh) if isinstance(p, Shard)
            else p.detach().requires_grad_(True), sp)
        with torch.enable_grad():
            graded, _ = tmodel.forward(tracked, cfg, tokens, mesh=mesh)
        seq_grad = list(log)
    finally:
        mesh._run = real
    return dict(identity=same, collectives=len(seq_plain),
                same_collectives=seq_plain == seq_grad,
                logits_equal=torch.equal(plain, graded.detach()))


def run(rank, device, cases, adamw, no_grad):
    torch.set_num_threads(1)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out = {"rank": rank}
    for key, (cfg, np_params, batch, want, meshes, ep, extra) in \
            cases.items():
        params = from_reference(np_params, "cpu")
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        for name in meshes:
            mesh = mesh_of(name, rank, pairs)
            out[(key, name)] = train_cases(cfg, params, b, want, mesh, ep,
                                           extra.get(name, ()))
    for key, (case, meshes) in adamw.items():
        cfg, np_params, _, want, _, ep, _ = cases[case]
        params = from_reference(np_params, "cpu")
        grads = from_reference(want["grads_tree"], "cpu")
        for name in meshes:
            out[(key, name)] = adamw_cases(params, grads, want["adamw"],
                                           mesh_of(name, rank, pairs), ep)
    out["no_grad"] = {}
    for case, name in no_grad:
        cfg, np_params, batch, *_ = cases[case]
        out["no_grad"][(case, name)] = no_grad_case(
            cfg, from_reference(np_params, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            mesh_of(name, rank, pairs))
    return out
