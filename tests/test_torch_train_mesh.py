"""The train step under a mesh of 4 gloo ranks on the CPU, held to the
JAX package's one-device ``value_and_grad(loss_fn)`` and ``AdamW.update``,
reduced and f32.

ONE spawn of 4 ranks runs every case (``tests/_torch_train_worker.py``);
the JAX numbers are computed once here in the parent, from the same
numpy-made weights and batch (4 rows of 16 tokens, a loss mask with
zeros, so the data ranks' mask counts differ). Each rank holds its blocks
of the weights (``param_shardings``, ``expert_parallel`` for the EP cases)
and of the AdamW moments (with ZeRO-1 also split over "data") and its
rows of the batch, and runs ``train_step_fn(cfg, opt, mesh)``:

  * every rank's loss, ce and aux, and its grads gathered whole, equal
    the JAX package's within atol = rtol = 1e-5, on (1, 2), (2, 1),
    (2, 2), (1, 4) and (4, 1) meshes: reduced qwen3_0p6b (dense),
    qwen2_moe_a2p7b expert- and tensor-parallel (a shared expert),
    olmoe_1b_7b expert-parallel and zamba2_1p2b (Mamba2 and a shared
    attention block), qwen3_0p6b with tied embeddings (the split table's
    grads from both ``embed`` and ``lm_head``) and falcon_mamba_7b
    (Mamba1); the metrics are whole on every rank, bitwise alike;
  * ZeRO-1 gives the same grads, params and moments as no ZeRO-1, bit for
    bit (its extra collectives: each sliced leaf's gather of its param
    slices over "data"), and remat "block" the same as none, bit for bit;
  * the sharded ``AdamW.update``, fed the JAX grads, twice, equals the JAX
    update within 1e-6 (params and moments), with the clip binding and
    not, ZeRO-1 on and off (on and off bitwise alike);
  * the inference path's collectives stay the in-place ones: a forward
    without grads issues the collectives its forward with grads issues,
    in order, with the same logits, bitwise (reduced qwen3_0p6b on (2, 2),
    and zamba2_1p2b on (1, 4), whose Mamba2 seams split every head).

Without a world: ``AdamW.init`` of a rank's blocks under
``zero1_shardings`` holds exactly the bytes the dry run's
``argument_bytes`` gives the moments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_worker as worker
from _torch_bridge import numpy_init, port_cfg, to_numpy_tree
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import constant_lr as jconstant_lr
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.model import init_params
from repro_torch.sharding.partition import Shard, param_shardings, \
    shard_tree, zero1_shardings
from repro_torch.sharding.spmd import local
from repro_torch.training import AdamW, constant_lr
from repro_torch.tree import tree_leaves

N = 4
B, S = 4, 16
TOL = dict(atol=1e-5, rtol=1e-5)
# case -> (arch, ``reduced()`` overrides, meshes, expert-parallel,
#          {mesh: extra runs})
CONFIGS = {
    "qwen3_0p6b": ("qwen3_0p6b", {}, ("1x2", "2x1", "2x2", "1x4", "4x1"),
                   False, {"2x2": ("zero1", "remat"), "4x1": ("zero1",)}),
    "qwen3_0p6b-tied": ("qwen3_0p6b", dict(tie_embeddings=True),
                        ("2x2", "1x4"), False, {}),
    "qwen2_moe_a2p7b-ep": ("qwen2_moe_a2p7b", {},
                           ("1x2", "2x2", "1x4", "4x1"), True,
                           {"2x2": ("zero1", "remat")}),
    "qwen2_moe_a2p7b-tp": ("qwen2_moe_a2p7b", {}, ("2x2", "1x4"), False,
                           {"1x4": ("remat",)}),
    "olmoe_1b_7b-ep": ("olmoe_1b_7b", {}, ("2x1", "2x2"), True,
                       {"2x2": ("zero1",)}),
    "zamba2_1p2b": ("zamba2_1p2b", {}, ("2x1", "2x2", "1x4"), False,
                    {"2x2": ("zero1", "remat")}),
    "falcon_mamba_7b": ("falcon_mamba_7b", {}, ("1x4", "2x2"), False, {}),
}
# the sharded AdamW fed the JAX grads of this case, on these meshes
ADAMW = {"adamw": ("qwen2_moe_a2p7b-ep", ("2x2", "1x4", "4x1"))}
NO_GRAD = (("qwen3_0p6b", "2x2"), ("zamba2_1p2b", "1x4"))


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(5)
    return dict(tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
                labels=rng.integers(0, vocab, (B, S)).astype(np.int32),
                loss_mask=(rng.random((B, S)) < 0.8).astype(np.float32))


def _paths(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _jax_adamw(params, grads) -> dict:
    """The JAX ``AdamW.update`` twice with ``grads``, for each clip of
    ``worker.CLIPS``: the params and moments after it."""
    out = {}
    for name, clip in worker.CLIPS:
        opt = JAdamW(lr=jconstant_lr(worker.LR),
                     weight_decay=worker.WEIGHT_DECAY, grad_clip=clip)

        def twice(p, g, opt=opt):
            st = opt.init(p)
            for _ in range(2):
                p, st = opt.update(p, g, st)
            return p, st

        p, st = jax.jit(twice)(params, grads)
        out[name] = dict(params=_paths(p), mu=_paths(st.mu),
                         nu=_paths(st.nu))
    return out


@pytest.fixture(scope="module")
def world():
    cases, jax_out, done = {}, {}, {}
    adamw_cases = {case for case, _ in ADAMW.values()}
    for key, (arch, over, meshes, ep, extra) in CONFIGS.items():
        jcfg = jget_config(arch).reduced(**over)
        batch = _batch(jcfg.vocab_size)
        tag = (arch, tuple(sorted(over.items())))
        if tag not in done:      # the EP and TP cases share the reference
            params = numpy_init(
                lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p, bt: jmodel.loss_fn(p, jcfg, bt), has_aux=True))(
                    params, {k: jnp.asarray(v) for k, v in batch.items()})
            done[tag] = params, grads, dict(
                loss=float(loss), ce=float(metrics["ce"]),
                aux=float(metrics["aux"]), grads=_paths(grads))
        params, grads, want = done[tag]
        if key in adamw_cases:
            want = dict(want, adamw=_jax_adamw(params, grads),
                        grads_tree=to_numpy_tree(grads))
        jax_out[key] = want
        cases[key] = (port_cfg(jcfg), to_numpy_tree(params), batch, want,
                      meshes, ep, extra)
    ranks = spawn(worker.run, N, cases, ADAMW, NO_GRAD, timeout_s=120.0)
    return dict(ranks=ranks, jax=jax_out)


STEP_CASES = [(k, m) for k, (_, _, meshes, _, _) in CONFIGS.items()
              for m in meshes]


@pytest.mark.parametrize("case,mesh", STEP_CASES,
                         ids=[f"{k}-{m}" for k, m in STEP_CASES])
def test_loss_and_grads_equal_the_jax_value_and_grad(world, case, mesh):
    want = world["jax"][case]
    shape = worker.SHAPES[mesh]
    metrics = []
    for r in world["ranks"]:
        got = r[(case, mesh)]
        m = got["metrics"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(m[k], want[k], **TOL,
                                       err_msg=f"rank {r['rank']} {k}")
        bad = {k: d for k, (d, close) in got["grads"].items() if not close}
        assert not bad, (r["rank"], bad)
        assert got["coords"][0] < shape["data"]
        assert got["coords"][1] < shape["model"]
        # a data rank's rows of the batch; the collectives by axis
        d = shape["data"]
        lo = got["coords"][0] * (B // d)
        assert tuple(m["rows"]) == (lo, lo + B // d)
        by = got["by_axis"]
        assert (by["model"] > 0) == (shape["model"] > 1), by
        assert (by["data"] > 0) == (d > 1), by
        metrics.append({k: m[k] for k in ("loss", "ce", "aux")})
    # whole on every rank, bit for bit
    assert all(x == metrics[0] for x in metrics), metrics


ZERO1_CASES = [(k, m) for k, (_, _, _, _, extra) in CONFIGS.items()
               for m, e in extra.items() if "zero1" in e]
REMAT_CASES = [(k, m) for k, (_, _, _, _, extra) in CONFIGS.items()
               for m, e in extra.items() if "remat" in e]


@pytest.mark.parametrize("case,mesh", ZERO1_CASES,
                         ids=[f"{k}-{m}" for k, m in ZERO1_CASES])
def test_zero1_step_equals_the_step_without_it(world, case, mesh):
    for r in world["ranks"]:
        z = r[(case, mesh)]["zero1"]
        assert z["metrics_equal"] and z["grads_equal"], r["rank"]
        assert z["params_equal"] and z["moments_equal"], r["rank"]
        # one more collective over "data" a leaf ZeRO-1 slices: the
        # gather of its param slices
        plain = r[(case, mesh)]["by_axis"]
        assert plain["sliced"] == 0 < z["by_axis"]["sliced"]
        assert z["by_axis"]["data"] == plain["data"] + \
            z["by_axis"]["sliced"], (z, plain)
        assert z["by_axis"]["model"] == plain["model"]


@pytest.mark.parametrize("case,mesh", REMAT_CASES,
                         ids=[f"{k}-{m}" for k, m in REMAT_CASES])
def test_remat_step_equals_the_step_without_it(world, case, mesh):
    """Bit for bit; the recomputed forward issues its "model"
    collectives again inside the backward, and the counts hold them."""
    for r in world["ranks"]:
        rm = r[(case, mesh)]["remat"]
        assert rm["metrics_equal"] and rm["grads_equal"], r["rank"]
        assert rm["params_equal"], r["rank"]
        plain = r[(case, mesh)]["by_axis"]
        if worker.SHAPES[mesh]["model"] > 1:
            assert rm["by_axis"]["model"] > plain["model"], (rm, plain)


ADAMW_CASES = [(k, m, c) for k, (_, meshes) in ADAMW.items()
               for m in meshes for c, _ in worker.CLIPS]


@pytest.mark.parametrize("key,mesh,clip", ADAMW_CASES,
                         ids=[f"{m}-{c}" for _, m, c in ADAMW_CASES])
def test_sharded_adamw_equals_the_jax_update(world, key, mesh, clip):
    for r in world["ranks"]:
        got = r[(key, mesh)][clip]
        for part, dist in got["dist"].items():
            worst = max(dist.values())
            assert worst <= 1e-6, (r["rank"], part, max(dist, key=dist.get),
                                   worst)
        assert got["zero1_equal"], r["rank"]


def test_clip_cases_bind_and_do_not(world):
    """The clip of 1e-3 binds (the grads' norm is above it) and the clip
    of 1e3 does not."""
    grads = world["jax"][ADAMW["adamw"][0]]["grads"]
    norm = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in grads.values())))
    clips = dict(worker.CLIPS)
    assert clips["clip_binds"] < norm < clips["clip_free"], norm


def _check_no_grad(world, case):
    for r in world["ranks"]:
        ng = r["no_grad"][case]
        assert ng["identity"], r["rank"]
        assert ng["collectives"] > 0 and ng["same_collectives"], r["rank"]
        assert ng["logits_equal"], r["rank"]


def test_no_grad_forward_keeps_the_in_place_collectives(world):
    _check_no_grad(world, NO_GRAD[0])


def test_no_grad_ssm_forward_keeps_the_in_place_collectives(world):
    """Mamba2's seams (``_take``, ``_mamba2_heads``, the gate norm) issue
    the same collectives with and without grads."""
    _check_no_grad(world, NO_GRAD[1])


@pytest.mark.parametrize("mesh", ["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_zero1_moments_a_rank_are_the_dry_runs_argument_bytes(mesh, ep):
    """``AdamW.init`` of rank 0's blocks under ``zero1_shardings`` (an
    abstract mesh: no world) holds the moment bytes that
    ``dryrun.argument_bytes`` gives the spec tree (reduced OLMoE, f32)."""
    cfg = get_config("olmoe_1b_7b").reduced()
    m = Mesh({**worker.SHAPES, **dryrun.MESHES}[mesh])
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sp = shard_tree(params, param_shardings(params, m, expert_parallel=ep),
                    m)
    specs = zero1_shardings(params, m, expert_parallel=ep)
    st = AdamW(lr=constant_lr(1e-3)).init(sp, specs, m)
    held = sum(local(x).numel() * 4 for tree in (st.mu, st.nu)
               for x in tree_leaves(tree))
    assert held == 2 * dryrun.argument_bytes([params], [specs], m) > 0
    split = [x for x in tree_leaves(st.mu) if isinstance(x, Shard)]
    assert any("data" in a for x in split for a in x.splits.values())
