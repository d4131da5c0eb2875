"""``cfg.act_seq_shard`` in the train step under a mesh of 4 gloo ranks on
the CPU: the residual between blocks held as each "model" rank's block of
the sequence (``spmd.seq_leave`` / ``seq_enter``), reduced, f32, remat
"block".

ONE spawn of 4 ranks runs every case (``tests/_torch_seq_worker.py``);
the JAX numbers are computed once here in the parent, from the same
numpy-made weights and batch (4 rows of 16 tokens, a loss mask with
zeros). On (1, 4) and (2, 2), for reduced qwen3_0p6b (dense),
qwen2_moe_a2p7b expert-parallel (a shared expert), zamba2_1p2b (Mamba2
and a shared attention block) and falcon_mamba_7b (Mamba1), and for
qwen3_0p6b at 18 tokens on (1, 4) (blocks of 5, the last padded):

  * the split step equals the same mesh's unsplit step bit for bit: loss,
    ce, aux, the gathered grads and one AdamW update (params and
    moments);
  * it is within atol = rtol = 1e-5 of the JAX package's one-device
    ``value_and_grad(loss_fn)`` with ``act_seq_shard=True`` (under a
    (1, 1) ("data", "model") mesh, where the constraint is the identity);
  * the residual storages the checkpoints save (under
    ``saved_tensors_hooks``) are one a layer, and their bytes
    ceil(S / m) / S of the unsplit run's: a view of the whole residual
    would keep its whole storage;
  * the "model" collectives rise by exactly 3 a layer plus 2 (the entry
    gather, again at the recompute, and the exit's backward gather; the
    gather after the last block and the embedding's backward gather),
    and "data" is unchanged.

The no-grad forward (qwen3_0p6b on (1, 4), zamba2_1p2b on (2, 2)) issues
the collectives its forward with grads issues, in order, with the same
logits, bitwise equal to the unsplit forward's, and exactly one gather a
layer plus one more than it. Without a mesh the flag stays the identity
(``tests/test_torch_dispatch_shards.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import _torch_seq_worker as worker
from _torch_bridge import numpy_init, port_cfg, to_numpy_tree
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.training import checkpoint as jckpt
from repro_torch.launch.mesh import spawn

N = 4
B = 4
TOL = dict(atol=1e-5, rtol=1e-5)
# case -> (arch, tokens a row, meshes, expert-parallel)
CONFIGS = {
    "qwen3_0p6b": ("qwen3_0p6b", 16, ("1x4", "2x2"), False),
    "qwen2_moe_a2p7b-ep": ("qwen2_moe_a2p7b", 16, ("1x4", "2x2"), True),
    "zamba2_1p2b": ("zamba2_1p2b", 16, ("1x4", "2x2"), False),
    "falcon_mamba_7b": ("falcon_mamba_7b", 16, ("1x4", "2x2"), False),
    "qwen3_0p6b-s18": ("qwen3_0p6b", 18, ("1x4",), False),
}
NO_GRAD = (("qwen3_0p6b", "1x4"), ("zamba2_1p2b", "2x2"))


def _batch(vocab: int, s: int) -> dict:
    rng = np.random.default_rng(5)
    return dict(tokens=rng.integers(0, vocab, (B, s)).astype(np.int32),
                labels=rng.integers(0, vocab, (B, s)).astype(np.int32),
                loss_mask=(rng.random((B, s)) < 0.8).astype(np.float32))


@pytest.fixture(scope="module")
def world():
    cases, jax_out, cfgs = {}, {}, {}
    for key, (arch, s, meshes, ep) in CONFIGS.items():
        jcfg = jget_config(arch).reduced(remat="block", act_seq_shard=True)
        batch = _batch(jcfg.vocab_size, s)
        params = numpy_init(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
        with JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model")):
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p, bt: jmodel.loss_fn(p, jcfg, bt), has_aux=True))(
                    params, {k: jnp.asarray(v) for k, v in batch.items()})
        want = dict(loss=float(loss), ce=float(metrics["ce"]),
                    aux=float(metrics["aux"]),
                    grads={k: np.asarray(v) for k, v in
                           jckpt._flatten(grads).items()})
        jax_out[key], cfgs[key] = want, jcfg
        cases[key] = (port_cfg(jcfg), to_numpy_tree(params), batch, want,
                      meshes, ep)
    ranks = spawn(worker.run, N, cases, NO_GRAD, timeout_s=120.0)
    return dict(ranks=ranks, jax=jax_out, cfgs=cfgs)


CASES = [(k, m) for k, (_, _, meshes, _) in CONFIGS.items() for m in meshes]
IDS = [f"{k}-{m}" for k, m in CASES]


@pytest.mark.parametrize("case,mesh", CASES, ids=IDS)
def test_split_step_equals_the_unsplit_step_bitwise(world, case, mesh):
    for r in world["ranks"]:
        got = r[(case, mesh)]
        assert got["metrics_equal"] and got["grads_equal"], r["rank"]
        assert got["params_equal"] and got["moments_equal"], r["rank"]


@pytest.mark.parametrize("case,mesh", CASES, ids=IDS)
def test_split_step_equals_the_jax_value_and_grad(world, case, mesh):
    want = world["jax"][case]
    metrics = []
    for r in world["ranks"]:
        m = r[(case, mesh)]["metrics"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(m[k], want[k], **TOL,
                                       err_msg=f"rank {r['rank']} {k}")
        bad = {k: d for k, (d, close) in r[(case, mesh)]["grads"].items()
               if not close}
        assert not bad, (r["rank"], bad)
        metrics.append({k: m[k] for k in ("loss", "ce", "aux")})
    assert all(x == metrics[0] for x in metrics), metrics


@pytest.mark.parametrize("case,mesh", CASES, ids=IDS)
def test_checkpoints_save_the_ranks_block_of_the_residual(world, case,
                                                          mesh):
    cfg = world["cfgs"][case]
    s = CONFIGS[case][1]
    m = worker.SHAPES[mesh]["model"]
    w = -(-s // m)
    rows = B // worker.SHAPES[mesh]["data"]
    for r in world["ranks"]:
        unsplit, split = r[(case, mesh)]["saved"]
        assert r[(case, mesh)]["saved_storages"] == (cfg.num_layers,) * 2
        assert unsplit == cfg.num_layers * rows * s * cfg.d_model * 4
        assert split * s == unsplit * w, (r["rank"], split, unsplit)


@pytest.mark.parametrize("case,mesh", CASES, ids=IDS)
def test_split_adds_three_model_gathers_a_layer(world, case, mesh):
    layers = world["cfgs"][case].num_layers
    for r in world["ranks"]:
        unsplit, split = r[(case, mesh)]["by_axis"]
        assert split["model"] == unsplit["model"] + 3 * layers + 2, \
            (r["rank"], split, unsplit)
        assert split["data"] == unsplit["data"]


@pytest.mark.parametrize("case,mesh", NO_GRAD,
                         ids=[f"{c}-{m}" for c, m in NO_GRAD])
def test_no_grad_split_forward_keeps_the_in_place_collectives(world, case,
                                                              mesh):
    layers = world["cfgs"][case].num_layers
    for r in world["ranks"]:
        ng = r["no_grad"][(case, mesh)]
        assert ng["identity"], r["rank"]
        assert ng["collectives"] > 0 and ng["same_collectives"], r["rank"]
        assert ng["logits_equal"] and ng["unsplit_logits_equal"], r["rank"]
        assert ng["extra_gathers"] == layers + 1, (r["rank"], ng)
