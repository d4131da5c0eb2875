"""Port parity for the training path: ``loss_fn`` and its gradients,
``remat``, AdamW and the LR schedules, the train loop, checkpoints in both
directions, and the training launcher.

The same numpy-made params (``numpy_init``, carried across with
``from_reference``) and the same numpy-seeded batches go through
``jax.value_and_grad(loss_fn)`` (one ``jax.jit`` a config) and the port's
``loss_fn`` under ``torch.autograd.grad``, on the reduced qwen2_moe_a2p7b
(MoE with a shared expert), qwen3_0p6b (dense), falcon_mamba_7b (Mamba1)
and zamba2_1p2b (Mamba2 + shared attention). Tolerances (f32): loss, ce
and aux at rtol 1e-5; every gradient leaf at rtol 1e-4, atol 1e-6; each
MoE layer's expert loads exactly equal. ``remat="block"`` gives the same
grads as ``"none"``, bit for bit. AdamW updates to a last bit (f32); the
schedules equal the reference's run op by op bit for bit over steps
0-120 (under ``jax.jit`` XLA turns a division by a constant into a product
with its reciprocal, which moves a last bit, so the train-loop history is
compared at rtol 1e-4). Checkpoints cross-read bit for bit (f32 and
bf16)."""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import n, numpy_init, port, port_cfg
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import synthetic_lm_batches as jsynthetic
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.models.config import ModelConfig
from repro.training import TrainLoop as JTrainLoop
from repro.training import TrainLoopConfig as JTrainLoopConfig
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import constant_lr as jconstant_lr
from repro.training.optimizer import cosine_lr as jcosine_lr
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tmodel
from repro_torch.models.model import init_params, loss_fn
from repro_torch.training import AdamW, TrainLoop, TrainLoopConfig, \
    constant_lr, cosine_lr, latest_step, load_checkpoint, save_checkpoint
from repro_torch.tree import tree_map, tree_paths

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = ["qwen2_moe_a2p7b", "qwen3_0p6b", "falcon_mamba_7b", "zamba2_1p2b"]


def _tiny_moe(dtype="float32"):
    """``tests/test_train.py::_tiny_moe``."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=2, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=64, dtype=dtype, remat="none")


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jpaths(tree):
    """{path: array} of a JAX tree, keyed as the checkpoint keys it."""
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _port_grads(params, cfg, batch):
    """(loss, metrics, {path: grad}) of the port's ``loss_fn``."""
    leaves = []

    def track(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    loss, metrics = loss_fn(tree_map(track, params), cfg,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, dict(zip(tree_paths(params), map(n, grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    cfg = jget_config(arch).reduced()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    jloads, tloads = [], []

    def jrecord(*a, **kw):
        y, st = moe_sharded(*a, **kw)
        jax.debug.callback(lambda v: jloads.append(np.asarray(v)),
                           st.expert_load)
        return y, st

    def trecord(*a, **kw):
        y, st = tmoe_sharded(*a, **kw)
        tloads.append(n(st.expert_load))
        return y, st

    moe_sharded, tmoe_sharded = (jmodel.moe_apply_sharded,
                                 tmodel.moe_apply_sharded)
    monkeypatch.setattr(jmodel, "moe_apply_sharded", jrecord)
    monkeypatch.setattr(tmodel, "moe_apply_sharded", trecord)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jmodel.loss_fn(p, cfg, bt), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(port(params), port_cfg(cfg), batch)

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5)
    jflat = _jpaths(jgrads)
    assert set(grads) == set(jflat)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jflat[k], err_msg=k, **GRAD_TOL)
    assert len(tloads) == (cfg.num_layers if cfg.is_moe else 0)
    assert len(jloads) == len(tloads)
    for a, b in zip(tloads, jloads):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "zamba2_1p2b"])
def test_remat_block_matches_none(arch):
    """``tests/test_train.py::test_remat_matches_no_remat`` on the port
    (checkpointed blocks, the hybrid's shared block inside them)."""
    cfg = port_cfg(jget_config(arch).reduced())
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    _, _, g_none = _port_grads(params, cfg, batch)
    cfg_r = port_cfg(jget_config(arch).reduced(remat="block"))
    _, _, g_block = _port_grads(params, cfg_r, batch)
    for k in g_none:
        np.testing.assert_array_equal(g_block[k], g_none[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(dtype, weight_decay):
    """Three updates with the clip in force (global norm ~ 20), weight
    decay only on 2-D leaves: moments and f32 params at rtol 1e-6, atol
    1e-7 (the global norm sums in another order than ``jnp.sum``: a last
    bit of updates ~0.1), bf16 params to one bf16 ulp (rtol 2^-7)."""
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((4, 8)), "b": rng.standard_normal(8),
         "nested": {"h": rng.standard_normal((3, 5))}}
    g = tree_map(lambda a: 3 * rng.standard_normal(a.shape), p)
    jp = tree_map(lambda a: jnp.asarray(a, dtype), p)
    jg = tree_map(lambda a: jnp.asarray(a, jnp.float32), g)
    tp, tg = port(jp), port(jg)
    jopt = JAdamW(lr=jcosine_lr(0.1, 2, 10), weight_decay=weight_decay)
    topt = AdamW(lr=cosine_lr(0.1, 2, 10), weight_decay=weight_decay)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js = jopt.update(jp, jg, js)
        tp, ts = topt.update(tp, tg, ts)
    assert int(ts.step) == int(js.step) == 3
    for mine, ref, rtol in ((tp, jp, 2 ** -7 if dtype == "bfloat16"
                             else 1e-6), (ts.mu, js.mu, 1e-6),
                            (ts.nu, js.nu, 1e-6)):
        ref = _jpaths(ref)
        for k, v in tree_paths(mine).items():
            assert str(v.dtype) == "torch." + ref[k].dtype.name
            np.testing.assert_allclose(n(v.float()),
                                       ref[k].astype(np.float32),
                                       rtol=rtol, atol=1e-7, err_msg=k)


def _bits(x):
    """A tensor's or array's values as numpy, bf16 as its int16 bits (so
    equality is bitwise and carries the dtype)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("sched", ["cos_1e-2_5_60", "cos_3e-4_20_100",
                                   "cos_1_10_100_0.05", "const_3e-4"])
def test_schedules_bitwise(sched):
    kind, *args = sched.split("_")
    args = [float(a) if "." in a or "e" in a else int(a) for a in args]
    if kind == "cos":
        jf, tf = jcosine_lr(*args), cosine_lr(*args)
    else:
        jf, tf = jconstant_lr(*args), constant_lr(*args)
    steps = range(121)
    ref = np.array([np.asarray(jf(jnp.asarray(i))) for i in steps])
    got = np.array([n(tf(torch.tensor(i, dtype=torch.int32)))
                    for i in steps])
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_train_loop_history_matches_reference():
    """Five steps of both loops from the same params and batches (log
    every step): loss, ce and aux at rtol 1e-4; the last step's metrics
    and the returned keys equal."""
    cfg = _tiny_moe()
    lc = dict(steps=5, lr=1e-2, warmup=2, log_every=1)
    jloop = JTrainLoop(cfg, JTrainLoopConfig(**lc))
    loop = TrainLoop(port_cfg(cfg), TrainLoopConfig(**lc), device="cpu")
    loop.params = port(jloop.params)
    loop.opt_state = loop.optimizer.init(loop.params)
    dc = dict(batch_size=4, seq_len=32, vocab_size=256)
    jres = jloop.run(jsynthetic(JDataConfig(**dc)))
    res = loop.run(synthetic_lm_batches(DataConfig(**dc)))
    assert set(res) == set(jres) == {"loss", "ce", "aux", "wall_s", "steps"}
    assert [h["step"] for h in loop.history] == list(range(5))
    for mine, ref in zip(loop.history + [res], jloop.history + [jres]):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4)


def test_loss_decreases():
    """``tests/test_train.py::test_loss_decreases`` on the port."""
    loop = TrainLoop(port_cfg(_tiny_moe()),
                     TrainLoopConfig(steps=30, lr=1e-2, warmup=5,
                                     log_every=5), device="cpu")
    loop.run(synthetic_lm_batches(DataConfig(batch_size=4, seq_len=32,
                                             vocab_size=256)))
    assert loop.history[-1]["loss"] < loop.history[0]["loss"] - 0.3


def _ckpt_tree(dtype):
    """A nested tree with stacked, 1-D and integer leaves."""
    cfg = _tiny_moe(dtype=dtype)
    params = init_params(port_cfg(cfg), torch.Generator().manual_seed(3),
                         "cpu")
    params["count"] = torch.arange(5, dtype=torch.int32)
    return params


def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(_bits(t)).view(jnp.bfloat16)
                    if t.dtype == torch.bfloat16 else jnp.asarray(n(t)),
                    tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_port_written_reads_in_reference(dtype, tmp_path):
    tree = _ckpt_tree(dtype)
    save_checkpoint(str(tmp_path), 7, tree)
    restored, step = jckpt.load_checkpoint(str(tmp_path), 7, _to_jax(tree))
    assert step == 7
    ref = _jpaths(restored)
    for k, v in tree_paths(tree).items():
        assert ref[k].dtype.name == str(v.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(ref[k]), _bits(v), err_msg=k)
    back, _ = load_checkpoint(str(tmp_path), 7, tree)
    for k, v in tree_paths(back).items():
        np.testing.assert_array_equal(_bits(v), _bits(tree_paths(tree)[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_reference_written_reads_in_port(dtype, tmp_path):
    tree = _ckpt_tree(dtype)
    jtree = _to_jax(tree)
    jckpt.save_checkpoint(str(tmp_path), 3, jtree)
    jckpt.save_checkpoint(str(tmp_path), 12, jtree)
    assert latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) \
        == 12
    restored, step = load_checkpoint(str(tmp_path), 12, tree)
    assert step == 12
    ref = _jpaths(jtree)
    for k, v in tree_paths(restored).items():
        assert v.dtype == tree_paths(tree)[k].dtype and v.device.type == "cpu"
        np.testing.assert_array_equal(_bits(v), _bits(ref[k]), err_msg=k)


def test_latest_step_without_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        latest_step(str(tmp_path))


def test_launch_train_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` at a tiny size:
    the reference's per-step lines and result keys, and its final
    checkpoint; without ``--device`` it needs CUDA."""
    result = launch_train.main([
        "--device", "cpu", "--steps", "12", "--batch-size", "2",
        "--seq-len", "8", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [int(re.match(r"step +(\d+)  loss \d+\.\d{4}  ce \d+\.\d{4}$",
                         line).group(1)) for line in out[:-1]] == [0, 10]
    assert json.loads(out[-1]) == result
    assert set(result) == {"loss", "ce", "aux", "wall_s", "steps"}
    assert result["steps"] == 12 and np.isfinite(result["loss"])
    assert latest_step(str(tmp_path)) == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--steps", "1"])
