"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: ``SHAPES``, ``shape_adapted_config``, ``strip_expert_weights``
and ``_extrapolate``; the argument bytes a rank on (1, 4), 16×16 and
2×16×16 against the same arithmetic on the reference's spec trees (built
through a stand-in mesh that has only ``.shape``, with ``NamedSharding``
stood in by a holder of the spec, as ``tests/test_torch_sharding.py``
does: ``AbstractMesh`` cannot be built on the installed jax); and
``run_one`` on a reduced config at small shapes: the reference's record
keys, its ``model_flops``, ``0 < useful_flops_ratio <= 1``, collectives on
an expert-parallel (1, 4) mesh; on 16×16 and 2×16×16 rank 0's traced
decode step, with ``local_dispatch`` the (1, 16) step at 1/16 of the
batch (only statistics cross "data") and without it the data gather's
bytes, and the train step's traced terms (with and without ZeRO-1); the
same argument bytes and traced terms for the SSM archs (Mamba1, and
Mamba2 with shared attention sites) on (1, 4) and 16×16; and ``seq_acts``
(the train carry split along the sequence over "model"): the full-size
OLMoE ``train_4k`` record on 16×16, with and without ``local_dispatch``,
its temp lower by the carries' saving, 3 L + 2 more "model" gathers, and
prefill and decode records unchanged by it."""
import os
import types

import jax
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a worker)
import repro.sharding.partition as jpart
from repro.configs import get_config as jget_config
from repro.roofline import model_flops_estimate as jflops
from repro.roofline import roofline_terms as jterms
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.partition import tree_specs

# the reference's dry run asks for 512 host devices at import; the backend
# is up already, so that cannot reach it, and the flag is put back
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS


class _Holder:
    """``NamedSharding`` stand-in: keeps the spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref(monkeypatch):
    monkeypatch.setattr(jpart, "NamedSharding", _Holder)
    monkeypatch.setattr(jdry, "NamedSharding", _Holder)
    return jdry


def test_shapes_and_window_equal_the_reference():
    assert dryrun.SHAPES == jdry.SHAPES
    assert dryrun.LONG_CONTEXT_WINDOW == jdry.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "qwen3_0p6b",
                                  "falcon_mamba_7b", "zamba2_1p2b"])
def test_shape_adapted_config_and_strip_equal_the_reference(name):
    for shape in dryrun.SHAPES:
        got = dryrun.shape_adapted_config(get_config(name), shape)
        want = jdry.shape_adapted_config(jget_config(name), shape)
        assert got.sliding_window == want.sliding_window
    cfg = get_config(name).reduced()
    params = dryrun.strip_expert_weights(
        dryrun._meta_params(cfg), cfg)
    jcfg = jget_config(name).reduced()
    jparams = jdry.strip_expert_weights(jax.eval_shape(
        lambda: jdry.init_params(jcfg, jax.random.PRNGKey(0))), jcfg)
    mine = {}
    tree_specs(params, lambda p, t: mine.setdefault(p, tuple(t.shape)))
    theirs = {jpart._path_str(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert mine == theirs


def test_extrapolate_equals_the_reference():
    for args in ((10.0, 40.0, 4, 16), (5.0, 5.0, 2, 28), (3.0, 1.0, 2, 8),
                 (7.0, 9.0, 1, 12)):
        assert dryrun._extrapolate(*args) == jdry._extrapolate(*args)


def _ref_bytes(args, shardings, mesh) -> int:
    """Each leaf's bytes over the mesh axes its spec splits it over, on
    the reference's trees."""
    total = 0
    leaves = jax.tree_util.tree_leaves(args)
    specs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, _Holder))
    assert len(leaves) == len(specs)
    for leaf, h in zip(leaves, specs):
        n = 1
        for axes in h.spec:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                if a is not None:
                    n *= mesh.shape[a]
        total += leaf.size * leaf.dtype.itemsize // n
    return total


def _arg_cases():
    """(arch, shape, ep) with the OLMoE cases' ids as they were, the SSM
    archs' prefixed with the arch."""
    out = []
    for arch in ("olmoe_1b_7b", "falcon_mamba_7b", "zamba2_1p2b"):
        for ep in (True, False):
            for shape in ("decode_32k", "prefill_32k", "train_4k"):
                tag = f"{'ep' if ep else 'tp'}-{shape}"
                out.append(pytest.param(
                    arch, shape, ep,
                    id=tag if arch == "olmoe_1b_7b" else f"{arch}-{tag}"))
    return out


@pytest.mark.parametrize("arch,shape,ep", _arg_cases())
def test_argument_bytes_a_rank_equal_the_reference(ref, arch, shape, ep):
    """On every mesh of ``dryrun.MESHES``; the SSM archs' Mamba weights and
    caches split over "model" as the reference's rules say."""
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    for name in dryrun.MESHES:
        mesh = Mesh(dryrun.MESHES[name])
        stand_in = types.SimpleNamespace(shape=dict(dryrun.MESHES[name]))
        _, _, args, shardings = dryrun.build_specs(cfg, shape, mesh, ep)
        _, _, jargs, jshard = ref.build_specs(jcfg, shape, stand_in, ep)
        got = dryrun.argument_bytes(args, shardings, mesh)
        assert got == _ref_bytes(jargs, jshard, stand_in), (shape, name)


def test_argument_bytes_full_size_on_16x16(ref):
    """Full-size OLMoE's serve-step arguments a rank on 16 × 16: no world
    of 256 ranks, meta tensors and shape arithmetic only."""
    mesh = Mesh(dryrun.MESHES["16x16"])
    stand_in = types.SimpleNamespace(shape=dict(mesh.shape))
    _, _, args, shardings = dryrun.build_specs(
        get_config("olmoe_1b_7b"), "decode_32k", mesh, True)
    _, _, jargs, jshard = ref.build_specs(
        jget_config("olmoe_1b_7b"), "decode_32k", stand_in, True)
    assert dryrun.argument_bytes(args, shardings, mesh) == \
        _ref_bytes(jargs, jshard, stand_in)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_argument_bytes_full_size_ssm_on_production_meshes(ref, arch):
    """Full-size Mamba1 and the Mamba2 hybrid: the serve step's arguments
    a rank on 16 × 16 and 2 × 16 × 16 (its channel and head blocks of the
    weights and of the SSM state, its rows)."""
    for name in ("16x16", "2x16x16"):
        mesh = Mesh(dryrun.MESHES[name])
        stand_in = types.SimpleNamespace(shape=dict(mesh.shape))
        _, _, args, shardings = dryrun.build_specs(
            get_config(arch), "decode_32k", mesh)
        _, _, jargs, jshard = ref.build_specs(
            jget_config(arch), "decode_32k", stand_in, False)
        assert dryrun.argument_bytes(args, shardings, mesh) == \
            _ref_bytes(jargs, jshard, stand_in), name


_KEYS = {"arch", "shape", "mesh", "chips", "expert_parallel", "opts",
         "phase", "lower_s", "compile_s", "memory", "collectives",
         "model_flops", "useful_flops_ratio"}


@pytest.fixture
def tiny(monkeypatch):
    """The reduced OLMoE under its own name, and small shapes: a decode
    batch of 32 (2 rows a data rank on 16×16, 1 on 2×16×16) and its
    1/16th, and a train step."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced())
    monkeypatch.setitem(dryrun.SHAPES, "decode_tiny",
                        dict(seq_len=64, global_batch=4, phase="decode"))
    monkeypatch.setitem(dryrun.SHAPES, "prefill_tiny",
                        dict(seq_len=32, global_batch=2, phase="prefill"))
    monkeypatch.setitem(dryrun.SHAPES, "decode_b32",
                        dict(seq_len=64, global_batch=32, phase="decode"))
    monkeypatch.setitem(dryrun.SHAPES, "decode_b2",
                        dict(seq_len=64, global_batch=2, phase="decode"))
    monkeypatch.setitem(dryrun.SHAPES, "train_tiny",
                        dict(seq_len=16, global_batch=32, phase="train"))
    monkeypatch.setitem(dryrun.MESHES, "1x16", {"data": 1, "model": 16})


@pytest.mark.parametrize("shape", ["decode_tiny", "prefill_tiny"])
def test_run_one_record_has_the_reference_keys(tiny, tmp_path, shape):
    r = dryrun.run_one("olmoe_1b_7b", shape, save_dir=str(tmp_path),
                       verbose=False)
    terms = jterms({"flops": 1.0, "bytes accessed": 1.0}, 1)
    assert _KEYS | set(terms) <= set(r)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes"} <= set(r["memory"])
    info = dryrun.SHAPES[shape]
    tokens = info["global_batch"] * (1 if info["phase"] == "decode"
                                     else info["seq_len"])
    assert r["model_flops"] == jflops(
        jget_config("olmoe_1b_7b").reduced(), tokens=tokens,
        phase=info["phase"])
    assert 0 < r["useful_flops_ratio"] <= 1
    assert r["hw"]["peak_flops"] == 989e12 and r["dominant"]
    assert r["memory"]["peak_bytes"] == \
        r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]
    assert (tmp_path / "1x1.jsonl").read_text().count("\n") == 1


def test_run_one_expert_parallel_counts_collectives(tiny, tmp_path):
    r = dryrun.run_one("olmoe_1b_7b", "decode_tiny", mesh="1x4",
                       expert_parallel=True, save_dir=str(tmp_path),
                       verbose=False)
    assert r["chips"] == 4 and r["collectives"]["total"] > 0
    assert r["collective_bytes"] == r["collectives"]["total"]
    assert r["t_collective_s"] > 0
    one = dryrun.run_one("olmoe_1b_7b", "decode_tiny", save_dir=None,
                         verbose=False)
    # a rank holds a quarter of the experts
    assert r["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]


@pytest.mark.parametrize("opts", [(), ("zero1",)], ids=["plain", "zero1"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_run_one_on_16x16_traces_the_train_step(tiny, mesh, opts):
    """Rank 0's train step on the production meshes: its FLOPs, bytes,
    compute time and collectives by axis; the grads' SUM over "data"
    carries at least the rank's grad bytes (its param blocks' bytes); with
    ``zero1`` a rank's moments are exactly its spec blocks (the Shards the
    trace runs on hold the bytes ``argument_bytes`` gives the spec tree),
    fewer than without."""
    r = dryrun.run_one("olmoe_1b_7b", "train_tiny", mesh=mesh,
                       save_dir=None, verbose=False, opts=opts)
    assert r["traced"] == "rank 0 on meta"
    for k in ("flops", "bytes", "t_compute_s", "t_memory_s",
              "t_collective_s"):
        assert r[k] is not None and r[k] > 0, k
    by = r["collectives_by_axis"]
    assert by["model"]["collectives"] > 0 and by["data"]["collectives"] > 0
    m = Mesh(dryrun.MESHES[mesh])
    cfg, _, args, shardings = dryrun.build_specs(
        get_config("olmoe_1b_7b").reduced(), "train_tiny", m, opts=opts)
    grad_bytes = dryrun.argument_bytes(args[:1], shardings[:1], m)
    assert by["data"]["total"] >= grad_bytes > 0
    moments = dryrun.argument_bytes(args[1:2], shardings[1:2], m)
    blocks = tpart.shard_tree(args[1], shardings[1], m, shard_all=True)
    held = []
    tree_specs(blocks, lambda p, x: held.append(
        (x.local if isinstance(x, tpart.Shard) else x)))
    assert sum(t.numel() * t.element_size() for t in held) == moments
    if opts:
        _, _, pargs, pshard = dryrun.build_specs(cfg, "train_tiny", m)
        assert moments < dryrun.argument_bytes(pargs[1:2], pshard[1:2], m)
    assert r["memory"]["argument_bytes_by_mesh"][mesh] == \
        r["memory"]["argument_bytes"]


def test_run_one_on_16x16_with_local_dispatch_is_the_1x16_step(tiny):
    """With ``local_dispatch`` a 16×16 rank runs the (1, 16) step at 1/16
    of the global batch: the same FLOPs and "model" payload, bytes within
    1 %; only statistics cross "data" — per layer, the one-mask site's
    sums (importance, look-ahead counts and mass, valid tokens: 3E + 1
    f32) and the 16 groups' merged MoE statistics (16 × (3E + 2) f32)."""
    cfg = get_config("olmoe_1b_7b").reduced()
    e, layers = cfg.num_experts, cfg.num_layers
    r = dryrun.run_one("olmoe_1b_7b", "decode_b32", mesh="16x16",
                       save_dir=None, verbose=False,
                       opts=("local_dispatch",))
    one = dryrun.run_one("olmoe_1b_7b", "decode_b2", mesh="1x16",
                         save_dir=None, verbose=False)
    assert r["traced"] == "rank 0 on meta"
    assert r["flops"] == one["flops"] > 0
    assert abs(r["bytes"] - one["bytes"]) <= 0.01 * one["bytes"]
    by, by1 = r["collectives_by_axis"], one["collectives_by_axis"]
    assert by["model"] == by1["model"] and by1["data"]["total"] == 0
    assert by["data"]["total"] == layers * 4 * (
        (3 * e + 1) + 16 * (3 * e + 2))
    assert r["collectives"]["total"] == by["model"]["total"] + \
        by["data"]["total"] + by["world"]["total"]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_run_one_without_local_dispatch_counts_the_data_gather(tiny, mesh):
    """Without ``local_dispatch`` the one-mask MoE site gathers its tokens
    over "data" (global capacity, as the reference's GSPMD program): per
    layer, the whole batch's (B, d_model) hidden rows."""
    cfg = get_config("olmoe_1b_7b").reduced()
    r = dryrun.run_one("olmoe_1b_7b", "decode_b32", mesh=mesh,
                       save_dir=None, verbose=False)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    assert r["collectives_by_axis"]["data"]["all-gather"] == \
        cfg.num_layers * 32 * cfg.d_model * itemsize
    assert r["flops"] > 0 and r["t_collective_s"] > 0


def test_run_one_ssm_on_1x4_counts_collectives(tiny, tmp_path):
    """Reduced zamba2 (Mamba2 and two shared attention sites) on (1, 4):
    rank 0's traced decode step crosses "model" only."""
    r = dryrun.run_one("zamba2_1p2b", "decode_tiny", mesh="1x4",
                       save_dir=str(tmp_path), verbose=False)
    assert r["traced"] == "rank 0 on meta" and r["flops"] > 0
    assert r["collectives"]["total"] > 0 and r["t_collective_s"] > 0
    by = r["collectives_by_axis"]
    assert by["model"]["collectives"] > 0 and by["data"]["total"] == 0
    one = dryrun.run_one("zamba2_1p2b", "decode_tiny", save_dir=None,
                         verbose=False)
    assert one["collectives"]["total"] == 0
    assert r["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]


@pytest.mark.parametrize("shape", ["decode_b32", "prefill_tiny"])
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_run_one_ssm_on_16x16_gives_traced_terms(tiny, arch, shape):
    """Rank 0's decode and prefill steps of the SSM archs on 16 × 16: its
    rows of the batch (or the whole batch where 16 does not divide it)
    and its blocks of the Mamba weights (whole where 16 does not divide
    them: reduced zamba2's 8 heads)."""
    r = dryrun.run_one(arch, shape, mesh="16x16", save_dir=None,
                       verbose=False)
    assert r["traced"] == "rank 0 on meta"
    assert r["flops"] > 0 and r["bytes"] > 0 and r["dominant"]
    assert r["collectives_by_axis"]["model"]["collectives"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1


@pytest.fixture(scope="module")
def seq_records():
    """Full-size OLMoE ``train_4k`` on 16×16, with and without
    ``seq_acts``, with and without ``local_dispatch`` (~6 s a record)."""
    return {(ld, seq): dryrun.run_one(
        "olmoe_1b_7b", "train_4k", mesh="16x16", save_dir=None,
        verbose=False, opts=(("local_dispatch",) if ld else ())
        + (("seq_acts",) if seq else ()))
        for ld in (False, True) for seq in (False, True)}


def _carry_bytes(cfg, mesh: str, shape: str) -> int:
    """One layer's residual (rows a data rank, S, d_model) in bf16."""
    info = dryrun.SHAPES[shape]
    rows = info["global_batch"] // Mesh(dryrun.MESHES[mesh]).data_size
    return rows * info["seq_len"] * cfg.d_model * 2


@pytest.mark.parametrize("ld", [False, True], ids=["plain", "local_dispatch"])
def test_seq_acts_lowers_the_train_temp_bytes(seq_records, ld):
    """The checkpoints save a 16th of each layer's 268 MB carry: the
    traced peak falls by 16 carries less a block (4.03 GB) where it sits
    at the forward's end (``local_dispatch``); without it the split
    step's peak moves to the end of the backward, where 15 layers' param
    grads (0.79 GB a rank) are alive too, and the fall is 3.48 GB."""
    cfg = get_config("olmoe_1b_7b")
    carry = _carry_bytes(cfg, "16x16", "train_4k")
    assert carry == 268_435_456
    base, seq = seq_records[(ld, False)], seq_records[(ld, True)]
    fall = base["memory"]["temp_bytes"] - seq["memory"]["temp_bytes"]
    assert fall >= (3.5e9 if ld else 3.4e9), fall
    assert fall <= cfg.num_layers * carry * 15 // 16, fall
    assert seq["memory"]["argument_bytes"] == base["memory"]["argument_bytes"]


@pytest.mark.parametrize("ld", [False, True], ids=["plain", "local_dispatch"])
def test_seq_acts_adds_three_model_gathers_a_layer(seq_records, ld):
    """Each layer's entry gather, again at the recompute, and its exit's
    backward gather, plus the gather after the last layer and the
    embedding's backward one: 3 L + 2 more "model" gathers of one whole
    carry each; "data", the FLOPs and the all-reduces unchanged."""
    cfg = get_config("olmoe_1b_7b")
    carry = _carry_bytes(cfg, "16x16", "train_4k")
    base, seq = seq_records[(ld, False)], seq_records[(ld, True)]
    bm, sm = (r["collectives_by_axis"]["model"] for r in (base, seq))
    n = 3 * cfg.num_layers + 2
    assert sm["collectives"] == bm["collectives"] + n
    assert sm["all-gather"] == bm["all-gather"] + n * carry
    assert sm["all-reduce"] == bm["all-reduce"]
    assert seq["collectives_by_axis"]["data"] == \
        base["collectives_by_axis"]["data"]
    assert seq["flops"] == base["flops"]


@pytest.mark.parametrize("mesh", ["1x4", "16x16"])
@pytest.mark.parametrize("shape", ["decode_b32", "prefill_tiny"])
def test_seq_acts_leaves_prefill_and_decode_unchanged(tiny, shape, mesh):
    """Only the training forward reads ``act_seq_shard``: a prefill and a
    decode record are the same numbers with and without ``seq_acts``."""
    keep = ("flops", "bytes", "memory", "collectives",
            "collectives_by_axis", "model_flops")
    base, seq = (dryrun.run_one("olmoe_1b_7b", shape, mesh=mesh,
                                save_dir=None, verbose=False, opts=opts)
                 for opts in ((), ("seq_acts",)))
    assert base["collectives"]["total"] > 0
    assert {k: base[k] for k in keep} == {k: seq[k] for k in keep}
