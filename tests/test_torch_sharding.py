"""The port's sharding rules (``repro_torch.sharding.partition``) against the
JAX package's, with no process group: the spec trees of ``param_shardings``
(params and packed stores, ``expert_parallel`` both ways),
``zero1_shardings`` and ``cache_shardings`` over every shipped config, at
``.reduced()`` and at full shape, on the meshes (1, 4), (2, 2), (16, 16)
and (2, 16, 16).

The reference's trees come from ``jax.eval_shape`` (no compute). Its
spec builders are called through a stand-in mesh that has only
``.shape`` (``jax.sharding.AbstractMesh`` cannot be built on the
installed jax), with ``NamedSharding`` stood in by a holder of the spec.
The port's full-shape trees are meta tensors; its caches are small CPU
ones (a few slots). Also: ``make_sim_mesh``'s refusal, ``shard_tree``'s
blocks, and ``init_sharded`` equal to the whole init sharded."""
import dataclasses
import types

import jax
import pytest
import torch

import repro.sharding.partition as jpart
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models.model import init_decode_state as jinit_decode_state
from repro.models.model import init_params as jinit_params
from repro.models.model import quantize_model as jquantize_model
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, make_sim_mesh
from repro_torch.models import model as tmodel
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.partition import Shard

import _torch_bridge  # noqa: F401  (one torch thread a worker)

MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


class _Holder:
    """``NamedSharding`` stand-in: keeps the spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref(monkeypatch):
    """The JAX package's partition module with ``NamedSharding`` stood
    in, so its builders run on a stand-in mesh."""
    monkeypatch.setattr(jpart, "NamedSharding", _Holder)
    return jpart


def _ref_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Holder))[0]
    return {jpart._path_str(p): tuple(h.spec) for p, h in leaves}


def _port_specs(tree) -> dict:
    out = {}
    tpart.tree_specs(tree, lambda path, spec: out.setdefault(path,
                                                             tuple(spec)))
    return out


class _MetaDraw:
    """Shape-only draws for the port's full-size trees (meta tensors)."""

    device = torch.device("meta")

    def __init__(self, dtype):
        self.dtype = dtype

    def normal(self, shape, scale, dtype=None):
        return torch.empty(shape, dtype=dtype or self.dtype, device="meta")

    def uniform(self, shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def full(self, shape, value, dtype=None):
        return torch.empty(shape, dtype=dtype or self.dtype, device="meta")


def _trees(name: str, reduced: bool):
    jcfg, tcfg = jget_config(name), get_config(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jp = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    jq = jax.eval_shape(lambda p: jquantize_model(p, jcfg), jp)
    tp = tmodel._init_tree(tcfg, _MetaDraw(getattr(torch, tcfg.dtype)))
    tq = tmodel.quantize_model(tp, tcfg)
    return jcfg, tcfg, jp, jq, tp, tq


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs_equal_reference(ref, name, reduced):
    _, _, jp, jq, tp, tq = _trees(name, reduced)
    for shape in MESHES:
        jmesh = types.SimpleNamespace(shape=shape)
        tmesh = Mesh(shape)
        for ep in (False, True):
            for jt, tt in ((jp, tp), (jq, tq)):
                want = _ref_specs(ref.param_shardings(
                    jt, jmesh, expert_parallel=ep))
                got = _port_specs(tpart.param_shardings(
                    tt, tmesh, expert_parallel=ep))
                assert got == want, (shape, ep)
            want = _ref_specs(ref.zero1_shardings(jp, jmesh,
                                                  expert_parallel=ep))
            assert _port_specs(tpart.zero1_shardings(
                tp, tmesh, expert_parallel=ep)) == want, (shape, ep)
    # the EP rule reaches every routed quantized leaf (the optional
    # /(high|low) component), where a config's E divides the axis
    cfg = get_config(name)
    if cfg.is_moe and cfg.num_experts % 4 == 0:
        specs = _port_specs(tpart.param_shardings(
            tq, Mesh(MESHES[0]), expert_parallel=True))
        assert specs and all(s[1] == "model" for s in specs.values())


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_specs_equal_reference(ref, name, reduced):
    jcfg, tcfg = jget_config(name), get_config(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    want_tree = jax.eval_shape(lambda: jinit_decode_state(jcfg, 2, 32))
    got_tree = tmodel.init_decode_state(tcfg, 2, 32, device="cpu")
    for shape in MESHES:
        want = _ref_specs(ref.cache_shardings(
            want_tree, types.SimpleNamespace(shape=shape)))
        assert _port_specs(tpart.cache_shardings(
            got_tree, Mesh(shape))) == want, shape


def test_guard_and_spec_for_equal_reference_on_a_stand_in():
    """The helpers one by one on stand-in leaves (only ``.shape``)."""
    for shape in MESHES:
        jm = types.SimpleNamespace(shape=shape)
        tm = Mesh(shape)
        assert tpart.batch_spec(tm) == jpart.batch_spec(jm)
        for dims in ((64, 2048, 1024), (60, 1408, 2048), (7, 12), (16,)):
            for rule in (("model",), (None, "model"), ("model", None, None),
                         (tpart.batch_spec(tm), "model")):
                spec = tpart.P(*rule)
                assert tuple(tpart.guard_spec(spec, dims, tm)) == tuple(
                    jpart.guard_spec(jax.sharding.PartitionSpec(*rule),
                                     dims, jm))
        for path in ("/layers/moe/w_gate/high.packed",
                     "/layers/moe/w_down/low.scales", "/layers/attn/wq",
                     "/embed", "/lm_head", "/layers/moe/shared_w_up"):
            stand_in = types.SimpleNamespace(shape=(4, 60, 1408, 2048))
            for ep in (False, True):
                assert tuple(tpart._spec_for(path, stand_in.shape, tm, ep)) \
                    == tuple(jpart._spec_for(path, stand_in.shape, jm, ep))


def test_make_sim_mesh_refuses_to_degrade():
    with pytest.raises(RuntimeError) as e:
        make_sim_mesh(4)
    msg = str(e.value)
    assert "needs 4 ranks but the world has 1" in msg
    assert "spawn(fn, 4)" in msg and "torchrun --nproc-per-node 4" in msg
    assert "Refusing to degrade" in msg


def test_mesh_coordinates():
    m = Mesh({"pod": 2, "data": 16, "model": 16}, rank=16 * 16 + 3 * 16 + 5)
    assert m.coords == {"pod": 1, "data": 3, "model": 5}
    assert m.model_rank == 5 and m.model_size == 16 and m.size == 512


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_shard_tree_keeps_each_ranks_block(ep):
    """Every rank of a (1, 4) mesh keeps block r of each split leaf, and
    the blocks tile the whole leaf."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    q = tmodel.quantize_model(params, cfg)
    for tree in (params, q):
        specs = tpart.param_shardings(tree, Mesh(MESHES[0]),
                                      expert_parallel=ep)
        blocks = [tpart.shard_tree(tree, specs, Mesh(MESHES[0], rank=r),
                                   "cpu") for r in range(4)]
        whole = {}
        tpart.tree_specs(tree, lambda p, t: whole.setdefault(p, t))
        parts = [{} for _ in range(4)]
        for r in range(4):
            tpart.tree_specs(blocks[r],
                             lambda p, t, r=r: parts[r].setdefault(p, t))
        n_split = 0
        for path, t in whole.items():
            got = [parts[r][path] for r in range(4)]
            if isinstance(got[0], Shard):
                n_split += 1
                assert all(g.shape == t.shape for g in got)
                assert torch.equal(torch.cat([g.local for g in got],
                                             got[0].dim), t)
            else:
                assert all(g is t for g in got)
        assert n_split > 0
    routed = blocks[0]["layers"]["moe"]["w_gate"].high.packed
    # (L, E, N, K/vpb): E/4 experts a rank, or N/4 of every expert's rows
    assert (routed.dim, routed.local.shape[routed.dim]) == \
        ((1, 1) if ep else (2, 32))


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_init_sharded_equals_the_whole_init_sharded(ep):
    """``init_sharded`` draws layer by layer and keeps a rank's blocks:
    equal to ``shard_tree`` of the whole init and its packed store."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    whole = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    wq = tmodel.quantize_model(whole, cfg)
    for r in (0, 3):
        mesh = Mesh(MESHES[0], rank=r)
        p, q = tmodel.init_sharded(cfg, torch.Generator().manual_seed(3),
                                   mesh, expert_parallel=ep, device="cpu")
        for got, tree in ((p, whole), (q, wq)):
            want = tpart.shard_tree(tree, tpart.param_shardings(
                tree, mesh, expert_parallel=ep), mesh)
            a, b = {}, {}
            tpart.tree_specs(got, lambda path, t: a.setdefault(path, t))
            tpart.tree_specs(want, lambda path, t: b.setdefault(path, t))
            assert a.keys() == b.keys()
            for path in a:
                x, y = a[path], b[path]
                assert type(x) is type(y), path
                if isinstance(x, Shard):
                    assert x.dim == y.dim, path
                    x, y = x.local, y.local
                assert torch.equal(x, y), path


def test_kv_cache_split_layout_matches_whole_cache():
    """A split cache's prefill fill and decode writes hold, block by block,
    the slots of the whole cache (left-aligned rows, ring tails)."""
    from repro_torch.models.kv_cache import fill_kv_cache, init_kv_cache, \
        update_kv_cache
    g = torch.Generator().manual_seed(0)
    for ring, s, slots in ((False, 10, 16), (True, 21, 8), (True, 5, 8)):
        k = torch.randn((2, 2, s, 4), generator=g)
        v = torch.randn((2, 2, s, 4), generator=g)
        whole = fill_kv_cache(init_kv_cache(2, 2, slots, 4, torch.float32,
                                            "cpu", ring=ring), k, v)
        parts = [fill_kv_cache(init_kv_cache(
            2, 2, slots, 4, torch.float32, "cpu", ring=ring, shards=4,
            shard=r), k, v) for r in range(4)]
        for step in range(3):
            kn = torch.randn((2, 2, 1, 4), generator=g)
            live = torch.tensor([True, step != 1])
            update_kv_cache(whole, kn, -kn, live=live)
            for c in parts:
                update_kv_cache(c, kn, -kn, live=live)
        for name in ("k", "v", "positions"):
            assert torch.equal(torch.cat([getattr(c, name) for c in parts],
                                         dim=-2 if name != "positions"
                                         else -1), getattr(whole, name))
        assert all(torch.equal(c.length, whole.length) for c in parts)
    # a ragged (right-aligned) fill lays each row out left-aligned
    k = torch.randn((2, 2, 6, 4), generator=g)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 3], dtype=torch.int32)
    parts = [fill_kv_cache(init_kv_cache(2, 2, 8, 4, torch.float32, "cpu",
                                         shards=2, shard=r), k, k,
                           lengths=lengths, offsets=offsets)
             for r in range(2)]
    pos = torch.cat([c.positions for c in parts], dim=-1)
    assert pos.tolist() == [[0, 1, 2, 3, 4, 5, -1, -1],
                            [0, 1, 2, -1, -1, -1, -1, -1]]
    kk = torch.cat([c.k for c in parts], dim=-2)
    assert torch.equal(kk[1, :, :3], k[1, :, 3:])
    assert all(int(c.offset.abs().sum()) == 0 for c in parts)
    assert dataclasses.fields(parts[0])[-1].metadata.get("static")


def test_mesh_builders_without_a_world():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    local = make_local_mesh()
    assert local.shape == {"data": 1, "model": 1} and not local.distributed
    t = torch.ones(3)
    assert local.all_reduce(t) is t and local.all_gather(t, 0) is t
    for multi_pod, want in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs a world of {want}"):
            make_production_mesh(multi_pod=multi_pod)


def test_train_loop_keeps_mesh_and_shardings():
    """As the reference's ``TrainLoop``: stored, the step unchanged."""
    from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig
    cfg = get_config("qwen2-moe-a2.7b").reduced(num_layers=1)
    mesh = Mesh(MESHES[1])
    loop = TrainLoop(cfg, TrainLoopConfig(steps=1), device="cpu", mesh=mesh,
                     shardings=None)
    specs = tpart.zero1_shardings(loop.params, mesh)
    loop2 = TrainLoop(cfg, TrainLoopConfig(steps=1), device="cpu",
                      mesh=mesh, shardings=specs)
    assert loop.mesh is mesh and loop2.shardings is specs
    # (L 1, E 4, dm, d_ff): "data" on the first divisible whole dim
    assert specs["layers"]["moe"]["w_gate"] == tpart.P(None, "data", None,
                                                       "model")


# ------------------------------------------------- meshes with a data axis

DATA_MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


def _ranks(shape):
    size = 1
    for n in shape.values():
        size *= n
    return [Mesh(shape, rank=r) for r in range(size)]


@pytest.mark.parametrize("shape", DATA_MESHES, ids=["2x2", "2x2x2"])
def test_kv_cache_blocks_over_batch_and_slots(shape):
    """``cache_shardings`` splits k / v (L, B, H, slots, D) with the batch
    over ("pod", "data") and the slots over "model": each rank keeps the
    block of its data coordinate's rows and its model coordinate's slots,
    records the slot split, and the blocks tile the whole cache."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    caches = tmodel.init_decode_state(cfg, 8, 16, device="cpu")
    g = torch.Generator().manual_seed(0)
    whole = caches["layers"]
    for name in ("k", "v"):
        getattr(whole, name).copy_(torch.randn(
            getattr(whole, name).shape, generator=g))
    whole.positions.copy_(torch.arange(16).expand_as(whole.positions))
    specs = tpart.cache_shardings(caches, Mesh(shape))
    axes = tuple(a for a in ("pod", "data") if a in shape)
    assert tuple(specs["layers"].k) == (
        None, axes if len(axes) > 1 else axes[0], None, "model", None)
    for m in _ranks(shape):
        got = tpart.shard_tree(caches, specs, m)["layers"]
        lo, hi = m.batch_block(8)
        assert hi - lo == 8 // m.data_size
        s = 16 // m.model_size
        sl = slice(m.model_rank * s, (m.model_rank + 1) * s)
        assert torch.equal(got.k, whole.k[:, lo:hi, :, sl])
        assert torch.equal(got.v, whole.v[:, lo:hi, :, sl])
        assert torch.equal(got.positions, whole.positions[:, lo:hi, sl])
        assert torch.equal(got.length, whole.length[:, lo:hi])
        assert torch.equal(got.offset, whole.offset[:, lo:hi])
        assert (got.shards, got.shard) == (m.model_size, m.model_rank)
        assert type(got.k) is torch.Tensor


@pytest.mark.parametrize("shape", DATA_MESHES, ids=["2x2", "2x2x2"])
def test_batch_that_does_not_divide_is_replicated(shape):
    """A batch of 3 rows over 2 or 4 data ranks stays whole (the guard),
    and runs on the mesh's model view: its data axes 1."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    caches = tmodel.init_decode_state(cfg, 3, 16, device="cpu")
    mesh = Mesh(shape)
    specs = tpart.cache_shardings(caches, mesh)
    assert specs["layers"].k[1] is None
    tokens = torch.arange(3)
    bspec = tpart.guard_spec(tpart.P(tpart.batch_spec(mesh)), (3,), mesh)
    for m in _ranks(shape):
        got = tpart.shard_tree(caches, specs, m)["layers"]
        assert got.k.shape[1] == 3 and got.shards == m.model_size
        assert torch.equal(tpart.shard_tree(tokens, bspec, m), tokens)
        assert m.batch_block(3) == (0, 3)
        view = m.for_batch(3)
        assert view.data_size == 1 and view.model_size == m.model_size
        assert view.model_rank == m.model_rank
        assert m.for_batch(4) is m
    # an even batch of tokens is split, as plain rows
    even = tpart.guard_spec(tpart.P(tpart.batch_spec(mesh)), (8,), mesh)
    for m in _ranks(shape):
        lo, hi = m.batch_block(8)
        got = tpart.shard_tree(torch.arange(8), even, m)
        assert type(got) is torch.Tensor and torch.equal(
            got, torch.arange(lo, hi))


@pytest.mark.parametrize("shape", DATA_MESHES, ids=["2x2", "2x2x2"])
def test_params_whole_across_data(shape):
    """``param_shardings`` names "model" only: ranks that share a model
    coordinate hold equal blocks, whatever their data coordinates, and
    each Shard records its one model split."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    q = tmodel.quantize_model(params, cfg)
    mesh = Mesh(shape)
    for tree in (params, q):
        specs = tpart.param_shardings(tree, mesh, expert_parallel=True)
        named = set()
        tpart.tree_specs(specs, lambda p, sp: named.update(
            a for axes in sp if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)))
        assert named == {"model"}
        blocks = {}
        for m in _ranks(shape):
            leaves = {}
            tpart.tree_specs(tpart.shard_tree(tree, specs, m),
                             lambda p, x: leaves.setdefault(p, x))
            blocks.setdefault(m.model_rank, []).append(leaves)
        for model_rank, per_data in blocks.items():
            assert len(per_data) == mesh.data_size
            for path, x in per_data[0].items():
                for other in per_data[1:]:
                    a, b = x, other[path]
                    if isinstance(a, Shard):
                        assert list(a.splits.values()) == [("model",)]
                        assert a.splits == b.splits
                        a, b = a.local, b.local
                    assert torch.equal(a, b), path
