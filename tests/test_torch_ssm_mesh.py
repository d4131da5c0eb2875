"""Mamba1 (falcon-mamba) and the Mamba2 hybrid (zamba2: Mamba2 layers and
a weight-shared attention block) served and run on meshes of 4 gloo ranks
on the CPU, held to the JAX package's unsharded engine and forward
functions, reduced and f32.

ONE spawn of 4 ranks runs every case (``tests/_torch_ssm_worker.py``);
the JAX numbers are computed once here in the parent, from the same
numpy-made weights. Each rank holds the blocks ``param_shardings`` and
``cache_shardings`` give it: the in-projection's columns, the conv's
channels, the out-projection's rows, its channels (Mamba1) or heads
(Mamba2) of the recurrent state, and the shared sites' KV slots. Cases,
on a (1, 4) and a (2, 2) ("data", "model") mesh:

  * ``generate_batch`` of four requests on 4 slots, "4/2" and "off"
    (full precision): every rank's tokens and modeled TTFT/TPOT equal the
    JAX engine's. An SSM admission is one exact-shape solo prefill, run
    by the data rank whose slot it takes; request 1 ends at its first
    token, so request 2 takes slot 1 (the first data block) and request 3
    slot 2 (the second);
  * every rank's K2 (packed matmul) calls equal the one-rank run's: each
    runs its block of every projection once;
  * ``prefill`` and ``decode_step`` (row 1 dead) on this rank's rows:
    logits within atol = rtol = 1e-5 of the JAX functions'; each rank's
    ``conv_state`` / ``ssm_state`` / shared-site KV block within the same
    tolerance of the matching block of the JAX caches (the dead row's
    the prefill's, as the reference's ``decode_many_batched`` freezes
    it), ``length`` and positions exact; the dead row's state bitwise
    unchanged.

A third config degrades on (1, 4): reduced zamba2 with d_inner 384 has 6
heads, so the heads, the per-head vectors and the 806-column
in-projection stay whole on every rank while the conv's 416 channels, the
gate norm and the out-projection split; the conv output, the scan's x
channels and the gate norm then meet blocks that differ from their
input's. It runs every case above on (1, 4).

Without a world: on 16 ranks a reduced zamba2 split degrades (8 heads,
an in-projection of 1,064 columns): ``shard_tree`` keeps each rank's
block of an ``SSMCache`` and ``init_ssm_cache`` allocates the same
blocks; ``init_sharded`` equals ``shard_tree`` of the whole init for
both SSM archs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ssm_worker as worker
from _torch_bridge import jit_run, numpy_init, port_caches, port_cfg, \
    quantized_pair, to_numpy_tree
from _torch_ep_worker import plain
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.model import decode_step as jdecode_step
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeProfile as JProfile
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models import model as tmodel
from repro_torch.models.kv_cache import cache_tensors
from repro_torch.models.layers.ssm import init_ssm_cache
from repro_torch.sharding import partition as tpart

N = 4
ARCHS = ("falcon_mamba_7b", "zamba2_1p2b")
# case name -> (arch, ``reduced()`` overrides, meshes)
CONFIGS = {a: (a, {}, tuple(worker.SHAPES)) for a in ARCHS}
CONFIGS["zamba2_1p2b-6heads"] = ("zamba2_1p2b", dict(d_inner=384), ("1x4",))
TOL = dict(atol=1e-5, rtol=1e-5)
EXACT = ("length", "positions", "offset")


def _jax_served(cfg, params, mode):
    """The JAX engine's ``worker.served`` (same requests)."""
    eng = JEngine(worker.mode_cfg(cfg, mode), params, JEngineConfig(
        profile=JProfile().with_vram(12), decode_chunk=4,
        use_dymoe=mode != "off"))
    return [plain(r) for r in eng.generate_batch(
        [JRequest(prompt_tokens=list(r.prompt_tokens),
                  max_new_tokens=r.max_new_tokens, request_id=r.request_id)
         for r in worker.requests()], num_slots=4)]


def _jax_forward(cfg, params):
    """The forward cases' inputs, and the reference's logits and caches
    after a prefill of 4 rows and a decode step with row 1 dead, on the
    port's packed store."""
    jq, _ = quantized_pair(params, cfg)
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (4, 11))
    slots = 16
    logits, caches, _ = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=jq, cache_slots=slots))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    pre = dict(logits=np.asarray(logits), caches=port_caches(caches))
    live = jnp.asarray(worker.LIVE)
    dlogits, dcaches, _ = jit_run(lambda: jdecode_step(
        params, cfg, jnp.asarray(tok0), caches, qparams=jq,
        per_row_moe=True, live_rows=live))
    # a dead row's state: the prefill's (the reference freezes finished
    # rows over the whole cache in decode_many_batched)
    dcaches = jax.tree.map(
        lambda new, old: jnp.where(
            live.reshape((1, -1) + (1,) * (new.ndim - 2)), new, old),
        dcaches, caches)
    dec = dict(logits=np.asarray(dlogits), caches=port_caches(dcaches))
    return dict(prompt=prompt, slots=slots, tok0=tok0), \
        dict(prefill=pre, decode=dec)


def _one_rank(cfg, np_params):
    """The port's one-rank ``worker.served``, "4/2"."""
    from repro_torch.params import from_reference
    return worker.served(cfg, from_reference(np_params, "cpu"), "4/2")


@pytest.fixture(scope="module")
def world():
    cases, jax_out = {}, {}
    for name, (arch, over, shapes) in CONFIGS.items():
        jcfg = jget_config(arch).reduced(**over)
        params = numpy_init(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
        fx, want = _jax_forward(jcfg, params)
        np_params = to_numpy_tree(params)
        cfg = port_cfg(jcfg)
        cases[name] = (cfg, np_params, fx, shapes)
        jax_out[name] = dict(
            served={m: _jax_served(jcfg, params, m) for m in worker.MODES},
            forward=want, one=_one_rank(cfg, np_params))
    ranks = spawn(worker.run, N, cases, timeout_s=90.0)
    return dict(ranks=ranks, jax=jax_out, cases=cases)


CASES = [(a, s) for a, (_, _, shapes) in CONFIGS.items() for s in shapes]
IDS = [f"{a}-{s}" for a, s in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
@pytest.mark.parametrize("mode", worker.MODES)
def test_engine_equals_the_unsharded_jax_engine(world, arch, shape, mode):
    """Tokens and every modeled field on every rank; eager over the mesh,
    the session's slots split over the data ranks on (2, 2)."""
    want = world["jax"][arch]["served"][mode]
    for r in world["ranks"]:
        got = r[(arch, shape)][mode]
        assert got["rows"] == want, (r["rank"], arch, shape, mode)
        assert got["stats"]["compiles"] == 0
        assert got["stats"]["mesh"] == worker.SHAPES[shape]
        assert got["by_axis"]["model"] > 0
        # a data rank holds its block of the 4 slots (2 on (2, 2))
        assert got["state_rows"] == [4 // worker.SHAPES[shape]["data"]]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_k2_calls_a_rank_match_its_prefills_and_steps(world, arch, shape):
    """Each rank runs its block of both projections of every layer once a
    prefill and a decode step: 2 L K2 calls each. On (1, 4) every rank
    prefills every request, as one rank does (the same count); on (2, 2)
    each data rank prefills the requests headed for its slots, so the
    data ranks' prefills add up to the one rank's."""
    cfg = world["cases"][arch][0]
    one = world["jax"][arch]["one"]
    per = 2 * cfg.num_layers
    steps = one["stats"]["decode_steps"]
    assert one["k2"] == per * (len(one["prefills"]) + steps) > 0
    split = {}
    for r in world["ranks"]:
        got = r[(arch, shape)]["4/2"]
        assert got["stats"]["decode_steps"] == steps, r["rank"]
        assert got["k2"] == per * (len(got["prefills"]) + steps), r["rank"]
        assert set(got["prefills"]) == {1}          # solo admissions
        data, model = r[(arch, shape)]["coords"]
        split.setdefault(model, []).append(len(got["prefills"]))
        if shape == "1x4":
            assert got["k2"] == one["k2"], r["rank"]
    for counts in split.values():
        assert sum(counts) == len(one["prefills"]), split
    if shape == "2x2":
        assert split[0] == [3, 1]   # the finisher's and slots 0-1; slot 2


def _rank_blocks(caches, shape, rank):
    """Rank ``rank``'s blocks of the whole port ``caches`` under
    ``cache_shardings``: its rows and its channels, heads or slots."""
    mesh = Mesh(worker.SHAPES[shape], rank)
    return tpart.shard_tree(caches, tpart.cache_shardings(caches, mesh),
                            mesh)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_forward_blocks_equal_the_jax_functions(world, arch, shape, step):
    """Logits of the rank's rows, and its blocks of every cache tensor."""
    want = world["jax"][arch]["forward"][step]
    for r in world["ranks"]:
        got = r[(arch, shape)]["forward"]
        lo, hi = got["rows"]
        assert (lo, hi) == ((0, 4) if shape == "1x4" else
                            ((0, 2) if r["rank"] < 2 else (2, 4)))
        np.testing.assert_allclose(got[step]["logits"],
                                   want["logits"][lo:hi], **TOL)
        blocks = _rank_blocks(want["caches"], shape, r["rank"])
        for part, c in blocks.items():
            for name, t in cache_tensors(c):
                g = got[step]["caches"][part][name]
                assert g.shape == t.shape, (part, name)
                if name in EXACT:
                    np.testing.assert_array_equal(g, t.numpy())
                else:
                    np.testing.assert_allclose(g, t.numpy(), **TOL,
                                               err_msg=f"{part}/{name}")


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_dead_row_state_is_bitwise_unchanged(world, arch, shape):
    dead = 0
    for r in world["ranks"]:
        got = r[(arch, shape)]["forward"]
        assert got["frozen"], r["rank"]
        dead += got["dead"]
    # row 1 is on every rank of (1, 4), on data rank 0's two of (2, 2)
    assert dead == (N if shape == "1x4" else 2)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_shard_decode_state_is_the_ranks_allocation(world, arch, shape):
    """``shard_decode_state`` of a whole decode state keeps the blocks
    ``init_decode_state`` allocates on the rank: its rows, its conv
    channels and state channels or heads, its shared-site slots."""
    for r in world["ranks"]:
        laid, alloc = r[(arch, shape)]["layout"]
        assert laid == alloc, r["rank"]
        rows = 4 // worker.SHAPES[shape]["data"]
        model = worker.SHAPES[shape]["model"]
        got = {name: (sh, shards) for name, sh, shards in laid}
        cfg = world["cases"][arch][0]
        conv = cfg.d_inner + (2 * cfg.ssm_state if cfg.ssm_version == 2
                              else 0)
        assert got["layers/conv_state"][0] == (
            cfg.num_layers, rows, conv // model, cfg.ssm_conv - 1)
        if "shared/k" in got:
            assert got["shared/k"][1] == model


@pytest.mark.parametrize("ranks", [4, 16])
def test_ssm_cache_blocks_on_a_degraded_split(ranks):
    """Reduced zamba2 on (1, n): the conv state's 544 channels split; its
    8 heads split over 4 ranks but not 16 (whole on every rank there).
    ``shard_tree`` keeps block r of each split field and the blocks tile
    the whole; ``init_ssm_cache`` allocates the same shapes."""
    cfg = get_config("zamba2_1p2b").reduced()
    g = torch.Generator().manual_seed(0)
    whole = init_ssm_cache(cfg, 2, layers=cfg.num_layers)
    for f in ("conv_state", "ssm_state"):
        getattr(whole, f).copy_(torch.randn(getattr(whole, f).shape,
                                            generator=g))
    whole.length.fill_(7)
    shape = {"data": 1, "model": ranks}
    specs = tpart.cache_shardings(whole, Mesh(shape))
    parts = [tpart.shard_tree(whole, specs, Mesh(shape, r))
             for r in range(ranks)]
    alloc = init_ssm_cache(cfg, 2, layers=cfg.num_layers,
                           mesh=Mesh(shape, 1))
    heads = cfg.ssm_heads // ranks if cfg.ssm_heads % ranks == 0 \
        else cfg.ssm_heads
    assert parts[1].ssm_state.shape[2] == alloc.ssm_state.shape[2] == heads
    for name, t in cache_tensors(whole):
        got = [dict(cache_tensors(p))[name] for p in parts]
        assert got[0].shape == dict(cache_tensors(alloc))[name].shape, name
        if got[0].shape == t.shape:
            assert all(torch.equal(x, t) for x in got), name
        else:
            assert torch.equal(torch.cat(got, 2), t), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_sharded_equals_shard_tree_of_the_whole_init(arch):
    """Layer-by-layer draws (``dt_bias`` a function of its uniforms) and
    the in/out projections quantized whole before a rank keeps its block:
    equal to ``shard_tree`` of ``init_params`` and ``quantize_model``."""
    cfg = get_config(arch).reduced()
    whole = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    wq = tmodel.quantize_model(whole, cfg)
    for rank in (0, 3):
        mesh = Mesh({"data": 1, "model": 4}, rank)
        p, q = tmodel.init_sharded(cfg, torch.Generator().manual_seed(3),
                                   mesh, device="cpu")
        for got, tree in ((p, whole), (q, wq)):
            want = tpart.shard_tree(tree, tpart.param_shardings(tree, mesh),
                                    mesh)
            a, b = {}, {}
            tpart.tree_specs(got, lambda path, x: a.setdefault(path, x))
            tpart.tree_specs(want, lambda path, x: b.setdefault(path, x))
            assert a.keys() == b.keys()
            for path, x in a.items():
                y = b[path]
                if isinstance(y, tpart.Shard):
                    assert x.splits == y.splits, path
                    x, y = x.local, y.local
                assert torch.equal(x, y), path


def test_undrawn_leaf_takes_only_dt_bias_functions():
    """An ``init_sharded`` leaf not drawn yet takes the elementwise
    functions ``dt_bias`` applies to its uniforms, applied when it is
    drawn; any other torch function of it raises."""
    draw = tmodel._LazyDraw(torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    u = draw.uniform((3,), 0.0, 1.0)
    assert torch.log(torch.expm1(torch.exp(u))) is u
    want = torch.log(torch.expm1(torch.exp(
        torch.rand((3,), generator=torch.Generator().manual_seed(0)))))
    assert torch.equal(u.sample((3,)), want)
    for bad in (lambda: torch.tanh(u), lambda: torch.reshape(u, (3, 1)),
                lambda: torch.exp(u, out=torch.empty(3))):
        with pytest.raises(TypeError):
            bad()
