"""Expert-parallel and tensor-parallel serving of the port over a (1, 4)
mesh of gloo ranks on the CPU, held to the unsharded port engine and to
the JAX package's unsharded engine: the JAX package's
``tests/test_cluster.py`` config (reduced f32 Qwen1.5-MoE-A2.7B, 4 experts,
1 shared) and its requests.

ONE spawn of 4 ranks runs every case (``tests/_torch_ep_worker.py``;
about 4 s to start the world); the JAX engine's numbers are computed once
here in the parent, from the same numpy-made weights. The world's
process-group timeout fails a hang. Cases: EP and TP tokens, Critical and
active masks and modeled TTFT/TPOT (``generate`` and a ragged
``generate_batch``) equal to both unsharded engines; prefill logits to
1e-5; each rank holds E/4 routed experts (EP) or N/4 of each expert's
rows (TP) and its block of every decode state's KV slots; two replicas
over the sharded engine give the solo tokens; an EDF session with a
deadline eviction and a deadline shed decided by rank 0's clock alone
gives the same outcomes on every rank; ``generate_reference``, full
precision and a dense model; a sliding-window ring cache; the
launcher's ``--expert-parallel`` inside the world (``n_devices`` 4, the
unsharded run's tokens); the exact gather's bits; and a deliberately
mismatched collective raising on every rank."""
import dataclasses

import jax
import numpy as np
import pytest

import _torch_ep_worker as worker
from _torch_bridge import numpy_init, port_cfg, to_numpy_tree
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeProfile as JProfile
from repro_torch.launch.mesh import spawn

N = 4
TIMEOUT_S = 60.0


def _jax_served(cfg, params):
    """The JAX engine's ``_served`` (the worker's cases, same requests)."""
    eng = JEngine(cfg, params, JEngineConfig(
        profile=JProfile().with_vram(12), decode_chunk=4))
    masks = []
    inner = eng._replay

    def rec(crit, active, pred, **kw):
        masks.append((kw["phase"], np.asarray(crit, bool).tolist(),
                      np.asarray(active, bool).tolist()))
        return inner(crit, active, pred, **kw)

    eng._replay = rec

    def jreq(i, n_prompt=20, max_new=6):
        return JRequest(prompt_tokens=list(range(1 + i, n_prompt + 1 + i)),
                        max_new_tokens=max_new, request_id=f"req-{i}")

    gen = [worker.plain(eng.generate(jreq(i))) for i in range(3)]
    batch = [worker.plain(r) for r in eng.generate_batch(
        [jreq(i, n_prompt=12 + 3 * i, max_new=4 + i) for i in range(4)],
        num_slots=2)]
    return dict(gen=gen, batch=batch, masks=masks)


@pytest.fixture(scope="module")
def world():
    cfg = jget_config("qwen2-moe-a2.7b").reduced()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    wcfg = dataclasses.replace(cfg, sliding_window=8)
    wparams = numpy_init(lambda: jinit_params(wcfg, jax.random.PRNGKey(0)),
                         seed=1)
    ranks = spawn(worker.run, N, port_cfg(cfg), to_numpy_tree(params),
                  port_cfg(wcfg), to_numpy_tree(wparams),
                  timeout_s=TIMEOUT_S)
    return dict(ranks=ranks, jax=_jax_served(cfg, params), cfg=cfg)


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_sharded_engine_equals_unsharded_and_jax(world, mode):
    """Tokens, masks and every modeled field, on every rank, equal the
    unsharded port engine's and the JAX engine's."""
    base, jx = world["ranks"][0]["base"], world["jax"]
    assert base["gen"] == jx["gen"] and base["batch"] == jx["batch"]
    assert base["masks"] == jx["masks"]
    for r in world["ranks"]:
        got = r[mode]
        assert got["gen"] == base["gen"], r["rank"]
        assert got["batch"] == base["batch"], r["rank"]
        assert got["masks"] == base["masks"], r["rank"]
        # eager over the mesh: no compile, the mesh's shape reported
        assert got["stats"]["compiles"] == 0
        assert got["stats"]["prefill_compiles"] == 0
        assert got["stats"]["mesh"] == {"data": 1, "model": N}
    err = world["ranks"][0][mode]["logits_err"]
    assert err <= 1e-5, err
    logits = [r[mode]["logits"] for r in world["ranks"]]
    assert all(np.array_equal(x, logits[0]) for x in logits)


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_each_rank_holds_only_its_shards(world, mode):
    cfg = world["cfg"]
    e, dff = cfg.num_experts, cfg.moe_d_ff
    for r in world["ranks"]:
        kind, dim, shape = r[mode]["routed"]
        assert kind == "Shard"
        if mode == "ep":   # (L, E/4, N, K/vpb): E/4 experts a rank
            assert (dim, shape[1]) == (1, e // N)
        else:              # (L, E, N/4, K/vpb): every expert, N/4 rows
            assert (dim, shape[1], shape[2]) == (2, e, dff // N)
        slots, k_shape, shards = r[mode]["kv"]
        assert shards == N and k_shape[-2] == slots // N
        assert r["laid"] == ((cfg.num_layers, 2, cfg.num_kv_heads,
                              64 // N, cfg.head_dim), N, r["rank"])


def test_two_replicas_over_the_sharded_engine(world):
    base = world["ranks"][0]["base"]["gen"]
    for r in world["ranks"]:
        c = r["cluster"]
        assert c["routed"] == c["solo"]
        assert c["solo"][:3] == [g["tokens"] for g in base]
        assert c["replicas"] == [0, 1]
        assert r["threaded_refused"] is True


def test_edf_deadline_outcomes_agree_on_every_rank(world):
    """Only rank 0 slept past the deadlines: every rank evicted the long
    request mid-flight and shed the queued one all the same."""
    outs = [r["edf"] for r in world["ranks"]]
    assert all(o == outs[0] for o in outs)
    long, late, short = outs[0]
    assert long[0] == "long" and long[2] and long[3]     # evicted
    assert 1 <= len(long[1]) < 40
    assert late == ("late", "DeadlineExceeded")          # shed, queued
    assert short[0] == "short" and len(short[1]) == 6 and not short[3]


def test_reference_full_precision_and_dense_paths(world):
    """``generate_reference`` (K2 on each rank's experts), full precision
    (float experts split over E, or Megatron over d_ff) and a dense model
    (qwen3_0p6b reduced: Megatron FFN, K2 at E = 1 on N/4 rows) give the
    unsharded engine's tokens on every rank."""
    r0 = world["ranks"][0]
    for r in world["ranks"]:
        assert r["reference"] == r0["reference_base"]
        assert r["fullprec"] == [r0["fullprec_base"]] * 2
        assert r["dense"] == r0["dense_base"]
    assert r0["reference_base"] == r0["base"]["gen"][0]["tokens"]


def test_ring_cache_request(world):
    r0 = world["ranks"][0]
    assert all(r["ring"] == r0["ring_base"] for r in world["ranks"])
    assert all(len(t) == 6 for t in r0["ring_base"])


def test_launcher_expert_parallel_in_the_world(world):
    r0 = world["ranks"][0]
    for r in world["ranks"]:
        assert r["launch"]["n_devices"] == N
        assert r["launch"]["expert_parallel"] is True
        assert r["launch"]["tokens"] == r0["launch_base"]


def test_gather_is_bit_exact(world):
    """``Mesh.all_gather`` sums over the buffer's bytes as integers: -0.0
    stays negative and NaNs stay NaN, whatever the dtype and byte count."""
    for r in world["ranks"]:
        assert r["gather_bits"] == [((2 * N, 3), True, True),
                                    ((N, 5), True, True),
                                    ((N, 1), True, True)]


def test_mismatched_collective_raises_on_every_rank(world):
    for r in world["ranks"]:
        assert r["mismatch"] is not None, r["rank"]
        seconds, msg = r["mismatch"]
        assert seconds < TIMEOUT_S and "diverged" in msg
    assert all(r["collectives"] > 0 for r in world["ranks"])
