"""Serving and the forward functions of the port on meshes with a data
axis, over 4 gloo ranks on the CPU, held to the JAX package's unsharded
engine and forward functions: the JAX package's ``tests/test_cluster.py``
config (reduced f32 Qwen1.5-MoE-A2.7B, 4 experts, 1 shared).

ONE spawn of 4 ranks runs every case (``tests/_torch_data_worker.py``);
the JAX numbers are computed once here in the parent, from the same
numpy-made weights (the forward cases' packed store is the port's
``quantize_model`` codes on both sides, ``quantized_pair``). Cases:

  * a (2, 2) ("data", "model") mesh, expert-parallel (2 experts a rank):
    ``generate`` of three requests (one slot: replicated over data) and a
    4-slot ``generate_batch`` of six ragged requests (2 slots a data
    rank; request 1 ends at its first token, so a survivor moves across
    the block edge and is prefilled again on its new rank): every rank's
    tokens, Critical / active masks and modeled TTFT/TPOT equal the JAX
    engine's;
  * the same on ``make_local_mesh()``'s (4, 1) mesh (1 slot a rank);
  * on (2, 2), each rank's block of a 4-row batch: a ragged ``prefill``
    with one shared Critical set and ``decode_step(per_row_moe=False)``,
    with the site's tokens gathered over "data" and, against the
    reference's D 2 on the whole batch, with ``moe_dispatch_shards=2,
    moe_dispatch_axes=("data",)`` (the loads, Critical set and look-ahead
    summed over "data"); and ``moe_apply_sharded``
    at D 2 with ``moe_dispatch_axes=("data",)`` (each rank its group, the
    statistics merged over "data"): rows equal the reference's rows of
    the whole batch, masks and loads exact, f32 values within atol = rtol
    = 1e-5; axes naming no batch axis, or a D the data ranks do not
    divide, raise;
  * a mismatched collective on one data sub-group raises
    ``CollectiveMismatch`` on its two ranks only.

The reference's ``moe_dispatch_axes`` is a sharding constraint (no effect
on the numbers), so its D 2 call runs with the axes cleared, outside a
mesh."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_data_worker as worker
from _torch_bridge import jit_run, numpy_init, port_cfg, quantized_pair, \
    to_numpy_tree
from _torch_ep_worker import plain
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.layers import moe as jmoe
from repro.models.model import decode_step as jdecode_step
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.cost_model import EdgeProfile as JProfile
from repro_torch.launch.mesh import spawn

N = 4
TIMEOUT_S = 60.0
TOL = dict(atol=1e-5, rtol=1e-5)
EXACT = ("critical_masks", "active_masks", "expert_load", "expert_hh_load")


def _jreq(r):
    return JRequest(prompt_tokens=list(r.prompt_tokens),
                    max_new_tokens=r.max_new_tokens,
                    request_id=r.request_id)


def _jax_served(cfg, params):
    """The JAX engine's ``worker.served`` (same requests)."""
    eng = JEngine(cfg, params, JEngineConfig(
        profile=JProfile().with_vram(12), decode_chunk=4))
    masks = []
    inner = eng._replay

    def rec(crit, active, pred, **kw):
        masks.append((kw["phase"], np.asarray(crit, bool).tolist(),
                      np.asarray(active, bool).tolist()))
        return inner(crit, active, pred, **kw)

    eng._replay = rec
    gen = [plain(eng.generate(_jreq(worker.req(i)))) for i in range(3)]
    batch = [plain(r) for r in eng.generate_batch(
        [_jreq(r) for r in worker.session_requests()], num_slots=4)]
    return dict(gen=gen, batch=batch, masks=masks)


def _jax_forward(cfg, params):
    """The forward cases' inputs and the reference's whole-batch
    numbers."""
    jq, _ = quantized_pair(params, cfg)
    rng = np.random.default_rng(5)
    lens = np.array([14, 9, 14, 6], np.int32)
    prompt = np.zeros((4, 14), np.int64)
    for i, ln in enumerate(lens):   # right-aligned
        prompt[i, 14 - ln:] = rng.integers(1, cfg.vocab_size, ln)
    slots = 20
    logits, caches, info = jit_run(lambda: jprefill(
        params, cfg, jnp.asarray(prompt), qparams=jq, cache_slots=slots,
        lengths=jnp.asarray(lens)))
    tok0 = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    dlogits, _, dinfo = jit_run(lambda: jdecode_step(
        params, cfg, jnp.asarray(tok0), caches, qparams=jq,
        per_row_moe=False))
    # D 2 on the whole batch: the local-dispatch cases' reference, on
    # rows whose two data blocks would each pick another layer-1 Critical
    # set than the whole batch's: a rank that did not sum its loads over
    # "data" shows
    lprompt = np.zeros_like(prompt)
    lrng = np.random.default_rng(22)
    for i, ln in enumerate(lens):
        lprompt[i, 14 - ln:] = lrng.integers(1, cfg.vocab_size, ln)
    dcfg = dataclasses.replace(cfg, moe_dispatch_shards=2)
    llogits, lcaches, linfo = jit_run(lambda: jprefill(
        params, dcfg, jnp.asarray(lprompt), qparams=jq, cache_slots=slots,
        lengths=jnp.asarray(lens)))
    ldlogits, _, ldinfo = jit_run(lambda: jdecode_step(
        params, dcfg, jnp.asarray(tok0), lcaches, qparams=jq,
        per_row_moe=False))

    t = 32
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    hh = (rng.random(t) < 0.3).astype(np.float32)
    tv = rng.random(t) < 0.85
    crit = np.zeros(cfg.num_experts, bool)
    crit[::2] = True
    layer = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    qlayer = jax.tree.map(lambda a: a[0], jq["layers"]["moe"])
    y, st = jit_run(lambda: jmoe.moe_apply_sharded(
        layer, dcfg, jnp.asarray(x), hh_mask=jnp.asarray(hh),
        critical_mask=jnp.asarray(crit), qweights=qlayer,
        token_valid=jnp.asarray(tv)))
    fx = dict(prompt=prompt, prompt_local=lprompt, lens=lens, cache_slots=slots, tok0=tok0, x=x,
              hh=hh, tv=tv, crit=crit)
    want = dict(prefill=dict(logits=np.asarray(logits), **_fields(info)),
                decode=dict(logits=np.asarray(dlogits), **_fields(dinfo)),
                prefill_local=dict(logits=np.asarray(llogits),
                                   **_fields(linfo)),
                decode_local=dict(logits=np.asarray(ldlogits),
                                  **_fields(ldinfo)),
                moe=dict(y=np.asarray(y), **{
                    f: np.asarray(getattr(st, f)) for f in (
                        "router_logits", "expert_load", "expert_hh_load",
                        "gate_mean", "aux_loss", "dropped_frac")}))
    return fx, want


def _fields(info):
    return {f: np.asarray(getattr(info, f)) for f in (
        "critical_masks", "active_masks", "expert_load", "expert_hh_load",
        "gate_mean", "predicted_next", "token_importance", "aux_loss",
        "dropped_frac") if getattr(info, f, None) is not None}


@pytest.fixture(scope="module")
def world():
    cfg = jget_config("qwen2-moe-a2.7b").reduced()
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    fx, want = _jax_forward(cfg, params)
    ranks = spawn(worker.run, N, port_cfg(cfg), to_numpy_tree(params), fx,
                  timeout_s=TIMEOUT_S)
    return dict(ranks=ranks, jax=_jax_served(cfg, params), want=want,
                cfg=cfg)


@pytest.mark.parametrize("which,shape", [
    ("ep", {"data": 2, "model": 2}), ("local", {"data": 4, "model": 1})],
    ids=["2x2_ep", "4x1_local"])
def test_engine_equals_the_unsharded_jax_engine(world, which, shape):
    """Tokens, masks and every modeled field, on every rank."""
    jx = world["jax"]
    for r in world["ranks"]:
        got = r[which]
        assert got["gen"] == jx["gen"], r["rank"]
        assert got["batch"] == jx["batch"], r["rank"]
        assert got["masks"] == jx["masks"], r["rank"]
        # eager over the mesh: no compile, the mesh's shape reported
        assert got["stats"]["compiles"] == 0
        assert got["stats"]["mesh"] == shape
    assert world["ranks"][0]["local_shape"] == {"data": 4, "model": 1}


def test_slots_and_experts_split_over_the_axes(world):
    """Each rank of (2, 2) holds E/2 routed experts, the 4-slot session's
    2 slots of its data block (the 1-slot ``generate`` sessions stay
    whole), and the session's gathers crossed "data"."""
    cfg = world["cfg"]
    for r in world["ranks"]:
        dim, shape = r["routed"]
        assert (dim, shape[1]) == (1, cfg.num_experts // 2)
        assert r["state_slots"] == [(1, 1), (2, 2)], r["state_slots"]
        assert r["by_axis"]["data"] > 0 and r["by_axis"]["model"] > 0
    assert [r["coords"] for r in world["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]


def _check_rows(got, want, rows, per_row=("logits", "token_importance")):
    lo, hi = rows
    for f, w in want.items():
        if f in per_row:
            w = w[lo:hi]
        if f in EXACT:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], w, **TOL, err_msg=f)


@pytest.mark.parametrize("case", ["prefill", "decode", "prefill_local",
                                  "decode_local"])
def test_shared_mask_rows_equal_the_whole_batch(world, case):
    """Ragged prefill and ``decode_step(per_row_moe=False)``: each rank's
    rows are the reference's rows of the 4-row batch — with the site's
    tokens gathered over "data", and (``_local``) at D 2 with the groups
    pinned to "data" against the reference's D 2 on the whole batch:
    logits, Critical / active masks and loads, and the look-ahead."""
    for r in world["ranks"]:
        fw = r["forward"]
        assert fw["rows"] == ((0, 2) if r["rank"] < 2 else (2, 4))
        _check_rows(fw[case], world["want"][case], fw["rows"])


def test_moe_apply_sharded_pinned_to_data(world):
    """D 2 over 2 data ranks: each rank dispatches its group; its rows
    and the merged statistics equal the reference's on all tokens."""
    for r in world["ranks"]:
        got = r["forward"]["moe"]
        _check_rows(got, world["want"]["moe"], got["rows"],
                    per_row=("y", "router_logits"))
        assert r["forward"]["refused"][0] and "batch axes" in \
            r["forward"]["refused"][0]
        assert r["forward"]["refused"][1] and "not a multiple" in \
            r["forward"]["refused"][1]


def test_mismatched_collective_raises_on_its_data_group(world):
    got = {r["rank"]: r["mismatch"] for r in world["ranks"]}
    assert got[1] is None and got[3] is None
    for rank in (0, 2):
        secs, msg = got[rank]
        assert "host decisions diverged" in msg
        assert secs < TIMEOUT_S
