"""The rank program of ``tests/test_torch_expert_parallel.py``: every case
of the expert-parallel file, run by each of 4 gloo ranks on the CPU in one
world. It imports the port only (no JAX: the ranks are spawned
processes); the parent compares what each rank returns."""
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.launch.mesh import CollectiveMismatch, make_sim_mesh
from repro_torch.models import model as tmodel
from repro_torch.params import from_reference
from repro_torch.serving import ClusterRouter, DyMoEEngine, EdgeProfile, \
    EngineConfig, Request


def req(i, n_prompt=20, max_new=6, **kw):
    """The JAX package's ``tests/test_cluster.py`` request."""
    kw.setdefault("request_id", f"req-{i}")
    return Request(prompt_tokens=list(range(1 + i, n_prompt + 1 + i)),
                   max_new_tokens=max_new, **kw)


def ecfg():
    return EngineConfig(profile=EdgeProfile().with_vram(12), decode_chunk=4)


def _num(x):
    return "nan" if isinstance(x, float) and math.isnan(x) else x


def plain(r):
    """A GenerationResult as plain values (``dataclasses.asdict`` of its
    timings: the two packages' StepTiming classes differ)."""
    asd = dataclasses.asdict
    return dict(tokens=r.tokens, ttft_s=_num(r.ttft_s), tpot_s=_num(r.tpot_s),
                cancelled=r.cancelled, deadline_expired=r.deadline_expired,
                cache_stats=r.cache_stats,
                prefill_weight_bytes=r.prefill_weight_bytes,
                decode_weight_bytes_per_tok=r.decode_weight_bytes_per_tok,
                prefill_timing=(asd(r.prefill_timing) if r.prefill_timing
                                else None),
                decode_timings=([asd(t) for t in r.decode_timings]
                                if r.decode_timings else None))


def recording(engine, log):
    """Log each replay's (phase, Critical mask, active mask)."""
    inner = engine._replay

    def rec(crit, active, pred, **kw):
        log.append((kw["phase"], np.asarray(crit, bool).tolist(),
                    np.asarray(active, bool).tolist()))
        return inner(crit, active, pred, **kw)

    engine._replay = rec


def _served(engine, n_gen=3):
    """generate() of three requests (with the replays' masks) and a
    ragged generate_batch over 2 slots."""
    masks = []
    inner = engine._replay
    recording(engine, masks)
    gen = [plain(engine.generate(req(i))) for i in range(n_gen)]
    batch = [plain(r) for r in engine.generate_batch(
        [req(i, n_prompt=12 + 3 * i, max_new=4 + i) for i in range(4)],
        num_slots=2)]
    engine._replay = inner
    return dict(gen=gen, batch=batch, masks=masks)


def _edf_session(engine, rank):
    """An EDF session over one slot with one in-flight deadline eviction
    and one queued deadline shed: only rank 0 sleeps past the deadlines,
    so the ranks agree only if they take rank 0's clock."""
    session = engine.serve(num_slots=1, policy="edf", slots_len=64)
    hs = [session.submit(req(0, max_new=40, deadline_s=0.8,
                             request_id="long")),
          session.submit(req(2, max_new=6, deadline_s=0.8,
                             request_id="late")),
          session.submit(req(1, max_new=6, request_id="short"))]
    for _ in range(2):
        session.step()
    if rank == 0:
        time.sleep(1.0)
    session.drain(cancel_queued=False)
    out = []
    for h in hs:
        if h.error is not None:
            out.append((h.request_id, type(h.error).__name__))
        else:
            r = h.result(drive=False)
            out.append((h.request_id, r.tokens, r.cancelled,
                        r.deadline_expired))
    session.close()
    return out


def run(rank, device, cfg, np_params, win_cfg, win_np_params):
    torch.set_num_threads(1)
    mesh = make_sim_mesh(4)
    params = from_reference(np_params, "cpu")
    out = {"rank": rank}
    base = DyMoEEngine(cfg, params, ecfg(), device="cpu") if rank == 0 \
        else None
    if base is not None:
        out["base"] = _served(base)
    prompt = torch.tensor([req(0).prompt_tokens], dtype=torch.int64)
    for ep in (True, False):
        key = "ep" if ep else "tp"
        eng = DyMoEEngine(cfg, params, ecfg(), device="cpu", mesh=mesh,
                          expert_parallel=ep)
        got = _served(eng)
        packed = eng.qparams["layers"]["moe"]["w_gate"].high.packed
        got["routed"] = (type(packed).__name__, packed.dim,
                         tuple(packed.local.shape))
        st = eng._decode_batched.states()[0]
        got["kv"] = (st.slots_len, tuple(st.caches["layers"].k.shape),
                     st.caches["layers"].shards)
        got["stats"] = dict(eng.last_stats)
        logits, _, _ = tmodel.prefill(eng.params, cfg, prompt,
                                      qparams=eng.qparams, mesh=mesh)
        got["logits"] = logits.numpy()
        if base is not None:
            want, _, _ = tmodel.prefill(base.params, cfg, prompt,
                                        qparams=base.qparams)
            got["logits_err"] = float((logits - want).abs().max())
        out[key] = got
        if ep:
            sharded = eng
    # the shard_decode_state of a whole decode state == the state's block
    whole = tmodel.init_decode_state(cfg, 2, 64, device="cpu")
    laid = sharded.shard_decode_state(whole)
    out["laid"] = (tuple(laid["layers"].k.shape), laid["layers"].shards,
                   laid["layers"].shard)

    # two replicas over the sharded engine: the solo tokens
    solo = [sharded.generate(req(i)).tokens for i in range(6)]
    with ClusterRouter.replicate(sharded, 2, num_slots=2,
                                 slots_len=64) as router:
        handles = [router.submit(req(i)) for i in range(6)]
        out["cluster"] = dict(solo=solo,
                              routed=[h.result().tokens for h in handles],
                              replicas=sorted({h.replica for h in handles}))
    try:
        ClusterRouter.replicate(sharded, 2, threaded=True)
    except ValueError as e:
        out["threaded_refused"] = "threaded=False" in str(e)

    out["edf"] = _edf_session(sharded, rank)

    # a ring cache: the window's 8 slots split 2 a rank
    wparams = from_reference(win_np_params, "cpu")
    wreqs = [req(0, n_prompt=20), req(1, n_prompt=8)]
    weng = DyMoEEngine(win_cfg, wparams, ecfg(), device="cpu", mesh=mesh,
                       expert_parallel=True)
    out["ring"] = [weng.generate(r).tokens for r in wreqs]
    if rank == 0:
        wbase = DyMoEEngine(win_cfg, wparams, ecfg(), device="cpu")
        out["ring_base"] = [wbase.generate(r).tokens for r in wreqs]

    # generate_reference (decode_many, K2 on each rank's experts), full
    # precision (the float experts split over E or d_ff) and a dense
    # model (Megatron FFN, K2 at E = 1 on N/4 rows)
    out["reference"] = sharded.generate_reference(req(0)).tokens
    fp = EngineConfig(profile=EdgeProfile().with_vram(12), decode_chunk=4,
                      use_dymoe=False)
    out["fullprec"] = [DyMoEEngine(cfg, params, fp, device="cpu", mesh=mesh,
                                   expert_parallel=ep).generate(req(1)).tokens
                       for ep in (True, False)]
    from repro_torch.configs import get_config
    dcfg = get_config("qwen3_0p6b").reduced()
    dparams = tmodel.init_params(dcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    out["dense"] = DyMoEEngine(dcfg, dparams, ecfg(), device="cpu",
                               mesh=mesh).generate(req(2)).tokens
    if rank == 0:
        out["reference_base"] = base.generate_reference(req(0)).tokens
        out["fullprec_base"] = DyMoEEngine(
            cfg, params, fp, device="cpu").generate(req(1)).tokens
        out["dense_base"] = DyMoEEngine(dcfg, dparams, ecfg(),
                                        device="cpu").generate(req(2)).tokens

    # the launcher, inside this world
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--prompt-len", "8", "--max-new", "4",
            "--requests", "3", "--num-slots", "2"]
    rep = serve.main(argv + ["--expert-parallel"])
    out["launch"] = dict(n_devices=rep["n_devices"],
                         expert_parallel=rep["expert_parallel"],
                         tokens=[r["tokens"] for r in rep["requests"]])
    if rank == 0:
        plainrep = serve.main(argv)
        out["launch_base"] = [r["tokens"] for r in plainrep["requests"]]

    # the exact gather keeps every bit: -0.0 and NaN payloads, bf16 of
    # odd byte counts
    bits = []
    for dt, shape in ((torch.bfloat16, (2, 3)), (torch.float32, (1, 5)),
                      (torch.bfloat16, (1, 1))):
        t = torch.full(shape, -0.0 if rank % 2 == 0 else float("nan"),
                       dtype=dt)
        g = mesh.all_gather(t, 0)
        blocks = g.reshape(mesh.size, *shape)     # rank r's block at r
        bits.append((tuple(g.shape), bool(torch.signbit(blocks[::2]).all()),
                     bool(blocks[1::2].isnan().all())))
    out["gather_bits"] = bits

    # a deliberately mismatched collective raises on every rank
    t0 = time.perf_counter()
    try:
        if rank == 0:
            mesh.all_reduce(torch.ones(4))
        else:
            mesh.broadcast(torch.ones(8))
        out["mismatch"] = None
    except CollectiveMismatch as e:
        out["mismatch"] = (time.perf_counter() - t0, str(e))
    out["collectives"] = mesh.collectives
    return out
