"""Serving launcher of the port (torch twin of ``repro/launch/serve.py``):
DyMoE-orchestrated generation with edge-latency accounting, through the
step-driven engine API, on the GPU unless ``--device cpu`` is given.

One-shot (single request, greedy or sampled):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --vram-gb 16 --mode 4/2 --prompt-len 64 --max-new 32 \\
      --temperature 0.8 --top-k 40 --seed 7

Open serving loop (``--requests N``): requests are SUBMITTED while the
engine is being stepped — half up front, the rest mid-run after a few
chunk boundaries — and the last request's tokens are streamed as
TokenChunk events.

``--mode off`` serves at full precision (the paper's no-DyMoE baseline:
policy disabled, no packed store). ``--max-queue`` bounds the admission
queue (typed ``QueueFull`` backpressure, retried while the loop keeps
stepping), ``--deadline-s`` gives every request a wall-clock deadline,
``--policy edf`` / ``--priority N`` turn on the SLO policy layer (see
the reference launcher). Ctrl-C drains gracefully.

Multi-replica tier (``--replicas N``): the same open loop routed through
a ``ClusterRouter`` — N sessions over ONE shared engine, least-loaded
placement, one driver thread per replica (their device work serializes
on the engine's lock) — reporting per-replica health plus the merged
counters:

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
      --replicas 2 --device cpu

Expert parallelism (``--expert-parallel``): the model is served sharded
over a (1, n) mesh of ranks — routed expert stores split over E, the
other weights split as ``sharding/partition.py`` rules, KV slots and SSM
states over the model axis — every rank running the same program (SPMD
over ``torch.distributed``); a config without experts (dense, Mamba,
the hybrid) is tensor-parallel, as in the reference. Under ``torchrun``
it uses the world torchrun gives it; otherwise it spawns 4 ranks on
``--device`` (the reference's "best-effort 4 simulated host devices"):
gloo on the CPU or on one shared card, NCCL when each rank has a card of
its own. Each rank draws only its
own shards (``models.model.init_sharded``); rank 0 prints the report,
with ``expert_parallel: true`` and ``n_devices`` the world size. A
replica tier over a mesh runs its replicas on the calling thread.

  PYTHONPATH=src python -m repro_torch.launch.serve --expert-parallel \
      --requests 4 --device cpu [--arch zamba2-1.2b]

Weights are random, drawn from a ``torch.Generator`` seeded with 0 (the
reference draws its own with ``jax.random.PRNGKey(0)``; the two cannot
agree, so parity tests carry JAX-made weights across with
``repro_torch.params.from_reference``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_world, make_sim_mesh, spawn
from repro_torch.models.config import DyMoEPolicy
from repro_torch.models.model import init_params, init_sharded
from repro_torch.serving import ClusterRouter, DyMoEEngine, EngineConfig, \
    Request, SamplingParams, submit_with_retry
from repro_torch.serving.cost_model import EdgeProfile

__all__ = ["parse_args", "build_engine", "run", "main"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--vram-gb", type=int, default=16)
    ap.add_argument("--mode", choices=["4/2", "4/0", "off"], default="4/2")
    ap.add_argument("--retention", type=float, default=0.75)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampled decoding (0 = off)")
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request PRNG seed; required for "
                         "temperature > 0 (else greedy fallback)")
    ap.add_argument("--requests", type=int, default=1,
                    help="> 1: open serving-loop demo with staggered "
                         "submissions and streamed tokens")
    ap.add_argument("--num-slots", type=int, default=2,
                    help="device slots for the open serving loop")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: submits past it get "
                         "typed QueueFull backpressure (retried here while "
                         "the loop keeps stepping)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline: queued past it "
                         "-> shed (DeadlineExceeded); in flight past it "
                         "-> evicted with a partial result")
    ap.add_argument("--policy", choices=["fifo", "edf"], default="fifo",
                    help="scheduling policy: fifo (default) or edf "
                         "(priority + earliest-deadline admission, "
                         "shedding, chunk-boundary preemption, pressure "
                         "degradation)")
    ap.add_argument("--priority", type=int, default=0,
                    help="priority tier for the MID-RUN burst half of the "
                         "open loop (ignored under fifo)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1: route the open loop through a ClusterRouter "
                         "— N sessions over one shared engine, least-"
                         "loaded placement, one driver thread per replica")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="load the model sharded over a (1, n) mesh of "
                         "ranks: routed expert stores split over E, KV "
                         "slots over the model axis (under torchrun its "
                         "world; else 4 ranks spawned on --device)")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--no-prefetch", action="store_true")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace, mesh=None) -> DyMoEEngine:
    """The launcher's engine: the config (reduced unless ``--full``) under
    the ``--mode`` policy, random weights from a generator seeded with 0,
    on ``--device``; with ``mesh``, this rank's expert-parallel shards of
    the same weights."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dymoe=DyMoEPolicy(
        enabled=args.mode != "off",
        low_bits=0 if args.mode == "4/0" else 2,
        retention=args.retention))
    gen = torch.Generator(device=device).manual_seed(0)
    ecfg = EngineConfig(
        profile=EdgeProfile().with_vram(args.vram_gb),
        use_dymoe=args.mode != "off",
        enable_cache=not args.no_cache,
        enable_prefetch=not args.no_prefetch,
        enable_dyquant=args.mode != "off")
    if mesh is None:
        return DyMoEEngine(cfg, init_params(cfg, gen, device), ecfg,
                           device=device)
    params, qparams = init_sharded(cfg, gen, mesh, expert_parallel=True,
                                   device=device,
                                   quantize=args.mode != "off")
    return DyMoEEngine(cfg, params, ecfg, device=device, qparams=qparams,
                       mesh=mesh, expert_parallel=True)


def _request(args: argparse.Namespace, i: int, priority: int = 0) -> Request:
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed)
    # per-request sampling stream: the seed offset keeps streams distinct
    sp = (sampling if sampling.seed is None else
          dataclasses.replace(sampling, seed=sampling.seed + i))
    return Request(prompt_tokens=list(range(1 + i, args.prompt_len + 1 + i)),
                   max_new_tokens=args.max_new, sampling=sp,
                   request_id=f"req-{i}", priority=priority,
                   deadline_s=args.deadline_s)


def run(args: argparse.Namespace, engine: DyMoEEngine
        ) -> Tuple[dict, List, Optional[object]]:
    """Serve as the reference launcher does and return (its JSON report,
    the request handles — or, one-shot, the ``GenerationResult`` — for a
    caller that checks full token lists, and the closed session: the
    ``ClusterRouter`` whose replicas keep what their driver threads
    caught in ``last_error``, the engine's session, or None one-shot).
    Over a mesh only rank 0 prints."""
    cfg = engine.cfg
    mesh = engine.mesh
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    if args.requests <= 1:
        res = engine.generate(_request(args, 0))
        return dict(
            arch=cfg.name, mode=args.mode, vram_gb=args.vram_gb,
            temperature=args.temperature, top_k=args.top_k, seed=args.seed,
            ttft_ms=res.ttft_s * 1e3, tpot_ms=res.tpot_s * 1e3,
            wall_s=res.wall_s, tokens=res.tokens[:16],
            cache=res.cache_stats), [res], None

    # ---- open serving loop: staggered submissions + streamed tokens
    slots_len = args.prompt_len + args.max_new + args.requests
    # driver threads, one a replica — but not over a mesh of several
    # ranks, whose replicas step in one order on the calling thread
    threaded = args.replicas > 1 and not engine.eager
    if args.replicas > 1:
        session = ClusterRouter.replicate(
            engine, args.replicas, num_slots=args.num_slots,
            slots_len=slots_len, max_queue=args.max_queue,
            policy=args.policy, threaded=threaded)
    else:
        session = engine.serve(num_slots=args.num_slots,
                               slots_len=slots_len,
                               max_queue=args.max_queue,
                               policy=args.policy)
    handles = []
    try:
        n_first = max(1, args.requests // 2)
        for i in range(n_first):
            handles.append(submit_with_retry(session, _request(args, i),
                                             drive=True))
        for _ in range(2):       # the engine is already decoding...
            if threaded:
                time.sleep(0.02)   # ...on the per-replica driver threads
            else:
                session.step()
        # ...the burst arrives — under --policy edf with --priority > 0
        # it admits first and may preempt the busy bulk slots
        for i in range(n_first, args.requests):
            handles.append(submit_with_retry(
                session, _request(args, i, priority=args.priority),
                drive=True))
        say(f"# streaming {handles[-1].request_id} "
            f"(submitted mid-run, admitted into a freed slot):")
        for ev in handles[-1].stream():
            say(f"  {ev.phase:8s} +{len(ev.tokens):2d} tok "
                  f"modeled {ev.modeled_s * 1e3:8.3f} ms  {ev.tokens}")
        session.drain(cancel_queued=False)   # resolve every handle
    except KeyboardInterrupt:
        # graceful Ctrl-C: finish what's in flight, cancel what's still
        # queued, then report — a second Ctrl-C interrupts the drain too
        say("\n# Ctrl-C: draining in-flight requests "
            "(Ctrl-C again to abort the drain)...")
        session.drain()
    finally:
        health = session.health()
        session.close()   # any still-unresolved handle -> SessionClosed

    def row(h):
        placed = getattr(h, "replica", None)   # ClusterHandle only
        if h.error is not None:
            return dict(id=h.request_id, replica=placed,
                        error=type(h.error).__name__)
        r = h.result()   # already resolved by the drain above
        return dict(id=h.request_id, replica=placed,
                    priority=h.request.priority,
                    ttft_ms=r.ttft_s * 1e3,
                    tpot_ms=r.tpot_s * 1e3,
                    queue_wait_ms=(r.queue_wait_s or 0) * 1e3,
                    cancelled=r.cancelled,
                    deadline_expired=r.deadline_expired,
                    preempted=r.preempted,
                    tokens=r.tokens[:8])

    if mesh is not None:
        n_devices = mesh.size      # the ranks the model is sharded over
    else:
        n_devices = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
    return dict(
        arch=cfg.name, mode=args.mode, vram_gb=args.vram_gb,
        num_slots=args.num_slots, max_queue=args.max_queue,
        deadline_s=args.deadline_s, policy=args.policy,
        priority=args.priority, replicas=args.replicas,
        expert_parallel=args.expert_parallel,
        n_devices=n_devices,
        health=dataclasses.asdict(health),
        requests=[row(h) for h in handles]), handles, session


def _rank_main(rank: int, device: torch.device, argv: List[str]) -> dict:
    """One spawned rank of ``--expert-parallel``: the launcher on this
    rank's device."""
    return main(list(argv) + ["--device", str(device)])


def _join_torchrun(device: Optional[str]) -> torch.device:
    """Join the world torchrun describes in the environment; returns this
    rank's device (``launch.mesh.init_world``'s choice of backend)."""
    return init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                      "env://", device or "cuda")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, serve, print the JSON report and return it (over a
    mesh: rank 0 prints; every rank returns its report)."""
    argv = list(argv) if argv is not None else None
    args = parse_args(argv)
    mesh = None
    if args.expert_parallel:
        if not dist.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                # no world: spawn the reference's 4 simulated devices
                import sys
                argv = sys.argv[1:] if argv is None else argv
                return spawn(_rank_main, 4, argv,
                             device=args.device or "cuda")[0]
            args.device = str(_join_torchrun(args.device))
        mesh = make_sim_mesh(dist.get_world_size())
    report, _, _ = run(args, build_engine(args, mesh))
    if mesh is None or mesh.rank == 0:
        print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
