#!/usr/bin/env python3
"""Serve-wall A/B of source trees of the port on one CUDA GPU.

    python3 tools/serve_ab.py LABEL=TREE [LABEL=TREE ...] [--rounds N]

Each TREE is a checkout of the repository (for instance the parent commit
unpacked with ``git archive`` into a git-ignored directory). One worker
process per tree builds that tree's kernels, loads full-width
OLMoE-1B-7B ("4/2", random weights from the seed of ``chip_smoke.py``'s
serve phase, quantized on the card), serves the serve phase's 8 ragged
requests on 4 slots once to warm up, and then serves them again whenever
the main process asks. The workers stay loaded side by side, so the
main process can run the trees in turns: round r runs them in the r-th
of their orderings (every ordering once per len(TREE)! rounds), which
spreads the run-to-run drift of a host-bound wall evenly over the trees.

Each run prints one ``run:`` JSON line (label, round, wall, the session's
replay host seconds where the tree has them, chunks, decode steps, a
digest of the tokens); the last line is a ``serve_ab:`` JSON summary:
per tree its walls, median, spread, replay seconds, and against the
first tree the per-round differences. ``--cpu-dry-run`` runs the same
protocol on the CPU with the reduced OLMoE config, to rehearse the tool
without a GPU.
"""
import argparse
import hashlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TAG = "@@serve_ab "      # prefix of the worker's protocol lines


def _requests(cfg):
    """The 8 ragged requests of ``chip_smoke.py``'s serve phase."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, int(rng.integers(64, 513)))],
        max_new_tokens=int(rng.integers(16, 49))) for _ in range(8)]


def _worker(tree: Path, dry_run: bool) -> int:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig

    def say(kind, **kw):
        print(TAG + json.dumps(dict(kind=kind, **kw)), flush=True)

    t0 = time.perf_counter()
    if dry_run:
        dev = torch.device("cpu")
        cfg = get_config("olmoe_1b_7b").reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    else:
        from repro_torch.kernels import _build
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        cfg = get_config("olmoe_1b_7b")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    engine = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=16),
                         device=dev)
    reqs = _requests(cfg)

    def serve():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate_batch(reqs, num_slots=4)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = engine.last_stats
        digest = hashlib.sha1(json.dumps(
            [r.tokens for r in out]).encode()).hexdigest()[:12]
        return dict(wall_s=wall, replay_s=st.get("replay_s"),
                    chunks=st["chunks"], decode_steps=st["decode_steps"],
                    tokens=sum(len(r.tokens) for r in out), digest=digest)

    warm = serve()
    say("ready", load_s=time.perf_counter() - t0, warm=warm)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "run":
            say("run", **serve())
        elif cmd == "quit":
            break
    return 0


def _read(proc, label):
    """The worker's next protocol line; its other output goes to stderr."""
    for line in proc.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
        sys.stderr.write(f"[{label}] {line}")
    raise RuntimeError(f"worker {label} exited (code {proc.wait()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="LABEL=TREE")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--cpu-dry-run", action="store_true")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return _worker(Path(args.worker).resolve(), args.cpu_dry_run)
    trees = dict(t.split("=", 1) for t in args.trees)
    if len(trees) < 2 or len(trees) != len(args.trees):
        ap.error("give two or more LABEL=TREE with distinct labels")
    for label, tree in trees.items():
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            ap.error(f"{label}: {tree}/src/repro_torch is missing")
    if not args.cpu_dry_run:
        import torch
        if not torch.cuda.is_available():
            print("serve_ab: no CUDA device", file=sys.stderr)
            return 2
    extra = ["--cpu-dry-run"] if args.cpu_dry_run else []
    procs = {}
    try:
        for label, tree in trees.items():
            procs[label] = subprocess.Popen(
                [sys.executable, __file__, "--worker", tree, *extra],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for label, proc in procs.items():
            ready = _read(proc, label)
            print(f"ready: {label} {json.dumps(ready)}", flush=True)
        orders = list(itertools.permutations(trees))
        runs = {label: [] for label in trees}
        for r in range(args.rounds):
            for label in orders[r % len(orders)]:
                proc = procs[label]
                proc.stdin.write("run\n")
                proc.stdin.flush()
                res = _read(proc, label)
                runs[label].append(res)
                print("run: " + json.dumps(dict(label=label, round=r,
                                                **res)), flush=True)
        for proc in procs.values():
            proc.stdin.write("quit\n")
            proc.stdin.flush()
            proc.wait(timeout=60)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    base = next(iter(trees))
    summary = {}
    for label, rs in runs.items():
        walls = [x["wall_s"] for x in rs]
        summary[label] = dict(
            walls_s=walls, median_s=statistics.median(walls),
            min_s=min(walls), max_s=max(walls),
            replay_s=[x["replay_s"] for x in rs],
            digests=sorted({x["digest"] for x in rs}))
        if label != base:
            diff = [a["wall_s"] - b["wall_s"]
                    for a, b in zip(rs, runs[base])]
            summary[label].update(
                minus_base_s=diff, minus_base_median_s=statistics.median(diff),
                rounds_above_base=sum(d > 0 for d in diff))
    print("serve_ab: " + json.dumps(dict(base=base, rounds=args.rounds,
                                         trees=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
