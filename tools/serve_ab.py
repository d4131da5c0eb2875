#!/usr/bin/env python3
"""Serve-wall A/B of source trees of the port on one CUDA GPU.

    python3 tools/serve_ab.py LABEL=TREE [LABEL=TREE ...] [--rounds N]

Each TREE is a checkout of the repository (for instance the parent commit
unpacked with ``git archive`` into a git-ignored directory). One worker
process per tree builds that tree's kernels, loads full-width
OLMoE-1B-7B ("4/2", random weights from the seed of ``chip_smoke.py``'s
serve phase, quantized on the card), warms up once (the serve phase's 8
ragged requests on 4 slots, then the profiled request below), and then
serves whatever the main process asks. The workers stay loaded side by
side, so the main process can run the trees in turns: round r runs them
in the r-th of their orderings (every ordering once per len(TREE)!
rounds), which spreads the run-to-run drift of a host-bound wall evenly
over the trees. A round runs, for each tree in turn:

* two sessions: ``repeated`` serves the serve
  phase's 8 requests again (the warm-up met their shapes), ``varied``
  serves 8 requests drawn anew from the round's seed: prompts of 16 up to
  a length drawn from 64-1024, 16-48 new tokens, so every session's slot
  budget (largest prompt + new tokens) is one no earlier session had;
* the profiled request of ``chip_smoke.py`` (a 64-token prompt, 17 new
  tokens, alone): its decode ms per step (decode wall over 16 steps) and
  its admission ms (service wall less decode wall: the solo prefill, its
  first token and its replay).

Each session prints one ``run:`` JSON line (label, traffic, round, wall,
slot budget, the session's replay host seconds and compiled-chunk and
compiled-prefill captures where the tree has them, chunks, decode steps,
a digest of the tokens), each profiled request a ``decode:`` line; the
warm-up is in the worker's ``ready:`` line. The last line is a
``serve_ab:`` JSON summary: per tree and traffic its walls, median,
spread, replay seconds and the replay's median share of the wall; where
the tree compiles, the sessions that captured nothing (their share, and
the median wall of each kind) and the seconds the captures took; against
the first tree the per-round differences; and per tree the profiled
decode ms per step and admission ms. ``--cpu-dry-run`` runs the same
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


def _varied(cfg, rnd):
    """8 requests drawn from round ``rnd``'s seed: prompts of 16 up to a
    drawn 64-1024 tokens, 16-48 new tokens each."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(1000 + rnd)
    top = int(rng.integers(64, 1025))
    return [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, int(rng.integers(16, top + 1)))],
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
    from repro_torch.serving import Request
    engine = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=16),
                         device=dev)
    profiled = Request(prompt_tokens=list(range(1, 65)), max_new_tokens=17)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def serve(reqs):
        sync()
        t = time.perf_counter()
        out = engine.generate_batch(reqs, num_slots=4)
        sync()
        wall = time.perf_counter() - t
        st = engine.last_stats
        digest = hashlib.sha1(json.dumps(
            [r.tokens for r in out]).encode()).hexdigest()[:12]
        return dict(wall_s=wall, replay_s=st.get("replay_s"),
                    compiles=st.get("compiles"), compile_s=st.get("compile_s"),
                    prefill_compiles=st.get("prefill_compiles"),
                    prefill_compile_s=st.get("prefill_compile_s"),
                    slots_need=max(r.prompt_len + r.max_new_tokens
                                   for r in reqs),
                    chunks=st["chunks"], decode_steps=st["decode_steps"],
                    tokens=sum(len(r.tokens) for r in out), digest=digest)

    def decode():
        sync()
        res = engine.generate(profiled)
        sync()
        return dict(decode_ms_per_step=res.decode_wall_s * 1e3 / 16,
                    admission_ms=(res.wall_s - res.decode_wall_s) * 1e3,
                    compiles=engine.last_stats.get("compiles"),
                    prefill_compiles=engine.last_stats.get(
                        "prefill_compiles"))

    warm = serve(_requests(cfg))
    warm_decode = decode()
    say("ready", load_s=time.perf_counter() - t0, warm=warm,
        warm_decode=warm_decode)
    for line in sys.stdin:
        cmd, *arg = line.split()
        if cmd == "repeated":
            say("run", **serve(_requests(cfg)))
        elif cmd == "varied":
            say("run", **serve(_varied(cfg, int(arg[0]))))
        elif cmd == "decode":
            say("decode", **decode())
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
        traffic = ("repeated", "varied")
        orders = list(itertools.permutations(trees))
        runs = {(label, kind): [] for label in trees for kind in traffic}
        decodes = {label: [] for label in trees}
        admissions = {label: [] for label in trees}

        def ask(label, cmd):
            procs[label].stdin.write(cmd + "\n")
            procs[label].stdin.flush()
            return _read(procs[label], label)

        for r in range(args.rounds):
            for label in orders[r % len(orders)]:
                for kind in traffic:
                    res = ask(label, f"{kind} {r}")
                    runs[label, kind].append(res)
                    print("run: " + json.dumps(dict(
                        label=label, traffic=kind, round=r, **res)),
                        flush=True)
                res = ask(label, "decode")
                decodes[label].append(res["decode_ms_per_step"])
                admissions[label].append(res["admission_ms"])
                print("decode: " + json.dumps(dict(label=label, round=r,
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
    summary = {label: dict(decode_ms_per_step=decodes[label],
                           decode_ms_per_step_median=statistics.median(
                               decodes[label]),
                           admission_ms=admissions[label],
                           admission_ms_median=statistics.median(
                               admissions[label])) for label in trees}
    for (label, kind), rs in runs.items():
        walls = [x["wall_s"] for x in rs]
        row = summary[label][kind] = dict(
            walls_s=walls, median_s=statistics.median(walls),
            min_s=min(walls), max_s=max(walls),
            replay_s=[x["replay_s"] for x in rs],
            slots_need=[x["slots_need"] for x in rs],
            digests=sorted({x["digest"] for x in rs}))
        if all(x["replay_s"] is not None for x in rs):
            row["replay_share_median"] = statistics.median(
                x["replay_s"] / x["wall_s"] for x in rs)
        if all(x["compiles"] is not None for x in rs):
            # captures of either compiled program (a tree without a
            # compiled prefill reports None for it)
            caught = [x["compiles"] + (x["prefill_compiles"] or 0)
                      for x in rs]
            warm = [x["wall_s"] for x, c in zip(rs, caught) if c == 0]
            cold = [x["wall_s"] for x, c in zip(rs, caught) if c]
            row.update(compiles=[x["compiles"] for x in rs],
                       compile_s=[x["compile_s"] for x in rs],
                       prefill_compiles=[x["prefill_compiles"] for x in rs],
                       prefill_compile_s=[x["prefill_compile_s"]
                                          for x in rs],
                       no_capture_share=len(warm) / len(rs),
                       no_capture_median_s=statistics.median(warm)
                       if warm else None,
                       capture_median_s=statistics.median(cold)
                       if cold else None)
        if label != base:
            diff = [a["wall_s"] - b["wall_s"]
                    for a, b in zip(rs, runs[base, kind])]
            row.update(
                minus_base_s=diff, minus_base_median_s=statistics.median(diff),
                rounds_above_base=sum(d > 0 for d in diff))
    print("serve_ab: " + json.dumps(dict(base=base, rounds=args.rounds,
                                         traffic=traffic, trees=summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
