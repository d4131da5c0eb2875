#!/usr/bin/env python3
"""Where a tensor-parallel full-width zamba2 step first leaves the
one-rank numbers, on one NVIDIA GPU.

Full-width ``zamba2_1p2b`` "4/2" (38 Mamba2 layers, 7 shared attention
sites), weights from seed 0, in f32 and in bf16: one ``prefill`` of a
(4, 64) prompt and one ``decode_step`` on one rank, then on 4 gloo ranks
sharing the card over a (1, 4) and a (2, 2) ("data", "model") mesh, each
rank holding its blocks (``init_sharded``). Every tensor that is whole on
every rank is recorded in call order — each Mamba layer's in-projection,
its gate norm's input and output and its output, and each shared site's
attention, MLP and block output (the prefill's at its last token) — and
held against the one-rank run's. Prints, per mesh and dtype, the first
record that differs, the largest difference of each kind, and how many
argmax tokens of the prefill and the step agree; writes every record's
difference to ``--out`` (``build/ssm_divergence.json``).

Once one tensor differs every later one does, so the step's first Mamba
layer and first shared site are also run alone ("local"): each rank
gives its blocks of them the one-rank run's input and its blocks of the
one-rank caches, so a difference there is the block's own.

    python3 tools/ssm_divergence.py      # from the repository root
    python3 tools/ssm_divergence.py --reduced --device cpu   # a quick check
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "zamba2_1p2b"
SHAPES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}
ROWS, PROMPT, SLOTS = 4, 64, 72


def _cfg(dtype: str, reduced: bool):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    return dataclasses.replace(cfg.reduced() if reduced else cfg,
                               dtype=dtype)


def _prompt(reduced: bool):
    import numpy as np
    import torch
    cfg = _cfg("float32", reduced)
    return torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (ROWS, PROMPT)))


class _Recorder:
    """Wraps the model's and the Mamba layer's functions whose results are
    whole on every rank and keeps each result (its last token in a
    prefill) on the host, in call order."""

    def __init__(self):
        from repro_torch.models import model
        from repro_torch.models.layers import ssm
        self.records, self.phase, self._undo = [], "prefill", []
        for mod, name, pick in (
                (ssm, "_proj_in", None), (ssm, "rmsnorm", "io"),
                (model, "mamba_prefill", 0), (model, "mamba_decode", 0),
                (model, "attention_train", 0), (model, "attention_decode", 0),
                (model, "mlp", None), (model, "_shared_block_train", 0),
                (model, "_shared_block_decode", None)):
            self._wrap(mod, name, pick)

    def _keep(self, name, t):
        t = t.detach()
        if t.dim() == 3:                 # (B, T, ·): the last token
            t = t[:, -1]
        self.records.append((self.phase, name, t.float().cpu().numpy()))

    def _wrap(self, mod, name, pick):
        real = getattr(mod, name)

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            if pick == "io":
                self._keep(f"{name} in", args[1])
                self._keep(f"{name} out", out)
            else:
                self._keep(name, out if pick is None else out[pick])
            return out

        setattr(mod, name, wrapped)
        self._undo.append((mod, name, real))

    def close(self):
        for mod, name, real in self._undo:
            setattr(mod, name, real)


def _host(cache) -> dict:
    """A layer's cache tensors, cloned to the host as numpy (floats as
    f32, which holds a bf16 value exactly)."""
    from repro_torch.models.kv_cache import cache_tensors
    return {name: (t.float() if t.is_floating_point() else t)
            .detach().cpu().numpy().copy()
            for name, t in cache_tensors(cache)}


def _capture(local: dict):
    """Wrap the model's first ``mamba_decode`` and ``_shared_block_decode``
    call of a step: keep its input, its cache before the call and its
    output in ``local`` (host numpy). Returns the undo."""
    from repro_torch.models import model

    undo = []
    for name, key in (("mamba_decode", "mamba"),
                      ("_shared_block_decode", "shared")):
        real = getattr(model, name)

        def wrapped(*args, _real=real, _key=key, **kw):
            first = _key not in local
            if first:
                cap = dict(x=args[2].detach().float().cpu().numpy(),
                           cache=_host(args[3]))
            out = _real(*args, **kw)
            if first:
                y = out[0] if isinstance(out, tuple) else out
                local[_key] = dict(cap, out=y.detach().float().cpu().numpy())
            return out

        setattr(model, name, wrapped)
        undo.append((name, real))
    return lambda: [setattr(model, n, r) for n, r in undo]


def _run(params, qparams, cfg, prompt, device, mesh=None,
         local=None) -> dict:
    """Prefill and one step, recorded: (records, prefill and step
    argmax tokens); ``local`` a dict: the step's first Mamba layer's and
    shared site's inputs, caches and outputs kept in it."""
    import torch
    from repro_torch.models.model import decode_step, prefill

    rec = _Recorder()
    undo = None
    try:
        logits, caches, _ = prefill(params, cfg, prompt.to(device),
                                    qparams=qparams, cache_slots=SLOTS,
                                    mesh=mesh)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        rec.phase = "decode"
        if local is not None:
            undo = _capture(local)
        dlogits, _, _ = decode_step(params, cfg, tok0, caches,
                                    qparams=qparams, per_row_moe=True,
                                    mesh=mesh)
        rec.records.append(("prefill", "logits", logits.float().cpu().numpy()))
        rec.records.append(("decode", "logits",
                            dlogits.float().cpu().numpy()))
        return dict(records=rec.records, tok0=tok0.cpu().tolist(),
                    tok1=torch.argmax(dlogits, -1).cpu().tolist())
    finally:
        if undo is not None:
            undo()
        rec.close()


def _local(params, qparams, cfg, cap: dict, mesh, lo: int, hi: int,
           device) -> dict:
    """The step's first Mamba layer and first shared site on this rank's
    blocks, from the one-rank run's inputs and caches (``cap``): max
    |out - the one-rank out| of each, over the rank's rows."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.kv_cache import KVCache, SSMCache
    from repro_torch.sharding.partition import cache_shardings, shard_tree

    on = mesh.for_batch(ROWS)
    dt = getattr(torch, cfg.dtype)
    out = {}
    for key, cls in (("mamba", SSMCache), ("shared", KVCache)):
        c = cap[key]
        # a stacked cache of one layer, laid out as cache_shardings says
        whole = cls(**{n: torch.from_numpy(a)[None] for n, a in
                       c["cache"].items()})
        if key == "mamba":
            whole = dataclasses.replace(
                whole, conv_state=whole.conv_state.to(dt))
        else:
            whole = dataclasses.replace(whole, k=whole.k.to(dt),
                                        v=whole.v.to(dt))
        tree = {"layers" if key == "mamba" else "shared": whole}
        cache = next(iter(shard_tree(tree, cache_shardings(tree, mesh), mesh,
                                     device).values())).index(0)
        x = torch.from_numpy(c["x"][lo:hi]).to(device, dt)
        if key == "mamba":
            lp = M._index_tree(params["layers"], 0)
            q = None if qparams is None else qparams["layers"]
            y, _ = M.mamba_decode(
                M._ssm_params(lp, q, 0, M._layer_tier_flags(cfg)[0]), cfg,
                x, cache, mesh=on)
        else:
            y = M._shared_block_decode(params, cfg, x, cache, None, on)
        out[key] = float(np.abs(y.float().cpu().numpy()
                                - c["out"][lo:hi]).max())
    return out


def _free():
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _one_rank(device, reduced: bool) -> dict:
    import torch
    from repro_torch.models.model import init_params, quantize_model

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype, reduced)
        p = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
        q = quantize_model(p, cfg)
        local = {}
        out[dtype] = _run(p, q, cfg, _prompt(reduced), device, local=local)
        out[dtype]["local"] = local
        del p, q
        _free()
    return out


def _rank(rank: int, device, mesh_name: str, reduced: bool,
          local: dict) -> dict:
    """This rank's records on ``mesh_name`` in both dtypes, its rows, and
    its local runs from the one-rank run's captures ``local``."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import init_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(SHAPES[mesh_name], rank)
    lo, hi = mesh.batch_block(ROWS)
    out = dict(rows=(lo, hi))
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype, reduced)
        p, q = init_sharded(cfg, torch.Generator(device=device).manual_seed(0),
                            mesh, device=device)
        out[dtype] = _run(p, q, cfg, _prompt(reduced)[lo:hi], device,
                          mesh.for_batch(ROWS))
        out[dtype]["local"] = _local(p, q, cfg, local[dtype], mesh, lo, hi,
                                     device)
        del p, q
        _free()
    return out


def _compare(ref: dict, got: dict, lo: int, hi: int) -> dict:
    """Per record: max |got - ref| and max |ref| over the rank's rows;
    the first record of each phase that is not bitwise equal."""
    import numpy as np

    rows, first = [], {}
    assert len(ref["records"]) == len(got["records"])
    for i, ((ph, name, r), (ph2, name2, g)) in enumerate(
            zip(ref["records"], got["records"])):
        assert (ph, name) == (ph2, name2), (i, ph, name, ph2, name2)
        r = r[lo:hi]
        d = float(np.abs(g - r).max())
        rows.append(dict(i=i, phase=ph, name=name, max_abs_diff=d,
                         max_abs_ref=float(np.abs(r).max())))
        if d > 0 and ph not in first:
            first[ph] = rows[-1]
    worst = {}
    for row in rows:
        key = f"{row['phase']} {row['name']}"
        worst[key] = max(worst.get(key, 0.0), row["max_abs_diff"])
    return dict(
        first_diff=first, local=got["local"], worst=worst, records=rows,
        tok0_equal=sum(a == b for a, b in zip(got["tok0"],
                                              ref["tok0"][lo:hi])),
        tok1_equal=sum(a == b for a, b in zip(got["tok1"],
                                              ref["tok1"][lo:hi])),
        rows=hi - lo)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a quick check of the tool)")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "ssm_divergence.json"),
                    help="where every record's difference is written")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ssm_divergence: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    if args.device == "cuda":
        import chip_smoke as cs
        from repro_torch.kernels import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs._smi(), flush=True)
        _build.build_all()
    dev = torch.device(args.device)
    one = _one_rank(dev, args.reduced)
    print(f"one rank {time.perf_counter() - t0:.1f}s", flush=True)
    full, summary = {}, {}
    for mesh_name in SHAPES:
        t1 = time.perf_counter()
        ranks = spawn(_rank, 4, mesh_name, args.reduced,
                      {d: one[d]["local"] for d in one}, device=str(dev),
                      timeout_s=300.0)
        for r, got in enumerate(ranks):
            lo, hi = got["rows"]
            for dtype in ("float32", "bfloat16"):
                c = _compare(one[dtype], got[dtype], lo, hi)
                full[f"{mesh_name} {dtype} rank {r}"] = c
                if r in (0, 3):
                    summary[f"{mesh_name} {dtype} rank {r}"] = {
                        k: c[k] for k in ("first_diff", "local", "worst",
                                          "tok0_equal", "tok1_equal", "rows")}
        print(f"{mesh_name} {time.perf_counter() - t1:.1f}s", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(full))
    print("ssm_divergence: " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
