"""Trace the serving programs once and run the invariant rules (torch twin
of ``repro/analysis/lint.py``).

Every target is one eager run of a serving program under
:func:`~repro_torch.analysis.walker.trace_ops`. By default the run is on
PyTorch's ``meta`` device: FULL-SIZE configs trace with zero bytes of
parameters allocated, the heir of ``jax.eval_shape`` (the kernels return
empty outputs of their shapes there, so the kernel-resources rule sees
the real shapes each call launches at). ``device="cpu"`` traces real
tensors from seeded params (the kernels' plain versions run inside their
scopes); ``device="cuda"`` runs the CUDA kernels, under
``torch.cuda.set_sync_debug_mode("error")``.

Per config the linter builds:

  prefill       solo prefill (B=1), quantized, DyMoE policy active
  admission     the batched ragged row-local admission wave (attention
                archs without ring caches — mirrors the scheduler's
                ``_can_batch_admissions`` gate)
  decode_chunk  the scheduler's multi-step dispatch
                (``decode_many_batched`` with done-mask + ``live_cap``)
  prefill_ep /  the same programs as rank 0 of an ABSTRACT (1, 4)
  decode_chunk_ep  ("data", "model") mesh (MoE configs): params and
                packed stores are rank 0's shards of
                ``param_shardings(expert_parallel=True)`` and the decode
                state its block of ``cache_shardings`` (``shard_tree``, as
                the engine's ``mesh`` path lays them out); the mesh has no
                world, so its collectives are shape-only and these targets
                trace on ``meta`` whatever the device
  retrace       accounting-only target for the live_cap ladder

each across the config's bit mixes ("4/2"-style mixed and "4/0").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.rules import Finding, LintTarget, RULES, \
    run_rules
from repro_torch.analysis.walker import trace_ops
from repro_torch.configs import ANALYSIS_SMOKE_CONFIGS, ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.moe import _capacity
from repro_torch.models.model import decode_many_batched, \
    init_decode_state, init_params, prefill, quantize_model
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.serving.scheduler import live_cap_for

__all__ = ["build_targets", "lint_config", "lint_configs", "lint_targets",
           "main", "forbidden_shapes_from_qparams", "trace_target"]

# Trace shapes: small token counts keep tracing fast; weight/block shapes
# (what the rules actually measure) come from the config, not from these.
_PREFILL_S = 32
_ADMIT_B = 2
_DECODE_B = 8
_DECODE_CHUNK = 4
_DECODE_SLOTS = 64
# the sharded targets' abstract mesh width (as the reference's)
_SHARD_N = 4


def _mix_cfg(cfg: ModelConfig, mix: str) -> ModelConfig:
    pol = cfg.dymoe
    if mix == "4/0":
        pol = dataclasses.replace(pol, low_bits=0)
    elif mix != "mixed":
        raise ValueError(f"unknown bit mix {mix!r}")
    return dataclasses.replace(cfg, dymoe=pol)


def _mix_label(cfg: ModelConfig) -> str:
    return f"{cfg.dymoe.high_bits}/{cfg.dymoe.low_bits}"


def _state(cfg: ModelConfig, device: torch.device) -> Tuple[Any, Any]:
    """(params, qparams) on ``device`` from seed 0 — on meta full size
    and 0 bytes."""
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu")
    params = init_params(cfg, gen.manual_seed(0), device=device)
    return params, quantize_model(params, cfg)


def forbidden_shapes_from_qparams(qparams) -> frozenset:
    """Dense dequantized shapes of every quantized leaf, in both matmul
    orientations, at both the stacked-layers view and the per-layer slice
    one layer's code sees."""
    shapes = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, MixedPrecisionWeights):
            walk(node.high)
            walk(node.low)
        elif isinstance(node, QuantizedTensor):
            lead = tuple(node.packed.shape[:-2])
            n = node.packed.shape[-2]
            for ld in (lead, lead[1:]):     # stacked (L, ...) and per-layer
                shapes.add(ld + (n, node.k))
                shapes.add(ld + (node.k, n))

    walk(qparams)
    return frozenset(shapes)


def _abstract_mesh():
    """A (1, _SHARD_N) ("data", "model") mesh with no world behind it:
    rank 0's program runs on meta tensors, its collectives shape-only
    (the heir of the reference's ``AbstractMesh``)."""
    from repro_torch.launch.mesh import Mesh
    return Mesh({"data": 1, "model": _SHARD_N})


def _to_meta(tree):
    """A tree of params / stores on the meta device."""
    from repro_torch.tree import tree_map

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to("meta")
        if isinstance(v, MixedPrecisionWeights):
            return MixedPrecisionWeights(leaf(v.high), leaf(v.low))
        if isinstance(v, QuantizedTensor):
            return dataclasses.replace(v, packed=leaf(v.packed),
                                       scales=leaf(v.scales))
        return v
    return tree_map(leaf, tree)


def _shard(tree, mesh):
    from repro_torch.sharding.partition import param_shardings, shard_tree
    return shard_tree(tree, param_shardings(tree, mesh,
                                            expert_parallel=True), mesh)


def _tokens(shape, cfg, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int64).to(device)


# -------------------------------------------------------------- programs


def _prefill_program(cfg, params, qparams, device, mesh=None):
    toks = _tokens((1, _PREFILL_S), cfg, device)

    def f(p, q, tok):
        return prefill(p, cfg, tok, qparams=q, cache_slots=_DECODE_SLOTS,
                       mesh=mesh)

    return f, (params, qparams, toks), cfg.num_layers


def _admission_supported(cfg: ModelConfig) -> bool:
    # mirrors scheduler._can_batch_admissions: attention archs only, no
    # weight-shared hybrid blocks, no sliding-window ring caches
    return (cfg.block_kinds()[0] in ("attn_dense", "attn_moe")
            and not cfg.shared_attn_every and cfg.sliding_window is None)


def _admission_program(cfg, params, qparams, device, mesh=None):
    toks = _tokens((_ADMIT_B, _PREFILL_S), cfg, device)
    lens = [_PREFILL_S - 12 * i for i in range(_ADMIT_B)]
    lengths = torch.tensor(lens, dtype=torch.int32).to(device)
    caps = (torch.tensor([_capacity(cfg, s) for s in lens],
                         dtype=torch.int64).to(device)
            if cfg.is_moe else None)

    def f(p, q, tok, ln, rc):
        return prefill(p, cfg, tok, qparams=q, cache_slots=_DECODE_SLOTS,
                       lengths=ln, row_local=True, row_capacities=rc,
                       mesh=mesh)

    return f, (params, qparams, toks, lengths, caps), cfg.num_layers


def _decode_program(cfg, params, qparams, device, mesh=None):
    b = _DECODE_B
    caches = init_decode_state(cfg, b, _DECODE_SLOTS, device)
    if mesh is not None:
        from repro_torch.sharding.partition import cache_shardings, \
            shard_tree
        caches = shard_tree(caches, cache_shardings(caches, mesh), mesh)
    toks = _tokens((b,), cfg, device).to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    emitted = torch.zeros((b,), dtype=torch.int32, device=device)
    limits = torch.full((b,), _DECODE_SLOTS, dtype=torch.int32,
                        device=device)
    eos = torch.full((b,), -1, dtype=torch.int32, device=device)

    def f(p, q, tok, cch, dn, em, lim, eo):
        return decode_many_batched(
            p, cfg, tok, cch, num_steps=_DECODE_CHUNK, done=dn,
            n_emitted=em, limits=lim, eos_tokens=eo, qparams=q,
            live_cap=live_cap_for(b, b), mesh=mesh)

    return (f, (params, qparams, toks, caches, done, emitted, limits, eos),
            cfg.num_layers * _DECODE_CHUNK)


def trace_target(name: str, cfg: ModelConfig, phase: str, fn: Callable,
                 args: Sequence, layer_steps: int, *,
                 forbidden: Optional[frozenset] = None,
                 device: str = "meta", **extra) -> LintTarget:
    """Trace ``fn(*args)`` once and wrap it as a target; a run that raises
    becomes a target carrying ``trace_error`` (and the trace up to the
    failure). ``extra``: further :class:`LintTarget` fields."""
    watch = forbidden if forbidden is not None else frozenset()
    sync = torch.cuda.set_sync_debug_mode if device == "cuda" else None
    try:
        if sync is not None:
            sync("error")
        try:
            _, trace = trace_ops(fn, *args, watch_shapes=watch)
        finally:
            if sync is not None:
                sync("default")
    except Exception as e:  # noqa: BLE001 - reported as finding
        return LintTarget(name=name, cfg=cfg, phase=phase,
                          trace=getattr(e, "trace", None), device=device,
                          forbidden_shapes=forbidden,
                          layer_steps=layer_steps,
                          trace_error=f"{type(e).__name__}: {e}", **extra)
    return LintTarget(name=name, cfg=cfg, phase=phase, trace=trace,
                      device=device, fused=True, forbidden_shapes=forbidden,
                      layer_steps=layer_steps, **extra)


def build_targets(name: str, cfg: ModelConfig, *,
                  mixes: Sequence[str] = ("mixed", "4/0"),
                  device="meta") -> List[LintTarget]:
    """Every lint target for one config: traced targets per phase × bit
    mix, plus the accounting-only retrace target. Runs that raise become
    targets carrying ``trace_error``."""
    dev = resolve_device(device)
    targets: List[LintTarget] = []
    seen_mix = set()
    for mix in mixes:
        mcfg = _mix_cfg(cfg, mix)
        label = _mix_label(mcfg)
        if label in seen_mix:   # a "4/0"-native config: one real mix
            continue
        seen_mix.add(label)
        params, qparams = _state(mcfg, dev)
        forbidden = forbidden_shapes_from_qparams(qparams)
        phases: List[Tuple[str, Callable, bool]] = [
            ("prefill", _prefill_program, False)]
        if _admission_supported(mcfg):
            phases.append(("admission", _admission_program, False))
        phases.append(("decode_chunk", _decode_program, False))
        if mcfg.is_moe:
            # rank 0 of an abstract expert-parallel mesh: the structural
            # contract must survive the serving tier's sharding
            phases.append(("prefill_ep", _prefill_program, True))
            phases.append(("decode_chunk_ep", _decode_program, True))
        sharded = None
        for phase, program, ep in phases:
            tname = f"{name}/{label}/{phase}"
            mesh = None
            p, q, pdev = params, qparams, dev
            if ep:
                mesh = _abstract_mesh()
                if sharded is None:
                    meta_p, meta_q = ((params, qparams) if dev.type == "meta"
                                      else (_to_meta(params),
                                            _to_meta(qparams)))
                    sharded = (_shard(meta_p, mesh), _shard(meta_q, mesh))
                p, q = sharded
                pdev = torch.device("meta")
            try:
                fn, args, steps = program(mcfg, p, q, pdev, mesh=mesh)
            except Exception as e:  # noqa: BLE001 - reported as finding
                targets.append(LintTarget(
                    name=tname, cfg=mcfg, phase=phase, device=pdev.type,
                    trace_error=f"{type(e).__name__}: {e}"))
                continue
            targets.append(trace_target(
                tname, mcfg, phase, fn, args, steps, forbidden=forbidden,
                device=pdev.type))
    targets.append(LintTarget(
        name=f"{name}/scheduler/retrace", cfg=cfg, phase="retrace",
        slots=_DECODE_B, ladder=live_cap_for))
    return targets


def lint_targets(targets: Sequence[LintTarget],
                 only_rules: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    """Findings of the rules over ``targets``; a target whose run raised
    gives a ``trace-error`` finding, and the host-sync rule still reads
    its trace up to the failure."""
    findings: List[Finding] = []
    for t in targets:
        if t.trace_error is not None:
            findings.append(Finding(
                rule="trace-error", severity="error", target=t.name,
                message=f"tracing the {t.phase} program failed: "
                        f"{t.trace_error}"))
            if t.trace is not None and (only_rules is None
                                        or "host-sync" in only_rules):
                findings.extend(run_rules(t, only=["host-sync"]))
            continue
        findings.extend(run_rules(t, only=only_rules))
    return findings


def lint_config(name: str, cfg: ModelConfig, *,
                mixes: Sequence[str] = ("mixed", "4/0"),
                only_rules: Optional[Sequence[str]] = None,
                device="meta") -> Tuple[int, List[Finding]]:
    """(target count, findings) for one config."""
    targets = build_targets(name, cfg, mixes=mixes, device=device)
    return len(targets), lint_targets(targets, only_rules)


def lint_configs(names: Sequence[str], *,
                 only_rules: Optional[Sequence[str]] = None,
                 progress=None, device="meta",
                 configs: Optional[Dict[str, ModelConfig]] = None
                 ) -> Dict[str, Any]:
    """Lint a set of configs into the JSON-able report structure
    (``configs`` overrides a name's config, e.g. with ``.reduced()``)."""
    report: Dict[str, Any] = {
        "version": 1,
        "rules": sorted(RULES),
        "device": str(device),
        "configs": {},
        "findings": [],
    }
    n_targets = 0
    for name in names:
        cfg = (configs or {}).get(name) or get_config(name)
        count, findings = lint_config(name, cfg, only_rules=only_rules,
                                      device=device)
        n_targets += count
        errs = sum(f.severity == "error" for f in findings)
        report["configs"][name] = {
            "targets": count, "errors": errs,
            "warnings": sum(f.severity == "warning" for f in findings),
        }
        report["findings"].extend(f.to_json() for f in findings)
        if progress is not None:
            progress(name, count, errs)
    report["summary"] = {
        "configs": len(report["configs"]),
        "targets": n_targets,
        "errors": sum(1 for f in report["findings"]
                      if f["severity"] == "error"),
        "warnings": sum(1 for f in report["findings"]
                        if f["severity"] == "warning"),
    }
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Op-trace invariant linter over the shipped configs.")
    ap.add_argument("--config", action="append", default=None,
                    metavar="NAME", help="lint this config (repeatable); "
                    "default: every entry in the registry")
    ap.add_argument("--smoke", action="store_true",
                    help=f"edge-config subset: {ANALYSIS_SMOKE_CONFIGS}")
    ap.add_argument("--rules", default=None, metavar="R1,R2",
                    help="comma-separated rule-id filter")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-config progress lines")
    ap.add_argument("--device", default="meta",
                    choices=["meta", "cpu", "cuda"],
                    help="where the traced runs happen: meta (full size, "
                    "no memory; default), cpu (seeded params, the "
                    "kernels' plain versions) or cuda (the CUDA kernels)")
    ap.add_argument("--reduced", action="store_true",
                    help="lint each config's .reduced() variant")
    args = ap.parse_args(argv)

    names = args.config or (list(ANALYSIS_SMOKE_CONFIGS) if args.smoke
                            else list(ARCH_IDS))
    only = args.rules.split(",") if args.rules else None
    unknown = set(only or ()) - set(RULES)
    if unknown:
        ap.error(f"unknown rules {sorted(unknown)}; "
                 f"available: {sorted(RULES)}")

    def progress(name: str, count: int, errs: int) -> None:
        if not args.quiet:
            status = "ok" if not errs else f"{errs} error(s)"
            print(f"[lint] {name}: {count} targets, {status}", flush=True)

    configs = ({n: get_config(n).reduced() for n in names} if args.reduced
               else None)
    report = lint_configs(names, only_rules=only, progress=progress,
                          device=args.device, configs=configs)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    for f in report["findings"]:
        print(f"{f['severity'].upper()} {f['rule']} @ {f['target']} "
              f"[{f['provenance'] or '<top>'}]: {f['message']}",
              file=sys.stderr)
    s = report["summary"]
    print(f"[lint] {s['configs']} configs / {s['targets']} targets: "
          f"{s['errors']} errors, {s['warnings']} warnings")
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
