"""Dry run: every (architecture × input shape × mesh) step built on the
``meta`` device, with its memory, FLOPs, bytes and collectives for the
roofline (torch twin of ``repro/launch/dryrun.py``).

The JAX package lowered and compiled each step under the production
sharding on 512 host-simulated devices and read XLA's memory and cost
analyses. The port has no compiler to ask; what it has is one run of the
same step on PyTorch's abstract device, where full-size tensors cost no
memory. So, per (arch, shape, mesh):

* **memory** — the argument bytes a rank, by shape arithmetic over the
  spec trees (``param_shardings``, ``cache_shardings``,
  ``zero1_shardings``) on an abstract ``Mesh`` (no world is needed: the
  production meshes 16×16 and 2×16×16 are plain shapes); and from the
  traced step, its output bytes, the largest sum of live bytes it
  allocated (``temp_bytes``) and ``peak_bytes`` = arguments + that;
* **flops** — ``torch.utils.flop_counter.FlopCounterMode`` over the
  traced step, plus 2·M·K·N for each packed-matmul kernel call (whose
  body does not run on meta);
* **bytes** — the op trace's bytes read and written: each op outside a
  kernel call reads its inputs and writes its outputs once, each kernel
  call reads its operands and writes its result once. This stands where
  XLA's "bytes accessed" stood;
* **collectives** — the payload bytes of the abstract mesh's collectives
  (``collective_bytes_from_mesh``), and the same counts by axis in
  ``collectives_by_axis`` ("model", "data" — the composite ("pod",
  "data") — and "world"), so a record says what crossed "data";
* ``roofline_terms`` with the H100's :class:`~repro_torch.roofline.HW`.

The traced step is rank 0's program on an abstract ``Mesh`` of the
record's shape: its arguments are rank 0's blocks (``shard_tree``: the
weights split over "model", the KV caches' slots and the SSM states'
channels or heads over "model", the batch and the caches' rows over
("pod", "data") where the data ranks divide them), and it runs on
``Mesh.for_batch`` of the global batch — a batch the data ranks do not
divide (``long_500k``'s one row) is replicated, every data rank computing
it whole. A one-mask MoE site of a split batch gathers its tokens over
"data" and runs as one rank would, or, with ``local_dispatch``
(``moe_dispatch_axes`` over the batch axes), dispatches a rank's own
groups and sums its statistics over "data" (``models/model.py``). The
train step is traced so too: rank 0's forward and backward on its blocks
of the weights and its rows of the batch, its grads summed over "data",
and AdamW on its blocks of the moments (``param_shardings``, or with
``zero1`` also split over "data", the param slices then gathered back
over "data"); the backward's collectives, and with remat the recomputed
forward's, count as the forward's do. The port has no layer scan: a
trace holds every layer, so a deep config whose one-layer trace predicts
more than ``FULL_TRACE_S`` seconds for full depth is traced at depth 1
and at a probe depth, and its terms extrapolated linearly
(:func:`_extrapolate`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape decode_32k [--mesh 1x4] [--expert-parallel]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records are printed and appended as JSON lines to
``build/dryrun/<mesh>.jsonl`` (git-ignored) unless ``--save-dir`` says
otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.walker import tensor_bytes, trace_ops
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, init_decode_state, \
    init_params, prefill, quantize_model, train_step_fn
from repro_torch.roofline.analysis import HW, collective_bytes_from_mesh, \
    model_flops_estimate, roofline_terms
from repro_torch.sharding.partition import P, _axis_size, batch_spec, \
    cache_shardings, guard_spec, param_shardings, shard_tree, tree_specs, \
    zero1_shardings
from repro_torch.training.optimizer import AdamW, AdamWState, constant_lr

__all__ = ["SHAPES", "LONG_CONTEXT_WINDOW", "MESHES", "shape_adapted_config",
           "strip_expert_weights", "build_specs", "argument_bytes",
           "run_one", "main"]

# input shapes assigned to this paper
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(seq_len=4096, global_batch=256, phase="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, phase="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, phase="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, phase="decode"),
}

LONG_CONTEXT_WINDOW = 8192  # sliding window used by attention archs @500k

# the meshes a record can name: one card, the simulated edge cluster, and
# the reference's production meshes
MESHES: Dict[str, Dict[str, int]] = {
    "1x1": {"data": 1, "model": 1},
    "1x4": {"data": 1, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
PRODUCTION = ("16x16", "2x16x16")
# a deeper full trace than this is extrapolated from two shallow ones
FULL_TRACE_S = 60.0
_META = torch.device("meta")


def shape_adapted_config(cfg: ModelConfig, shape: str) -> ModelConfig:
    """long_500k requires sub-quadratic attention: attention archs switch to
    the implemented sliding-window ring cache; SSM archs run
    natively. Training drops DyMoE (it is an inference-time technique)."""
    if shape == "long_500k" and cfg.has_attention:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def strip_expert_weights(params_tree, cfg: ModelConfig):
    """Serving keeps experts ONLY in the quantized store (the paper's whole
    point); drop the bf16 masters from the serve-step inputs."""
    params_tree = dict(params_tree)
    layers = dict(params_tree["layers"])
    kind = cfg.block_kinds()[0]
    if kind == "attn_moe":
        layers["moe"] = {k: v for k, v in layers["moe"].items()
                         if k not in ("w_gate", "w_up", "w_down")}
    elif kind == "attn_dense":
        layers["mlp"] = {}
    else:
        layers["ssm"] = {k: v for k, v in layers["ssm"].items()
                         if k not in ("in_proj", "out_proj")}
    params_tree["layers"] = layers
    return params_tree


# -------------------------------------------------------------------- specs


def _meta_params(cfg: ModelConfig):
    return init_params(cfg, torch.Generator().manual_seed(0), device=_META)


def build_specs(cfg: ModelConfig, shape: str, mesh: Mesh,
                expert_parallel: bool = False, opts: tuple = ()):
    """(cfg, step, args, shardings) for one (arch, shape): the step
    function ``step(*args, mesh=None)``, its whole arguments as meta
    tensors, and their spec trees on ``mesh``.

    opts: perf levers of the reference's dry run —
      "attn_skip"  causal chunk skipping in prefill/train attention
      "bf16_attn"  bf16 qk/pv einsums (halves KV-read bytes)
      "zero1"      shard optimizer moments over the data axis
      "seq_acts"   sequence-shard the residual carry (remat footprint)
      "dymoe_40"   the paper's 4/0 policy
      "local_dispatch"  data-local MoE dispatch over ("pod", "data")
    """
    info = SHAPES[shape]
    s, b, phase = info["seq_len"], info["global_batch"], info["phase"]
    cfg = shape_adapted_config(cfg, shape)
    if "attn_skip" in opts:
        cfg = dataclasses.replace(cfg, attn_causal_skip=True)
    if "bf16_attn" in opts:
        cfg = dataclasses.replace(cfg, attn_compute_dtype="bfloat16")
    if "seq_acts" in opts:
        cfg = dataclasses.replace(cfg, act_seq_shard=True)
    if "dymoe_40" in opts:  # the paper's 4/0 policy: skip sub-critical
        cfg = dataclasses.replace(
            cfg, dymoe=dataclasses.replace(cfg.dymoe, low_bits=0))
    if "local_dispatch" in opts and cfg.is_moe:
        axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        shards = 1
        for a in axes:
            shards *= mesh.shape[a]
        cfg = dataclasses.replace(cfg, moe_dispatch_shards=shards,
                                  moe_dispatch_axes=axes)

    params = _meta_params(cfg)
    p_shard = param_shardings(params, mesh, expert_parallel=expert_parallel)
    b_axes = batch_spec(mesh)

    def batched(t: torch.Tensor) -> P:
        """The batch dim over ("pod", "data"), as the reference's inputs."""
        return guard_spec(P(b_axes, *([None] * (t.dim() - 1))),
                          tuple(t.shape), mesh)

    if phase == "train":
        opt = AdamW(lr=constant_lr(1e-4))
        state = opt.init(params)
        moments = {"step": state.step, "mu": state.mu, "nu": state.nu}
        if "zero1" in opts:
            o_shard = zero1_shardings(moments, mesh,
                                      expert_parallel=expert_parallel)
        else:
            o_shard = param_shardings(moments, mesh,
                                      expert_parallel=expert_parallel)
        batch = {
            "tokens": torch.zeros((b, s), dtype=torch.int32, device=_META),
            "labels": torch.zeros((b, s), dtype=torch.int32, device=_META),
        }
        def step(params, moments, batch, mesh=None):
            return train_step_fn(cfg, opt, mesh)(
                params, AdamWState(**moments), batch)

        return (cfg, step, (params, moments, batch),
                (p_shard, o_shard, {k: batched(v) for k, v in batch.items()}))

    qparams = quantize_model(params, cfg)
    q_shard = param_shardings(qparams, mesh, expert_parallel=expert_parallel)
    sparams = strip_expert_weights(params, cfg)
    sp_shard = strip_expert_weights(p_shard, cfg)

    if phase == "prefill":
        if cfg.arch_type in ("vlm", "audio"):
            # frontend stub: precomputed patch/frame embeddings
            inp = torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16,
                              device=_META)

            def step(params, qparams, embeds, mesh=None):
                return prefill(params, cfg, None, embeds=embeds,
                               qparams=qparams, cache_slots=s, mesh=mesh)
        else:
            inp = torch.zeros((b, s), dtype=torch.int32, device=_META)

            def step(params, qparams, tokens, mesh=None):
                return prefill(params, cfg, tokens, qparams=qparams,
                               cache_slots=s, mesh=mesh)

        return (cfg, step, (sparams, qparams, inp),
                (sp_shard, q_shard, batched(inp)))

    # decode: ONE new token against a seq_len-deep cache
    caches = init_decode_state(cfg, b, s, _META)
    c_shard = cache_shardings(caches, mesh)
    tokens = torch.zeros((b,), dtype=torch.int32, device=_META)

    def step(params, qparams, tokens, caches, mesh=None):
        return decode_step(params, cfg, tokens, caches, qparams=qparams,
                           mesh=mesh)

    return (cfg, step, (sparams, qparams, tokens, caches),
            (sp_shard, q_shard, batched(tokens), c_shard))


def argument_bytes(args, shardings, mesh) -> int:
    """Bytes of ``args`` one rank holds under ``shardings`` on ``mesh``:
    each leaf's bytes over the sizes of the mesh axes its spec splits it
    over (a None spec tree: whole on every rank). Shape arithmetic only."""
    total = 0
    for tree, specs in zip(args, shardings):
        leaves: Dict[str, Any] = {}
        tree_specs(tree, lambda p, leaf: leaves.setdefault(p, leaf))
        split: Dict[str, int] = {}
        if specs is not None:
            tree_specs(specs, lambda p, spec: split.setdefault(p, spec))
        for path, leaf in leaves.items():
            if not isinstance(leaf, torch.Tensor):
                continue
            n = 1
            for axes in split.get(path, ()) or ():
                n *= _axis_size(mesh, axes)
            total += leaf.numel() * leaf.element_size() // n
    return total


# ------------------------------------------------------------------- runner


def _kernel_flops(site) -> float:
    """2·M·K·N of one packed-matmul kernel call (its body does not run
    on meta); the attention kernels' products, uncausal."""
    x, y = site.inputs[0], site.outputs[0] if site.outputs else None
    if y is None:
        return 0.0
    if site.kernel in ("flash_fwd", "key_mass"):
        h, s, d = x.shape
        return (4.0 if site.kernel == "flash_fwd" else 2.0) * h * s * s * d
    return 2.0 * x.numel * y.shape[-1]


def _trace_step(cfg0: ModelConfig, shape: str, mesh: Mesh,
                expert_parallel: bool, opts: tuple,
                num_layers: Optional[int] = None) -> Dict[str, Any]:
    """Rank 0's step on meta at ``num_layers`` (None: full depth): seconds,
    FLOPs, bytes, collective bytes, output and temp bytes."""
    cfg_n = (dataclasses.replace(cfg0, num_layers=num_layers)
             if num_layers else cfg0)
    cfg, step, args, shardings = build_specs(cfg_n, shape, mesh,
                                             expert_parallel, opts)
    traced_mesh = Mesh(mesh.shape)           # fresh payload counters
    run_mesh = None
    if traced_mesh.size > 1:
        # the train step's moments (its second argument) are Shards
        # wherever split, over the data axes alone (ZeRO-1) too
        train = SHAPES[shape]["phase"] == "train"
        args = tuple(a if sp is None else shard_tree(
            a, sp, traced_mesh, shard_all=train and i == 1)
            for i, (a, sp) in enumerate(zip(args, shardings)))
        run_mesh = traced_mesh.for_batch(SHAPES[shape]["global_batch"])
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out, trace = trace_ops(step, *args, mesh=run_mesh)
    seconds = time.perf_counter() - t0
    flops = float(fc.get_total_flops()) + sum(
        _kernel_flops(s) for s in trace.sites
        if s.kernel is not None and not s.in_kernel)
    return dict(cfg=cfg, seconds=seconds, flops=flops,
                bytes=float(trace.bytes_accessed()),
                coll=collective_bytes_from_mesh(traced_mesh),
                coll_axis={a: {k: n for k, n in v.items() if k != "seconds"}
                           for a, v in
                           traced_mesh.collectives_by_axis.items()},
                output_bytes=tensor_bytes(out, exclude=args),
                temp_bytes=trace.peak_temp_bytes)


def _extrapolate(v_scan: float, v_unroll: float, l_probe: int, l_full: int
                 ) -> float:
    """The reference's scan-vs-unrolled recovery, used here on two traced
    depths: ``v_scan`` the value at depth 1 (outside + one body),
    ``v_unroll`` at depth ``l_probe`` (outside + l·body). Solving:
        body  = (v_unroll - v_scan) / (l - 1)
        total = v_scan + (L_full - 1)·body
    """
    if l_probe <= 1:
        return v_unroll
    body = max(0.0, (v_unroll - v_scan) / (l_probe - 1))
    return v_scan + (l_full - 1) * body


def run_one(arch: str, shape: str, *, mesh: str = "1x1",
            expert_parallel: bool = False, hw: HW = HW(),
            save_dir: Optional[str] = "build/dryrun",
            verbose: bool = True, opts: tuple = ()) -> Dict[str, Any]:
    """One record: memory a rank on ``mesh`` and on the production
    meshes, and rank 0's traced step's terms on ``mesh`` (the module
    docstring)."""
    m = Mesh(MESHES[mesh])
    n_chips = m.size
    cfg0 = get_config(arch)
    info = SHAPES[shape]

    cfg, _, args, shardings = build_specs(cfg0, shape, m, expert_parallel,
                                          opts)
    mem: Dict[str, Any] = {"argument_bytes": argument_bytes(args, shardings,
                                                            m)}
    mem["argument_bytes_by_mesh"] = {}
    for name in PRODUCTION:
        pm = Mesh(MESHES[name])
        _, _, pargs, pshard = build_specs(cfg0, shape, pm, expert_parallel,
                                          opts)
        mem["argument_bytes_by_mesh"][name] = argument_bytes(pargs, pshard,
                                                             pm)
    del args

    result: Dict[str, Any] = dict(
        arch=arch, shape=shape, mesh=mesh, chips=n_chips,
        expert_parallel=expert_parallel, opts=list(opts),
        phase=info["phase"], hw=dataclasses.asdict(hw),
        hw_name="NVIDIA H100 SXM5 (datasheet peaks)")
    tokens = (info["global_batch"] * info["seq_len"]
              if info["phase"] != "decode" else info["global_batch"])
    mf = model_flops_estimate(cfg, tokens=tokens, phase=info["phase"])
    lf = cfg0.num_layers
    l_probe = min(max(2, 2 * (cfg0.shared_attn_every or 1)), lf)
    one = _trace_step(cfg0, shape, m, expert_parallel, opts, 1)
    if lf <= l_probe or one["seconds"] * lf <= FULL_TRACE_S:
        full = _trace_step(cfg0, shape, m, expert_parallel, opts)
        depth = f"full ({lf} layers)"
    else:
        probe = _trace_step(cfg0, shape, m, expert_parallel, opts,
                            l_probe)
        full = dict(probe, seconds=one["seconds"] + probe["seconds"])
        for k in ("flops", "bytes", "temp_bytes"):
            full[k] = _extrapolate(one[k], probe[k], l_probe, lf)
        full["coll"] = {k: int(_extrapolate(one["coll"][k],
                                            probe["coll"][k], l_probe,
                                            lf))
                        for k in one["coll"]}
        full["coll_axis"] = {
            a: {k: int(_extrapolate(v, probe["coll_axis"][a][k],
                                    l_probe, lf))
                for k, v in one["coll_axis"][a].items()}
            for a in one["coll_axis"]}
        depth = f"extrapolated from depths 1 and {l_probe} to {lf}"
    coll = full["coll"]
    terms = roofline_terms({"flops": full["flops"],
                            "bytes accessed": full["bytes"]},
                           coll["total"], hw)
    mem.update(output_bytes=full["output_bytes"],
               temp_bytes=int(full["temp_bytes"]),
               peak_bytes=mem["argument_bytes"]
               + int(full["temp_bytes"]))
    total = terms["flops"] * n_chips
    result.update(
        lower_s=full["seconds"], compile_s=None, memory=mem,
        collectives=coll, collectives_by_axis=full["coll_axis"],
        model_flops=mf,
        useful_flops_ratio=(mf / total if total else 0.0),
        **terms, traced="rank 0 on meta", depth=depth,
        bytes_source="op trace: each op outside a kernel call reads "
                     "its inputs and writes its outputs once, each "
                     "kernel call its operands and result")
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        tag = "ep_" if expert_parallel else ""
        if opts:
            tag += "opt-" + "-".join(sorted(opts)) + "_"
        with open(os.path.join(save_dir, f"{tag}{mesh}.jsonl"), "a") as f:
            f.write(json.dumps(result, default=str) + "\n")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS + [a.replace("_", "-")
                                                  for a in ARCH_IDS])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="all 10 assigned archs x 4 shapes")
    ap.add_argument("--include-paper", action="store_true",
                    help="also run mixtral-8x7b / qwen3-30b-a3b")
    ap.add_argument("--mesh", default="1x1", choices=list(MESHES),
                    help="the mesh of the record (rank 0's program on it)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--opt", "--opts", dest="opt", action="append",
                    default=[],
                    choices=["attn_skip", "bf16_attn", "zero1", "seq_acts",
                             "local_dispatch", "dymoe_40"],
                    help="perf levers (repeatable)")
    ap.add_argument("--save-dir", default="build/dryrun")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh

    if args.all:
        failures = []
        archs = ARCH_IDS if args.include_paper else [
            a for a in ARCH_IDS if a not in ("mixtral_8x7b", "qwen3_30b_a3b")]
        for arch in archs:
            for shape in SHAPES:
                try:
                    r = run_one(arch, shape, mesh=mesh,
                                expert_parallel=args.expert_parallel,
                                save_dir=args.save_dir, verbose=False,
                                opts=tuple(args.opt))
                    print(f"OK   {arch:18s} {shape:12s} "
                          f"trace={r['lower_s'] or 0:7.1f}s "
                          f"dominant={r['dominant']}")
                except Exception as e:
                    failures.append((arch, shape, str(e)[:200]))
                    print(f"FAIL {arch:18s} {shape:12s} {e}")
        if failures:
            raise SystemExit(f"{len(failures)} dry-run failures")
        return
    assert args.arch and args.shape, "--arch/--shape or --all"
    run_one(args.arch.replace("-", "_").replace(".", "p"), args.shape,
            mesh=mesh, expert_parallel=args.expert_parallel,
            save_dir=args.save_dir, opts=tuple(args.opt))


if __name__ == "__main__":
    main()
