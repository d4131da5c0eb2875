"""Training launcher of the port (torch twin of ``repro/launch/train.py``),
on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --steps 200 --batch-size 8 --seq-len 256 [--reduced] [--full]

``--reduced`` (the default) trains the arch's small variant; ``--full``
its published widths and depth. Batches come from the synthetic Markov
corpus (``repro_torch.data``) seeded with ``--seed``, the params from a
``torch.Generator`` seeded the same (not the reference's ``jax.random``
draw). Prints a line every 10 steps and then the result as JSON, with the
reference's keys; ``--checkpoint-dir`` writes the final params there in
the reference's checkpoint layout.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.training import TrainLoop, TrainLoopConfig

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    loop = TrainLoop(cfg, TrainLoopConfig(
        steps=args.steps, lr=args.lr, checkpoint_dir=args.checkpoint_dir,
        seed=args.seed), device=args.device)
    batches = synthetic_lm_batches(DataConfig(
        batch_size=args.batch_size, seq_len=args.seq_len,
        vocab_size=cfg.vocab_size, seed=args.seed))
    result = loop.run(batches, callback=lambda i, m: print(
        f"step {i:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
