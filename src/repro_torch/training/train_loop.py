"""Training loop (torch twin of ``repro/training/train_loop.py``): the
train step, metrics history, periodic checkpoints. Works for every
architecture config the port serves.

The step runs eagerly: the reference's ``jax.jit`` has no counterpart here
(a CUDA graph of the step is later work, see ROADMAP.md). ``device`` None
means CUDA, and raises without it. ``mesh`` / ``shardings`` are kept, as
the reference keeps them (its step does not read them either).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, train_step_fn
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import AdamW, cosine_lr

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    log_every: int = 10
    checkpoint_every: int = 0  # 0 = only final
    checkpoint_dir: Optional[str] = None
    seed: int = 0


class TrainLoop:
    """AdamW under a cosine schedule over ``loop_cfg.steps`` steps. The
    params are drawn by ``init_params`` from a ``torch.Generator`` seeded
    with ``loop_cfg.seed`` (torch cannot reproduce ``jax.random``: assign
    ``params`` and ``opt_state`` to start from other weights)."""

    def __init__(self, cfg: ModelConfig, loop_cfg: TrainLoopConfig,
                 device=None, mesh=None, shardings=None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        # a repro_torch.launch.mesh.Mesh and spec trees (e.g.
        # sharding.partition.zero1_shardings): stored, as the reference
        # stores them; the step runs on this process's device
        self.mesh = mesh
        self.shardings = shardings
        self.device = resolve_device(device)
        self.optimizer = AdamW(
            lr=cosine_lr(loop_cfg.lr, loop_cfg.warmup, loop_cfg.steps),
            weight_decay=loop_cfg.weight_decay)
        gen = torch.Generator(device=self.device).manual_seed(loop_cfg.seed)
        self.params = init_params(cfg, gen, self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.history: list = []
        self._step = train_step_fn(cfg, self.optimizer)

    def run(self, batches: Iterator[Dict[str, Any]],
            callback: Optional[Callable[[int, Dict], None]] = None) -> Dict:
        """``loop_cfg.steps`` steps over ``batches`` (dicts of arrays);
        every ``log_every`` steps the metrics go to ``history`` and
        ``callback(step, metrics)``. Returns the last step's metrics with
        ``wall_s`` and ``steps``."""
        lc = self.loop_cfg
        t0 = time.perf_counter()
        metrics = {}
        for i in range(lc.steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(batches).items()}
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            if lc.log_every and i % lc.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.history.append(dict(m, step=i))
                if callback:
                    callback(i, m)
            if (lc.checkpoint_every and lc.checkpoint_dir
                    and i and i % lc.checkpoint_every == 0):
                save_checkpoint(lc.checkpoint_dir, i, self.params)
        if lc.checkpoint_dir:
            save_checkpoint(lc.checkpoint_dir, lc.steps, self.params)
        wall = time.perf_counter() - t0
        return dict({k: float(v) for k, v in metrics.items()},
                    wall_s=wall, steps=lc.steps)
