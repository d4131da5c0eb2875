"""DyMoE serving engine of the port (torch twin of
``repro/serving/engine.py``), in two coupled halves as in the paper's
co-design:

  * **Math** — prefill and chunked decode of the real model through the
    packed mixed-precision weight store, producing exact logits AND DyMoE
    telemetry (Critical masks, active experts, look-ahead predictions).
  * **System** — the :class:`DynamicExpertOrchestrator` replays that
    telemetry against the mixed-precision LRU cache and the edge cost
    model (:class:`EdgeProfile`, an RTX 3090-class card behind PCIe by
    default) to give each request its MODELED edge TTFT / TPOT. These are
    outputs of the cost model, not times of the card that ran the model;
    wall times are measured separately. A non-MoE config (dense or SSM)
    has no experts to cache: its modeled numbers come from the cost model
    alone, as in the JAX engine.

Both halves are served by the step-driven continuous-batching scheduler,
an OPEN session (``serve`` / ``submit`` / ``step`` / ``health``, with
``handle.stream()`` / ``cancel()`` / ``result()``, typed faults and their
recovery ladders, and the SLO policy layer), which submits each admission
wave's and each decode chunk's telemetry replay, right after the
boundary's one host sync, to a :class:`ReplayStream`: by default
(``pipeline=True``) one worker thread replays it while the dispatch
thread runs the next chunk; ``pipeline=False`` replays inline, the serial
mode, with the same tokens and bitwise the same modeled numbers. Its
prefills and decode chunks run through the engine's compiled programs (``serving/compiled.py``):
CUDA graphs, one per key — a prefill per prompt shape, ``cache_slots``
and ``row_local``, as the reference jits it, captured when the key
recurs; a decode chunk per key of decode states the engine owns across
sessions, captured at first use.
``generate`` and ``generate_batch`` are thin wrappers over one session;
:meth:`DyMoEEngine.generate_reference` (prefill, then ``decode_many``
chunks with one shared Critical set a layer, replayed inline) is the
oracle ``generate`` must equal. ``generate_batch(static=True)`` keeps the
lockstep baseline continuous batching is measured against: one
right-aligned batch, ``decode_many`` chunks until every row is done, NaN
modeled numbers. Both run ``decode_many`` through the engine's third
compiled program, a CUDA graph per key on the card.

``EngineConfig(use_dymoe=False)`` serves at full precision (no packed
store; the paper's no-DyMoE baseline), as does a config whose policy is
disabled: the model then runs its float weights.

The engine's compiled programs are not thread-safe, so the engine has one
``lock``: every unit of device work — a prefill through the injection or
readout of its outputs, a decode chunk through its readout — holds it.
Sessions over one engine (the multi-replica tier, ``serving/cluster``)
may then be driven from several threads: their device work serializes,
their host work (the telemetry replay, on each session's worker) does
not.
Requests carry per-request sampling parameters
(temperature / top-k / seed) with counter-derived PRNG streams, so a
request's tokens are the same solo and in a batch. Ablation rows of paper
Table 3 map to :class:`EngineConfig` flags (cache / prefetch / dyquant,
and "4/2" vs "4/0" through the config's policy).

The engine runs on CUDA unless the caller passes ``device="cpu"``; it never
falls back from one to the other.

``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) makes the engine one
rank of an SPMD program: every rank of the mesh builds the same engine and
drives the same calls in the same order. Each rank keeps only its shards
of the params and packed stores (``sharding/partition.py``'s rules;
``expert_parallel=True`` splits the routed experts over E, E/n a rank) and
of every decode state's KV slots and SSM channels or heads
(:meth:`DyMoEEngine.shard_decode_state`);
the model code places the collectives (``sharding/spmd.py``), over each
rank's "model" sub-group: weights are whole across the data axes ("pod",
"data"). A session's slots are split in blocks over the data ranks when
they divide them (``serving/scheduler.py``); every compiled program runs
on a data rank's model sub-group alone (``Mesh.model_view``), over its
block of a session's slots, or whole where a batch is replicated
(``generate``'s one slot, ``generate_reference``, the static baseline).
Over more than one rank the compiled programs run eagerly — gloo's
collectives cannot be captured in a CUDA graph — and ``last_stats``
reports 0 compiles and the mesh's shape; the kernels launch as on one
card. Host decisions that read the clock are rank 0's, broadcast
(``serving/scheduler.py``).
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.orchestrator import DynamicExpertOrchestrator, \
    OrchestratorConfig, StepTiming
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import quantize_model
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile, \
    expert_bytes
from repro_torch.serving.compiled import CompiledDecodeChunk, \
    CompiledDecodeMany, CompiledPrefill
from repro_torch.serving.request import Request, RequestHandle
from repro_torch.serving.sampler import fold_in, raw_key_data, \
    resolve_sampling, sample_token, sample_token_rows

__all__ = ["EngineConfig", "DyMoEEngine", "GenerationResult",
           "ReplayStream"]


class ReplayStream:
    """FIFO stream of host-side telemetry-replay jobs.

    The pipelined session submits one job a wave and a chunk, after the
    boundary's host sync, and ONE worker thread runs them in submission
    order while the next chunk runs on the card. One worker and FIFO order
    are load-bearing: the shared orchestrator advances a modeled clock and
    an LRU cache, so replays must run in the serial order for the modeled
    TTFT/TPOT to stay bitwise those of ``pipelined=False``. A job holds
    only finished host memory (numpy arrays and pinned host copies the
    boundary's sync completed); the worker never touches the device.

    ``pipelined=False`` runs every job inline at :meth:`submit` (the
    serial mode). ``maxsize`` bounds the queue, so a slow replay
    backpressures the dispatch thread: :meth:`submit` blocks while the
    queue is full.

    A job that raises POISONS the stream for good: the exception is
    re-raised on the submitting thread at the next :meth:`submit` or
    :meth:`drain`, every job still queued (or submitted later) is skipped,
    and later calls keep failing with a poisoned-stream error.
    """

    _STOP = object()

    def __init__(self, pipelined: bool, maxsize: int = 4):
        self._pipelined = pipelined
        self._exc: Optional[BaseException] = None
        self._poisoned = False   # sticky: survives the _exc hand-off
        if pipelined:
            self._q: _queue.Queue = _queue.Queue(maxsize=max(1, maxsize))
            self._thread = threading.Thread(
                target=self._loop, name="dymoe-replay", daemon=True)
            self._thread.start()

    @property
    def pipelined(self) -> bool:
        return self._pipelined

    @property
    def poisoned(self) -> bool:
        """A job failed: queued and later jobs are skipped and no further
        finalize will run. A waiter that cannot call submit()/drain() (a
        stream consumer that does not drive) polls this to bail out."""
        return self._poisoned or self._exc is not None

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is self._STOP:
                    return
                if not self._poisoned:
                    job()
            except BaseException as e:  # noqa: BLE001 — re-raised at submit
                self._poisoned = True
                self._exc = e
            finally:
                self._q.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        self._reraise()
        if not self._pipelined:
            try:
                job()
            except BaseException:
                self._poisoned = True
                raise
            return
        self._q.put(job)

    def drain(self) -> None:
        """Block until every submitted job has run (or been skipped after
        a failure), then surface any worker exception."""
        if self._pipelined:
            self._q.join()
        self._reraise()

    def close(self) -> None:
        """Stop the worker once the jobs queued before it have run (or
        been skipped); a no-op inline or when already closed."""
        if self._pipelined and self._thread.is_alive():
            self._q.put(self._STOP)
            self._thread.join()

    def _reraise(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        if self._poisoned:
            raise RuntimeError(
                "ReplayStream is poisoned by an earlier job failure; its "
                "orchestrator state is not trustworthy")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    profile: EdgeProfile = dataclasses.field(default_factory=EdgeProfile)
    use_dymoe: bool = True          # quantized mixed-precision execution
    #                                 (False: full precision, no store)
    enable_cache: bool = True       # ablation rows 1 vs 2
    enable_prefetch: bool = True    # rows 2 vs 3
    enable_dyquant: bool = True     # rows 3 vs 4 (False: all-high requests)
    max_cache_fraction: float = 0.6  # fraction of VRAM granted to experts
    decode_chunk: int = 16          # decode steps per chunk (one host sync)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    ttft_s: float                   # modeled edge TTFT (EngineConfig.profile)
    tpot_s: float                   # modeled edge per-token latency
    # SERVICE wall time: admission -> last token on host (queue wait
    # split out)
    wall_s: float
    queue_wait_s: Optional[float] = None   # submission -> admission
    # first token on host -> last token on host
    decode_wall_s: Optional[float] = None
    prefill_timing: Optional[StepTiming] = None
    decode_timings: Optional[List[StepTiming]] = None
    cache_stats: Optional[Dict] = None
    # packed expert-weight bytes the grouped quant-matmul read
    prefill_weight_bytes: Optional[int] = None
    decode_weight_bytes_per_tok: Optional[float] = None
    # the request was cancelled mid-flight: ``tokens`` is the partial
    # output up to the chunk boundary where its slot was freed
    cancelled: bool = False
    # the cancellation was forced by the request's wall-clock
    # ``deadline_s`` expiring in flight
    deadline_expired: bool = False
    # times an SLO policy preempted this request at a chunk boundary
    # before it completed (each re-prefilled it on resume; tokens are
    # identical, queue_wait/TTFT accounting restarts at the final
    # admission)
    preempted: int = 0


def to_device(tree, device: torch.device):
    """Move a parameter / quantized-store tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, MixedPrecisionWeights):
        return MixedPrecisionWeights(high=to_device(tree.high, device),
                                     low=to_device(tree.low, device))
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, packed=tree.packed.to(device),
                                   scales=tree.scales.to(device))
    if tree is None:
        return None
    return tree.to(device)


class DyMoEEngine:
    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(), faults=None, *,
                 device=None, qparams=None, mesh=None,
                 expert_parallel: bool = False):
        # ``faults``: optional repro_torch.serving.faults.FaultInjector
        # threaded through the serving hot path (the scheduler's dispatch,
        # admission, replay, preemption and rung sites and the expert
        # cache's blob loads). None = every site is a no-op.
        # ``qparams``: reuse an already-quantized packed store (a sibling
        # engine's) instead of quantizing again; ignored (and none made)
        # with ``use_dymoe=False``.
        # ``mesh`` / ``expert_parallel``: serve as one rank of the mesh
        # (module docstring). ``params`` / ``qparams`` may be whole (this
        # rank keeps its shards of them) or this rank's shards already
        # (``models.model.init_sharded``).
        assert engine_cfg.decode_chunk >= 1, engine_cfg.decode_chunk
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.faults = faults
        self.mesh = mesh
        self.expert_parallel = expert_parallel
        if mesh is not None:
            params, qparams = self._shard(params, qparams)
        self.params = to_device(params, self.device)
        if not engine_cfg.use_dymoe:
            self.qparams = None
        elif qparams is not None:
            self.qparams = to_device(qparams, self.device)
        else:
            self.qparams = quantize_model(self.params, cfg)
        self.cost = EdgeCostModel(cfg, engine_cfg.profile)
        # held over every unit of device work (see the module docstring)
        self.lock = threading.RLock()
        # every prefill, compiled (the JAX engine's jax.jit of prefill):
        # one CUDA graph per prompt shape, cache_slots and row_local,
        # captured at the key's second call, its outputs in a pool of the
        # prefill graphs' own
        self._prefill = CompiledPrefill(self)
        # the batched decode chunk, compiled (the JAX engine's jax.jit of
        # decode_many_batched): one CUDA graph per key, replayed from the
        # engine-owned decode states
        self._decode_batched = CompiledDecodeChunk(self)
        # decode_many, compiled (the JAX engine's jax.jit of decode_many):
        # one CUDA graph per key, replayed from engine-owned decode states
        # that each call copies its prefill's caches into
        self._decode_many = CompiledDecodeMany(self)
        # the last batch call's counts (ContinuousBatchingScheduler.stats):
        # chunks, decode steps, batched and solo admission waves, replay
        # jobs and their own host seconds (on whichever thread ran them),
        # the dispatch thread's seconds blocked on a full replay queue,
        # compiled-chunk and prefill compiles
        self.last_stats: dict = {}
        self._session = None   # the engine-owned open serving session

    # ------------------------------------------------------------ system
    def _shard(self, params, qparams):
        """This rank's shards of ``params`` and of ``qparams`` (the packed
        store quantized from the whole weights first, as the JAX package
        quantizes before it places)."""
        from repro_torch.models.model import _check_mesh
        from repro_torch.sharding.partition import Shard, param_shardings, \
            shard_tree
        from repro_torch.tree import tree_leaves

        _check_mesh(self.cfg, self.mesh)
        if qparams is None and self.ecfg.use_dymoe:
            if any(isinstance(w, Shard) for w in tree_leaves(params)):
                raise ValueError("sharded params need their sharded "
                                 "qparams (models.model.init_sharded)")
            qparams = quantize_model(params, self.cfg)

        def place(tree):
            specs = param_shardings(tree, self.mesh,
                                    expert_parallel=self.expert_parallel)
            return shard_tree(tree, specs, self.mesh, self.device)

        return place(params), (None if qparams is None else place(qparams))

    @property
    def eager(self) -> bool:
        """Whether the compiled programs run eagerly: over a mesh of more
        than one rank (its collectives cannot be captured)."""
        return self.mesh is not None and self.mesh.distributed

    def shard_decode_state(self, caches):
        """Lay a decode-state tree of whole caches out on the engine's
        mesh (``cache_shardings``: KV slots and the SSM states' channels or
        heads split over "model", batch over ("pod", "data") where the
        data ranks divide it): this rank keeps its block of rows, slots,
        channels and heads. Identity on an unsharded engine. The
        engine's own decode states are allocated so directly
        (``init_decode_state(..., mesh=)`` with a session's block of
        slots)."""
        if self.mesh is None:
            return caches
        from repro_torch.sharding.partition import cache_shardings, \
            shard_tree
        return shard_tree(caches, cache_shardings(caches, self.mesh),
                          self.mesh)

    def _make_orchestrator(self) -> Optional[DynamicExpertOrchestrator]:
        """The expert cache and clock of one session; None for a non-MoE
        config (no experts to cache: its replay is the cost model alone)."""
        cfg, e = self.cfg, self.ecfg
        if not cfg.is_moe:
            return None
        pol = cfg.dymoe
        budget = int(e.profile.vram_bytes * e.max_cache_fraction)
        return DynamicExpertOrchestrator(OrchestratorConfig(
            num_layers=cfg.num_layers,
            num_experts=cfg.num_experts,
            experts_per_token=cfg.num_experts_per_tok,
            bytes_high=expert_bytes(cfg, pol.high_bits),
            bytes_low=(expert_bytes(cfg, pol.low_bits)
                       if pol.low_bits else 0),
            vram_budget_bytes=budget,
            pcie_bw=e.profile.pcie_bw,
            low_is_skip=pol.low_bits == 0,
            enable_cache=e.enable_cache,
            enable_prefetch=e.enable_prefetch,
            enable_dyquant=e.enable_dyquant,
            prefetch_topk=pol.prefetch_topk,
        ), faults=self.faults)

    def _expert_counts(self, crit: np.ndarray, active: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(…, L, E) masks -> (…, L) active hi / lo expert counts."""
        n_active = active.sum(axis=-1)
        n_hi = (active & crit).sum(axis=-1)
        n_lo = n_active - n_hi
        if self.cfg.dymoe.low_bits == 0:
            n_lo = np.zeros_like(n_lo)
        return n_hi, n_lo

    def _replay(self, crit, active, pred, *, phase: str, s_ctx, s_q: int,
                orch: Optional[DynamicExpertOrchestrator]
                ) -> Tuple[List[StepTiming], List[float], int]:
        """Replay a block of host-side telemetry through the orchestrator.

        ``crit`` / ``active`` / ``pred`` are the (T, L, E) stacked numpy
        masks and predictions (T = 1 for prefill; (L, E) inputs are
        promoted); ``s_ctx`` is the per-step context length, shape (T,).
        Returns (timings, per-step modeled seconds, weight_bytes) where
        ``weight_bytes`` is the packed expert-weight traffic of the block:
        per layer and step, each active Critical expert moves its high-bit
        blob, each active Sub-critical one its low-bit blob (zero in the
        "x/0" skip deployment). The cost model broadcasts over (T, L) and
        the orchestrator consumes the block via ``step_batch``. Without an
        orchestrator or telemetry (a non-MoE config) the block is priced by
        the cost model alone: no timings, no weight bytes."""
        cfg = self.cfg
        s_ctx = np.asarray(s_ctx)
        t = s_ctx.shape[0]
        if orch is None or crit is None:
            per_layer = self.cost.layer_compute_s(
                phase=phase, s_ctx=s_ctx[:, None], s_q=s_q,
                tokens_routed=s_q)                        # (T, 1)
            totals = np.broadcast_to(
                per_layer, (t, cfg.num_layers)).sum(axis=1)
            return [], [float(x) for x in totals], 0
        crit = np.asarray(crit, bool).reshape(t, cfg.num_layers, -1)
        active = np.asarray(active, bool).reshape(crit.shape)
        pred = np.asarray(pred).reshape(crit.shape)
        # price compute/bytes with the same (possibly degraded) precision
        # mix the orchestrator's cache walk will use
        dcrit, dactive = ((crit, active) if orch.degrade is None
                          else orch.degrade.apply(crit, active))
        n_hi, n_lo = self._expert_counts(dcrit, dactive)  # (T, L)
        wbytes = int(self.cost.moe_weight_bytes(n_hi, n_lo).sum())
        compute = self.cost.layer_compute_s(
            phase=phase, s_ctx=s_ctx[:, None], s_q=s_q,
            active_experts_hi=n_hi, active_experts_lo=n_lo,
            tokens_routed=s_q)                            # (T, L)
        timings = orch.step_batch(crit, active, pred, compute)
        return timings, [x.total_s for x in timings], wbytes

    # ------------------------------------------------- step-driven API
    def serve(self, num_slots: Optional[int] = None, *,
              pipeline: Optional[bool] = None,
              slots_len: Optional[int] = None,
              max_queue: Optional[int] = None, policy=None):
        """Open (and remember) a step-driven serving session — the open
        counterpart of ``generate_batch`` — and return it;
        :meth:`submit` / :meth:`step` / :meth:`health` delegate to it.

        ``pipeline`` replays telemetry on the session's worker thread
        (default: ``SchedulerConfig.pipeline``, True); False replays it
        inline. ``num_slots`` device slots (default 4); ``slots_len`` the per-slot
        cache length (default the config's sliding window, else
        ``cfg.max_seq_len``; rounded up to a power of two, but never above
        the window), which a request's ``prompt_len + max_new_tokens``
        must fit unless a window's ring serves any length; ``max_queue`` bounds the admission queue (a submit beyond it
        raises a typed ``QueueFull``; None = unbounded); ``policy`` is
        ``"fifo"`` (default), ``"edf"`` or a ``SchedulingPolicy``
        (:mod:`repro_torch.serving.policy`).

        An open engine-owned session is retired first: its submitted
        replay jobs run, its worker stops, its handles still queued or in
        flight resolve with a typed ``SessionClosed`` and its decode state
        goes back to the engine — drain it yourself before re-serving if
        you want their results."""
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler

        if self._session is not None and not self._session.closed:
            self._session.flush()
            self._session.close()
        session = ContinuousBatchingScheduler(self, num_slots=num_slots)
        session._ensure_started(slots_len=slots_len, pipeline=pipeline,
                                max_queue=max_queue, policy=policy)
        self._session = session
        return session

    def submit(self, request: Request, rng_key=None) -> RequestHandle:
        """Queue ``request`` on the engine's serving session (opened with
        defaults if :meth:`serve` wasn't called) for admission at the next
        chunk boundary; returns its :class:`RequestHandle`."""
        if self._session is None or self._session.closed:
            self.serve()
        return self._session.submit(request, rng_key=rng_key)

    def step(self) -> bool:
        """Advance the engine's serving session by one chunk boundary.
        Returns True while there is live or queued work."""
        if self._session is None:
            raise RuntimeError(
                "no serving session is open: call serve() or submit() first")
        return self._session.step()

    def health(self):
        """Fault-tolerance snapshot of the engine's serving session
        (``status="ok"`` with zeroed counters when none was opened)."""
        from repro_torch.serving.faults import SessionHealth

        if self._session is None:
            return SessionHealth(status="ok")
        return self._session.health()

    # -------------------------------------------------------------- API
    def generate(self, request: Request, rng_key=None) -> GenerationResult:
        """Serve one request through a fresh single-slot session with
        inline replay (serial, as the reference's ``generate``); its
        admission is the solo prefill. Its tokens equal its row in a
        ``generate_batch``."""
        return self._run([request], num_slots=1, rng_keys=[rng_key],
                         pipeline=False)[0]

    def generate_reference(self, request: Request, rng_key=None
                           ) -> GenerationResult:
        """Single-request REFERENCE path (no scheduler): the solo prefill,
        then ``decode_chunk``-sized :func:`decode_many` chunks (one shared
        Critical set a layer, K2 on the card), both through the engine's
        compiled programs, with inline telemetry replay. Token i's PRNG key
        is ``fold_in(rng_key, i)``, so outputs are chunking-invariant. The
        oracle :meth:`generate` must equal, tokens and modeled numbers."""
        from repro_torch.serving.scheduler import _d2h_async, _numpy

        cfg, dev = self.cfg, self.device
        temperature, top_k, rng_key = resolve_sampling(
            request, rng_key, context="generate")
        sampling = temperature > 0.0
        s = request.prompt_len
        slots = cfg.sliding_window or (s + request.max_new_tokens)
        orch = self._make_orchestrator()
        eos = request.eos_token
        t0 = time.perf_counter()
        with self.lock:
            # the prefill's outputs are the compiled prefill's, which its
            # next call overwrites: the caches go into a decode state this
            # call holds before the lock is let go
            out = self._prefill(np.asarray([request.prompt_tokens],
                                           np.int64), cache_slots=slots)
            info = out.info
            tele = _d2h_async((info.critical_masks, info.active_masks,
                               info.predicted_next))
            tok = sample_token(
                out.logits,
                fold_in(torch.as_tensor(rng_key).to(dev), 0) if sampling
                else None, temperature=temperature, top_k=top_k)
            state = self._decode_many.acquire(1, slots, caches=out.caches)
            tokens: List[int] = [int(tok[0])]   # host sync: prefill done
        try:
            pre_timings, pre_totals, pre_wbytes = self._replay(
                *_numpy(tele), phase="prefill", s_ctx=np.asarray([s]),
                s_q=s, orch=orch)
            pre_t = pre_timings[0] if pre_timings else None
            t_dec = time.perf_counter()   # decode wall: after the replay
            decode_timings: List[StepTiming] = []
            tpot_total = 0.0
            dec_wbytes = 0
            done = eos is not None and tokens[0] == eos
            total_steps = request.max_new_tokens - 1
            n_done = 0  # decode steps completed (== tokens sampled - 1)
            key = raw_key_data(rng_key) if sampling else None
            while n_done < total_steps and not done:
                chunk = min(self.ecfg.decode_chunk, total_steps - n_done)
                with self.lock:
                    o = self._decode_many(
                        state, tok, num_steps=chunk, start_step=n_done + 1,
                        rng_key=key, temperature=temperature, top_k=top_k)
                    tok = o.tokens[-1].clone()
                    # the chunk's ONE host sync: the telemetry copies are
                    # queued first, so the tokens' fetch completes them
                    crit, act, pred = _numpy(_d2h_async(
                        (o.info.critical_masks, o.info.active_masks,
                         o.info.predicted_next)))
                    new = [int(t) for t in o.tokens[:, 0].cpu()]
                keep = chunk
                if eos is not None and eos in new:
                    keep = new.index(eos) + 1
                    done = True
                if crit is not None:
                    crit, act, pred = crit[:keep], act[:keep], pred[:keep]
                timings, totals, wbytes = self._replay(
                    crit, act, pred, phase="decode",
                    s_ctx=s + n_done + 1 + np.arange(keep), s_q=1,
                    orch=orch)
                decode_timings.extend(timings)
                for x in totals:   # per-step adds: equal to decode_chunk=1
                    tpot_total += x
                dec_wbytes += wbytes
                tokens.extend(new[:keep])
                n_done += keep
        finally:
            with self.lock:
                self._decode_many.release(state)
        t_end = time.perf_counter()
        n_dec = max(len(tokens) - 1, 1)
        return GenerationResult(
            tokens=tokens,
            ttft_s=float(pre_t.total_s if pre_t is not None
                         else pre_totals[0]),
            tpot_s=float(tpot_total / n_dec), wall_s=t_end - t0,
            decode_wall_s=t_end - t_dec, prefill_timing=pre_t,
            decode_timings=decode_timings or None,
            cache_stats=(dataclasses.asdict(orch.cache.stats)
                         if orch else None),
            prefill_weight_bytes=pre_wbytes if pre_t is not None else None,
            decode_weight_bytes_per_tok=(
                dec_wbytes / n_dec if decode_timings else None))

    def generate_batch(self, requests: Sequence[Request], rng_key=None, *,
                       num_slots: Optional[int] = None,
                       static: bool = False,
                       pipeline: Optional[bool] = None,
                       ) -> List[GenerationResult]:
        """Continuous batching over ``num_slots`` device slots (default
        min(len(requests), 4)): ragged prompts, per-request
        ``max_new_tokens`` / ``eos_token`` / sampling parameters, eviction
        and admission at every chunk boundary, real per-request modeled
        TTFT/TPOT. Results come back in submission order.

        ``pipeline`` replays the telemetry on the session's worker thread
        while the next chunk runs (default: ``SchedulerConfig.pipeline``,
        True); ``pipeline=False`` is the serial mode, with the same tokens
        and bitwise the same modeled numbers.

        ``static=True`` is the lockstep baseline instead: one batch for
        the whole call (ragged prompts right-aligned), decode until every
        row is done, telemetry discarded (NaN modeled numbers); sampled
        rows draw from their own streams, so in the row-independent
        full-precision regime each row equals its solo run.

        ``rng_key`` is an optional shared PRNG
        root for requests WITHOUT a seed: request i's stream root becomes
        ``fold_in(rng_key, i)`` (a request's own seed wins)."""
        rng_keys = None
        if rng_key is not None:
            rng_keys = [None if r.seed is not None else fold_in(rng_key, i)
                        for i, r in enumerate(requests)]
        if static:
            return self._generate_batch_static(requests, rng_keys=rng_keys)
        return self._run(requests, num_slots=num_slots, rng_keys=rng_keys,
                         pipeline=pipeline)

    def _generate_batch_static(self, requests: Sequence[Request], *,
                               rng_keys: Optional[Sequence] = None
                               ) -> List[GenerationResult]:
        """The lockstep baseline: every request holds a row for the whole
        call; ragged prompts are right-aligned into one padded batch (one
        prefill with per-row offsets), and rows that finish early keep
        decoding until the whole batch is done. Per-row done state is
        tracked from each chunk's new tokens only."""
        from repro_torch.serving.scheduler import _h2d

        dev = self.device
        b = len(requests)
        temps = np.zeros(b, np.float32)
        topks = np.zeros(b, np.int64)
        keys = np.zeros((b, 2), np.int64)
        for i, r in enumerate(requests):
            t, k, key = resolve_sampling(
                r, rng_keys[i] if rng_keys is not None else None,
                context=f"generate_batch(static=True) request {i}")
            temps[i], topks[i] = t, k
            if t > 0.0:
                keys[i] = raw_key_data(key)
        any_sampling = bool((temps > 0).any())
        lens = [len(r.prompt_tokens) for r in requests]
        s = max(lens)
        ragged = len(set(lens)) > 1
        prompts = np.zeros((b, s), np.int64)
        for i, r in enumerate(requests):
            prompts[i, s - lens[i]:] = r.prompt_tokens   # right-aligned
        limits = [r.max_new_tokens for r in requests]
        eos = [r.eos_token for r in requests]
        max_new = max(limits)
        slots = self.cfg.sliding_window or (s + max_new)
        t0 = time.perf_counter()
        with self.lock:
            out = self._prefill(prompts, cache_slots=slots,
                                lengths=np.asarray(lens, np.int32)
                                if ragged else None)
            if any_sampling:
                tok = sample_token_rows(
                    out.logits, fold_in(_h2d(keys, dev), 0),
                    _h2d(temps, dev), _h2d(topks, dev))
            else:
                tok = sample_token(out.logits)
            state = self._decode_many.acquire(b, slots, caches=out.caches)
            rows = [[int(t)] for t in tok.cpu()]
        done = [len(rows[i]) >= limits[i]
                or (eos[i] is not None and rows[i][0] == eos[i])
                for i in range(b)]
        remaining = b - sum(done)
        row_kw = {}
        if any_sampling:   # per-row mode: step i folds row r's key with i
            row_kw = dict(row_keys=keys, row_temperatures=temps,
                          row_top_ks=topks)
        n_done = 1  # tokens sampled per row so far
        try:
            while n_done < max_new and remaining:
                chunk = min(self.ecfg.decode_chunk, max_new - n_done)
                with self.lock:
                    o = self._decode_many(state, tok, num_steps=chunk,
                                          start_step=n_done, **row_kw)
                    tok = o.tokens[-1].clone()
                    toks_np = o.tokens.cpu().numpy()   # one sync a chunk
                for i in range(b):
                    new = [int(t) for t in toks_np[:, i]]
                    rows[i].extend(new)
                    if not done[i]:
                        hit_eos = eos[i] is not None and any(
                            t == eos[i] for t in new[:limits[i] - n_done])
                        if hit_eos or len(rows[i]) >= limits[i]:
                            done[i] = True
                            remaining -= 1
                n_done += chunk
        finally:
            with self.lock:
                self._decode_many.release(state)
        wall = time.perf_counter() - t0
        results = []
        for i, row in enumerate(rows):
            row = row[:limits[i]]
            if eos[i] is not None and eos[i] in row:
                row = row[:row.index(eos[i]) + 1]
            results.append(GenerationResult(
                tokens=row, ttft_s=float("nan"), tpot_s=float("nan"),
                wall_s=wall))
        return results

    def _run(self, requests, num_slots, rng_keys, pipeline):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        session = ContinuousBatchingScheduler(self, num_slots=num_slots)
        out = session.run(requests, rng_keys=rng_keys, pipeline=pipeline)
        self.last_stats = dict(session.stats)
        if self.mesh is not None:
            self.last_stats["mesh"] = dict(self.mesh.shape)
        return out
