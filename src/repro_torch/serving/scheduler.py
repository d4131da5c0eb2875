"""Continuous-batching scheduler: the FIFO core of
``repro/serving/scheduler.py`` with per-row sampling and the telemetry
replay (policy, faults, streaming and cancellation are not ported yet).

A session serves requests through a fixed batch of device slots:

    handle = session.submit(request)   # FIFO-queued
    session.step()                     # one chunk boundary:
                                       #   1. admission wave(s) into free
                                       #      slots (one ragged row-local
                                       #      prefill per wave of >1
                                       #      request; the solo prefill for
                                       #      a wave of one), each with ONE
                                       #      host sync for its first
                                       #      tokens, then its replay
                                       #   2. one decode chunk of
                                       #      ``decode_chunk`` steps over
                                       #      every slot (the engine's
                                       #      compiled chunk: a CUDA graph
                                       #      replay on the card)
                                       #   3. ONE host sync: done/emitted
                                       #      masks and the chunk's tokens;
                                       #      finished rows are evicted,
                                       #      then the chunk's replay
    handle.result()                    # GenerationResult

**Telemetry to the host without another sync.** A chunk's (T, L, B, E)
Critical / active masks and look-ahead predictions (and a wave's) are
copied to pinned host buffers with ``non_blocking`` copies queued on the
stream BEFORE the boundary's one blocking fetch, so that fetch's stream
sync also completes them. The replay, run after the fetch, reads
finished host memory.

**Replay** runs inline on the dispatch thread, wave by wave and chunk by
chunk, through ONE shared orchestrator per session (requests share the
edge device's expert cache, as they would share its VRAM). A request's
``GenerationResult`` is finalized by the replay of its last telemetry;
its wall clocks stop at the host sync that fetched its last token.

**Decode state.** The slot batch's KV caches belong to the engine, because
the compiled chunk's graphs bind their addresses: a session holds one of
the engine's decode states from its start to :meth:`close` (``slots_len``
rounded up to a power of two, so later sessions find it again), reset at
the start; admission writes rows into it in place. The chunk's outputs are fixed buffers that the next
chunk overwrites, so the session copies the last tokens into its own
``_tok_d`` and queues the telemetry copies before the next dispatch.

Admitted rows are LEFT-ALIGNED into their slots, so an injected row is
laid out exactly as a solo admission would have been. Rows are
independent programs (row-local Critical sets, per-row PRNG streams
indexed by the request's own token position), so a request's tokens do
not depend on its neighbours, the chunk length or its slot.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.orchestrator import StepTiming
from repro_torch.models.kv_cache import KVCache
from repro_torch.models.layers.moe import _capacity
from repro_torch.models.model import prefill
from repro_torch.serving.compiled import slot_bucket
from repro_torch.serving.request import Request, RequestHandle
from repro_torch.serving.sampler import fold_in, raw_key_data, \
    resolve_sampling, sample_token_rows

__all__ = ["ContinuousBatchingScheduler", "live_cap_for"]

DEFAULT_SLOTS = 4   # device slots when neither caller sets them


def live_cap_for(n_live: int, slots: int) -> int:
    """The static-capacity ladder: a power of two >= ``n_live``, clamped
    to ``slots`` — at most log2(slots) + 1 distinct MoE region sizes."""
    return min(slots, 1 << max(0, n_live - 1).bit_length())


def _h2d(a, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a stream sync (pinned,
    non-blocking copy on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _d2h_async(tensors):
    """Queue copies of device tensors into pinned host memory; they are
    complete once a later blocking fetch on the same stream returns (on
    the CPU, plain copies: the compiled chunk's outputs are overwritten by
    the next chunk)."""
    return tuple(x.to("cpu", non_blocking=True, copy=True) for x in tensors)


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one admitted request; the replay of its
    last telemetry finalizes it."""

    handle: RequestHandle
    request: Request
    tokens: List[int]
    prompt_len: int
    admit_t: float                # perf_counter at admission
    queue_wait_s: float           # submission -> admission
    finish_now: bool = False      # one-token request: finalize at prefill
    decode_t0: float = 0.0        # first token on host
    end_t: float = 0.0            # last token on host
    ttft_s: float = 0.0           # set by the prefill replay
    prefill_timing: Optional[StepTiming] = None
    prefill_weight_bytes: int = 0
    step_totals: List[float] = dataclasses.field(default_factory=list)
    decode_timings: List[StepTiming] = dataclasses.field(
        default_factory=list)
    decode_weight_bytes: int = 0


class ContinuousBatchingScheduler:
    """Serve a stream of requests through ``num_slots`` device slots on
    top of a :class:`~repro_torch.serving.engine.DyMoEEngine`. One
    instance is one session; its state (slot batch, shared orchestrator)
    is allocated at the first submit, and :meth:`close` (which ``run``
    calls) gives its decode state back to the engine.

    ``stats`` counts what the session dispatched: ``chunks``,
    ``decode_steps`` (every step of every chunk), ``waves_batched`` (ragged
    row-local admission prefills of more than one request),
    ``waves_solo`` (solo admission prefills), ``replay_jobs`` (one per
    wave and per chunk), ``replay_s`` (their summed host seconds), and
    ``compiles`` / ``compile_s`` (compiled-chunk keys first met in this
    session — a CUDA graph capture each on the card — and the seconds
    their warm-up and capture took)."""

    def __init__(self, engine, num_slots: Optional[int] = None):
        self.engine = engine
        self._num_slots = num_slots
        self._started = False
        self.closed = False
        self._handles: List[RequestHandle] = []
        self._queue: Deque[RequestHandle] = deque()
        self.stats = dict(chunks=0, decode_steps=0, waves_batched=0,
                          waves_solo=0, replay_jobs=0, replay_s=0.0,
                          compiles=0, compile_s=0.0)

    def _ensure_started(self, *, num_slots: Optional[int] = None,
                        slots_len: Optional[int] = None) -> None:
        if self._started:
            return
        engine, cfg = self.engine, self.engine.cfg
        self._b = max(1, num_slots or self._num_slots or DEFAULT_SLOTS)
        self._slots_len = slot_bucket(slots_len or cfg.max_seq_len,
                                      cfg.max_seq_len)
        self._chunk = engine.ecfg.decode_chunk
        self._orch = engine._make_orchestrator()  # ONE shared cache+clock
        dev = engine.device
        b = self._b
        self._states: List[Optional[_SlotState]] = [None] * b
        self._state = engine._decode_batched.acquire(b, self._slots_len,
                                                     owner=self)
        self._tok_d = torch.zeros(b, dtype=torch.int32, device=dev)
        self._done = np.ones(b, bool)          # empty slots stay frozen
        self._emitted = np.zeros(b, np.int32)
        self._limits = np.zeros(b, np.int32)
        self._eos = np.full(b, -1, np.int32)
        # per-row sampling state (temperature 0 rows are greedy; the keys
        # of greedy rows are never consumed)
        self._temps = np.zeros(b, np.float32)
        self._topks = np.zeros(b, np.int64)
        self._keys = np.zeros((b, 2), np.int64)
        self._started = True

    # ------------------------------------------------------------ submit
    def submit(self, request: Request, rng_key=None) -> RequestHandle:
        """Queue one request for admission at the next chunk boundary.
        Its PRNG stream root is ``rng_key`` if given, else
        ``PRNGKey(request.seed)``; ``temperature > 0`` with neither falls
        back to greedy with a warning."""
        if self.closed:
            raise RuntimeError("the session is closed")
        self._ensure_started()
        need = request.prompt_len + request.max_new_tokens
        if need > self._slots_len:
            raise ValueError(
                f"request needs {need} cache slots (prompt "
                f"{request.prompt_len} + max_new {request.max_new_tokens}) "
                f"but the session's slot budget is {self._slots_len}")
        h = RequestHandle(self, len(self._handles), request,
                          time.perf_counter())
        temp, top_k, key = resolve_sampling(request, rng_key,
                                            context=h.request_id)
        h.temperature, h.top_k = float(temp), int(top_k)
        h.key = raw_key_data(key) if key is not None else None
        self._handles.append(h)
        self._queue.append(h)
        return h

    def step(self) -> bool:
        """Advance ONE chunk boundary: admit into free slots, then dispatch
        one decode chunk if any row is live. Returns False when idle."""
        if not self._started or self.closed:
            return False
        progress = self._admit_boundary()
        if self._done.all():
            return progress
        self._dispatch_chunk()
        return True

    # --------------------------------------------------------- admission
    def _admit_boundary(self) -> bool:
        """Fill every free slot from the FIFO queue. Up to ``len(free)``
        queued requests prefill together in one wave (one host sync for
        their first tokens); requests that finish at their first token
        free their claim at once, so further waves run until the slots are
        full or the queue drains."""
        engine, cfg = self.engine, self.engine.cfg
        dev = engine.device
        free = [r for r in range(self._b)
                if self._done[r] and self._states[r] is None]
        if not free or not self._queue:
            return False
        n_survivors = 0
        waves = []   # (row caches, src rows, first tokens, states)
        while n_survivors < len(free) and self._queue:
            cands: List[RequestHandle] = []
            while self._queue and len(cands) < len(free) - n_survivors:
                cands.append(self._queue.popleft())
            now = time.perf_counter()
            lens = [h.request.prompt_len for h in cands]
            n = len(cands)
            batched = n > 1
            if batched:
                smax = max(lens)
                prompts = np.zeros((n, smax), np.int64)
                for i, h in enumerate(cands):   # right-aligned
                    prompts[i, smax - lens[i]:] = h.request.prompt_tokens
                logits, rcaches, info = prefill(
                    engine.params, cfg, _h2d(prompts, dev),
                    qparams=engine.qparams, cache_slots=self._slots_len,
                    lengths=_h2d(np.asarray(lens, np.int32), dev),
                    row_local=True,
                    # parity trap — capacities: exact host-side solo values
                    row_capacities=_h2d(np.asarray(
                        [_capacity(cfg, s) for s in lens], np.int64), dev))
                self.stats["waves_batched"] += 1
            else:
                prompt = np.asarray(cands[0].request.prompt_tokens,
                                    np.int64)[None, :]
                logits, rcaches, info = prefill(
                    engine.params, cfg, _h2d(prompt, dev),
                    qparams=engine.qparams, cache_slots=self._slots_len)
                self.stats["waves_solo"] += 1
            tele = _d2h_async((info.critical_masks, info.active_masks,
                               info.predicted_next))
            # the wave's ONE host sync: every candidate's first token.
            # Sampled candidates draw with fold count 0 through the per-row
            # sampler (greedy rows take the same argmax)
            if any(h.temperature > 0.0 for h in cands):
                keys = np.zeros((n, 2), np.int64)
                for i, h in enumerate(cands):
                    if h.key is not None:
                        keys[i] = h.key
                first_d = sample_token_rows(
                    logits, fold_in(_h2d(keys, dev), 0),
                    _h2d(np.asarray([h.temperature for h in cands],
                                    np.float32), dev),
                    _h2d(np.asarray([h.top_k for h in cands], np.int64),
                         dev))
            else:
                first_d = torch.argmax(logits, dim=-1)
            first = first_d.cpu().numpy()
            t_dec = time.perf_counter()
            wave_states, src, toks, surv = [], [], [], []
            for i, h in enumerate(cands):
                req = h.request
                ft = int(first[i])
                st = _SlotState(
                    handle=h, request=req, tokens=[ft], prompt_len=lens[i],
                    admit_t=now, queue_wait_s=now - h.submit_t,
                    finish_now=(req.max_new_tokens <= 1
                                or (req.eos_token is not None
                                    and ft == req.eos_token)),
                    decode_t0=t_dec, end_t=t_dec)
                wave_states.append(st)
                if not st.finish_now:
                    src.append(i)
                    toks.append(ft)
                    surv.append(st)
            self._timed(self._replay_prefill, wave_states, tele, batched)
            if src:
                waves.append((rcaches["layers"], src, toks, surv))
                n_survivors += len(src)
        # survivors claim free slots in pop order
        fi = 0
        for rc, src, toks, sts in waves:
            dst = free[fi:fi + len(src)]
            fi += len(src)
            for st, r in zip(sts, dst):
                h = st.handle
                self._states[r] = st
                self._done[r] = False
                self._emitted[r] = 1
                self._limits[r] = st.request.max_new_tokens
                self._eos[r] = (-1 if st.request.eos_token is None
                                else st.request.eos_token)
                self._temps[r] = h.temperature
                self._topks[r] = h.top_k
                self._keys[r] = h.key if h.key is not None else 0
            dst_d = _h2d(np.asarray(dst, np.int64), dev)
            self._inject_rows(rc, _h2d(np.asarray(src, np.int64), dev),
                              dst_d)
            self._tok_d[dst_d] = _h2d(np.asarray(toks, np.int32), dev)
        return True

    def _inject_rows(self, rc: KVCache, src: torch.Tensor,
                     dst: torch.Tensor) -> None:
        """Overwrite slots ``dst`` of the batch cache with rows ``src`` of
        a freshly prefilled wave cache (leaves (L, B, ...)). A ragged wave
        prefills right-aligned, so row i's KV window sits at slot offset
        ``S_wave - s_i``; each row is LEFT-ALIGNED here (window rolled to
        offset 0, emptied slots zeroed), making the injected row identical
        to a solo admission of the same request, layout included."""
        bc = self._state.caches["layers"]
        pos = rc.positions[:, src]                         # (L, n, S)
        off = rc.offset[:, src].to(torch.int64)            # (L, n)
        s = pos.shape[-1]
        # jnp.roll(x, -off): new[j] = old[(j + off) % S]
        gidx = (torch.arange(s, device=pos.device)[None, None, :]
                + off[..., None]) % s                      # (L, n, S)
        p2 = torch.gather(pos, 2, gidx)
        live = (p2 >= 0)[:, :, None, :, None]              # (L, n, 1, S, 1)
        for name in ("k", "v"):
            t = getattr(rc, name)[:, src]                  # (L, n, H, S, D)
            g = gidx[:, :, None, :, None].expand(t.shape)
            rolled = torch.gather(t, 3, g)
            getattr(bc, name)[:, dst] = torch.where(
                live, rolled, torch.zeros((), dtype=t.dtype,
                                          device=t.device))
        bc.positions[:, dst] = p2
        bc.length[:, dst] = rc.length[:, src]
        bc.offset[:, dst] = torch.zeros((), dtype=bc.offset.dtype,
                                        device=bc.offset.device)

    # ---------------------------------------------------------- dispatch
    def _dispatch_chunk(self) -> None:
        """One decode chunk over every slot; dead rows are frozen on the
        device and cost no MoE slots. ``live_cap`` sizes each MoE
        precision region to the live-row count, rounded up to a power of
        two. A chunk with no live sampled row runs the greedy argmax (no
        vocabulary sort). The chunk's only host sync is the fetch, at its
        end, of the done/emitted masks together with its tokens."""
        compiled = self.engine._decode_batched
        emitted_before = self._emitted.copy()
        live = ~self._done
        sample_kw = {}
        if (self._temps[live] > 0.0).any():
            sample_kw = dict(rng_keys=self._keys, temperatures=self._temps,
                             top_ks=self._topks)
        n_comp, comp_s = compiled.compiles, compiled.compile_s
        out = compiled(
            self._state, self._tok_d, num_steps=self._chunk,
            done=self._done, n_emitted=self._emitted, limits=self._limits,
            eos_tokens=self._eos,
            live_cap=live_cap_for(int(live.sum()), self._b), **sample_kw)
        self.stats["compiles"] += compiled.compiles - n_comp
        self.stats["compile_s"] += compiled.compile_s - comp_s
        # the outputs are fixed buffers the next chunk overwrites: copy
        # what the session keeps, on the stream, before that
        self._tok_d.copy_(out.tokens[-1])
        tele = _d2h_async((out.info.critical_masks, out.info.active_masks,
                           out.info.predicted_next))
        host = torch.cat([out.done.to(torch.int32)[None],
                          out.n_emitted[None], out.tokens]
                         ).cpu().numpy()                  # the boundary sync
        self._done = host[0].astype(bool)
        self._emitted = host[1].astype(np.int32)
        t_sync = time.perf_counter()
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self._chunk
        rows = []
        for r in range(self._b):
            st = self._states[r]
            if st is None:
                continue
            rows.append((r, st, int(self._emitted[r] - emitted_before[r]),
                         st.prompt_len + int(emitted_before[r]),
                         bool(self._done[r])))
            if self._done[r]:
                st.end_t = t_sync
                self._states[r] = None  # evict: free to admit; the replay
                #                         below finalizes st
        self._timed(self._replay_chunk, host[2:], tele, rows)

    def close(self) -> None:
        """End the session: its decode state goes back to the engine for a
        later session. Requests not yet finished stay unfinished."""
        if self._started and not self.closed:
            self.engine._decode_batched.release(self._state)
            self._state = None
        self.closed = True

    # ------------------------------------------------------------ replay
    def _timed(self, replay, *args) -> None:
        t0 = time.perf_counter()
        replay(*args)
        self.stats["replay_jobs"] += 1
        self.stats["replay_s"] += time.perf_counter() - t0

    def _finalize(self, st: _SlotState) -> None:
        # st's last telemetry has just been replayed
        from repro_torch.serving.engine import GenerationResult

        n_dec = max(len(st.tokens) - 1, 1)
        st.handle._finish(GenerationResult(
            tokens=st.tokens,
            ttft_s=float(st.ttft_s),
            tpot_s=float(sum(st.step_totals) / n_dec),
            wall_s=st.end_t - st.admit_t,
            queue_wait_s=st.queue_wait_s,
            decode_wall_s=st.end_t - st.decode_t0,
            prefill_timing=st.prefill_timing,
            decode_timings=st.decode_timings or None,
            cache_stats=dataclasses.asdict(self._orch.cache.stats),
            prefill_weight_bytes=st.prefill_weight_bytes,
            decode_weight_bytes_per_tok=(
                st.decode_weight_bytes / n_dec
                if st.decode_timings else None)))

    def _replay_prefill(self, wave: List[_SlotState], tele, per_row: bool
                        ) -> None:
        """Replay one admission wave's prefill telemetry, candidate by
        candidate in pop order (the serial admission order), and finalize
        the one-token requests."""
        crit, act, pred = (x.numpy() for x in tele)
        for i, st in enumerate(wave):
            if per_row:     # (L, B, E) row-local leaves -> this row
                c, a, p = crit[:, i], act[:, i], pred[:, i]
            else:           # solo admission: (L, E) leaves, B == 1
                c, a, p = crit, act, pred
            timings, _, wbytes = self.engine._replay(
                c, a, p, phase="prefill",
                s_ctx=np.asarray([st.prompt_len]), s_q=st.prompt_len,
                orch=self._orch)
            st.ttft_s = timings[0].total_s
            st.prefill_timing = timings[0]
            st.prefill_weight_bytes = wbytes
            if st.finish_now:
                self._finalize(st)

    def _replay_chunk(self, toks: np.ndarray, tele, rows) -> None:
        """Replay one decode chunk's telemetry row by row and finalize the
        rows it finished."""
        crit, act, pred = (x.numpy() for x in tele)
        for r, st, keep, ctx0, is_done in rows:
            if keep:   # this row's live steps are the chunk's first
                st.tokens.extend(int(t) for t in toks[:keep, r])
                # telemetry leaves are (T, L, B, E): this row's block
                timings, totals, wbytes = self.engine._replay(
                    crit[:keep, :, r], act[:keep, :, r], pred[:keep, :, r],
                    phase="decode", s_ctx=ctx0 + np.arange(keep), s_q=1,
                    orch=self._orch)
                st.step_totals.extend(totals)
                st.decode_timings.extend(timings)
                st.decode_weight_bytes += wbytes
            if is_done:
                self._finalize(st)

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *,
            rng_keys: Optional[Sequence] = None) -> List:
        """Submit every request, step until idle, return the results in
        submission order. ``rng_keys`` optionally gives request i an
        explicit PRNG root (overriding its seed)."""
        if not requests:
            return []
        b = self._num_slots or min(len(requests), DEFAULT_SLOTS)
        self._ensure_started(
            num_slots=max(1, min(b, len(requests))),
            slots_len=max(r.prompt_len + r.max_new_tokens for r in requests))
        handles = [self.submit(r, rng_key=rng_keys[i] if rng_keys else None)
                   for i, r in enumerate(requests)]
        max_chunks = sum(-(-max(r.max_new_tokens - 1, 0) // self._chunk)
                         for r in requests) + len(requests) + 1
        try:
            while self.step():
                assert self.stats["chunks"] <= max_chunks, \
                    f"scheduler made no progress after {max_chunks} chunks"
        finally:
            self.close()
        assert all(h.done for h in handles)
        return [h.result() for h in handles]
