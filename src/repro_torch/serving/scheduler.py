"""Continuous-batching scheduler: the FIFO, serial core of
``repro/serving/scheduler.py`` (greedy; no replay stream, policy, faults,
sampling, streaming or cancellation yet).

A session serves requests through a fixed batch of device slots:

    handle = session.submit(request)   # FIFO-queued
    session.step()                     # one chunk boundary:
                                       #   1. admission wave(s) into free
                                       #      slots (one ragged row-local
                                       #      prefill per wave of >1
                                       #      request; the solo prefill for
                                       #      a wave of one)
                                       #   2. one decode chunk of
                                       #      ``decode_chunk`` steps over
                                       #      every slot
                                       #   3. ONE host sync: done/emitted
                                       #      masks and the chunk's tokens;
                                       #      finished rows are evicted
    handle.result()                    # GenerationResult

Admitted rows are LEFT-ALIGNED into their slots, so an injected row is
laid out exactly as a solo admission would have been. Rows are
independent programs (row-local Critical sets), so a request's greedy
tokens do not depend on its neighbours.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.kv_cache import KVCache
from repro_torch.models.layers.moe import _capacity
from repro_torch.models.model import decode_many_batched, \
    init_decode_state, prefill
from repro_torch.serving.request import Request, RequestHandle

__all__ = ["ContinuousBatchingScheduler", "live_cap_for"]

DEFAULT_SLOTS = 4     # device slots when neither caller nor run() sets them


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


@dataclasses.dataclass
class _SlotState:
    handle: RequestHandle
    request: Request
    tokens: List[int]
    prompt_len: int
    admit_t: float                # perf_counter at admission
    queue_wait_s: float           # submission -> admission
    decode_t0: float = 0.0        # decode-wall clock start


class ContinuousBatchingScheduler:
    """Serve a stream of requests through ``num_slots`` device slots on
    top of a :class:`~repro_torch.serving.engine.DyMoEEngine`. One
    instance is one session; state is allocated at the first submit.

    ``stats`` counts what the session dispatched: ``chunks``,
    ``decode_steps`` (every step of every chunk), ``waves_batched`` (ragged
    row-local admission prefills of more than one request) and
    ``waves_solo`` (solo admission prefills)."""

    def __init__(self, engine, num_slots: Optional[int] = None):
        self.engine = engine
        self._num_slots = num_slots
        self._started = False
        self._handles: List[RequestHandle] = []
        self._queue: Deque[RequestHandle] = deque()
        self.stats = dict(chunks=0, decode_steps=0, waves_batched=0,
                          waves_solo=0)

    def _ensure_started(self, *, num_slots: Optional[int] = None,
                        slots_len: Optional[int] = None) -> None:
        if self._started:
            return
        engine, cfg = self.engine, self.engine.cfg
        self._b = max(1, num_slots or self._num_slots or DEFAULT_SLOTS)
        self._slots_len = slots_len or cfg.max_seq_len
        self._chunk = engine.ecfg.decode_chunk
        dev = engine.device
        b = self._b
        self._states: List[Optional[_SlotState]] = [None] * b
        self._caches = init_decode_state(cfg, b, self._slots_len, dev)
        self._tok_d = torch.zeros(b, dtype=torch.int32, device=dev)
        self._done = np.ones(b, bool)          # empty slots stay frozen
        self._emitted = np.zeros(b, np.int32)
        self._limits = np.zeros(b, np.int32)
        self._eos = np.full(b, -1, np.int32)
        self._started = True

    # ------------------------------------------------------------ submit
    def submit(self, request: Request) -> RequestHandle:
        self._ensure_started()
        need = request.prompt_len + request.max_new_tokens
        if need > self._slots_len:
            raise ValueError(
                f"request needs {need} cache slots (prompt "
                f"{request.prompt_len} + max_new {request.max_new_tokens}) "
                f"but the session's slot budget is {self._slots_len}")
        h = RequestHandle(self, len(self._handles), request,
                          time.perf_counter())
        self._handles.append(h)
        self._queue.append(h)
        return h

    def step(self) -> bool:
        """Advance ONE chunk boundary: admit into free slots, then dispatch
        one decode chunk if any row is live. Returns False when idle."""
        if not self._started:
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
            if n > 1:
                smax = max(lens)
                prompts = np.zeros((n, smax), np.int64)
                for i, h in enumerate(cands):   # right-aligned
                    prompts[i, smax - lens[i]:] = h.request.prompt_tokens
                logits, rcaches, _ = prefill(
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
                logits, rcaches, _ = prefill(
                    engine.params, cfg, _h2d(prompt, dev),
                    qparams=engine.qparams, cache_slots=self._slots_len)
                self.stats["waves_solo"] += 1
            # the wave's ONE host sync: every candidate's first token
            first = torch.argmax(logits, dim=-1).cpu().numpy()
            t_dec = time.perf_counter()
            src, toks, surv = [], [], []
            for i, h in enumerate(cands):
                req = h.request
                ft = int(first[i])
                st = _SlotState(handle=h, request=req, tokens=[ft],
                                prompt_len=lens[i], admit_t=now,
                                queue_wait_s=now - h.submit_t,
                                decode_t0=t_dec)
                if req.max_new_tokens <= 1 or (req.eos_token is not None
                                               and ft == req.eos_token):
                    self._finalize(st)
                else:
                    src.append(i)
                    toks.append(ft)
                    surv.append(st)
            if src:
                waves.append((rcaches["layers"], src, toks, surv))
                n_survivors += len(src)
        # survivors claim free slots in pop order
        fi = 0
        for rc, src, toks, sts in waves:
            dst = free[fi:fi + len(src)]
            fi += len(src)
            for st, r in zip(sts, dst):
                self._states[r] = st
                self._done[r] = False
                self._emitted[r] = 1
                self._limits[r] = st.request.max_new_tokens
                self._eos[r] = (-1 if st.request.eos_token is None
                                else st.request.eos_token)
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
        bc = self._caches["layers"]
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
        """One greedy decode chunk over every slot; dead rows are frozen
        on the device and cost no MoE slots. ``live_cap`` sizes each MoE
        precision region to the live-row count, rounded up to a power of
        two. The chunk's only host sync is the fetch, at its end, of the
        done/emitted masks together with its tokens."""
        engine = self.engine
        dev = engine.device
        emitted_before = self._emitted.copy()
        n_live = int((~self._done).sum())
        toks_d, self._caches, _, done_d, emitted_d = decode_many_batched(
            engine.params, engine.cfg, self._tok_d, self._caches,
            num_steps=self._chunk, done=_h2d(self._done, dev),
            n_emitted=_h2d(self._emitted, dev),
            limits=_h2d(self._limits, dev), eos_tokens=_h2d(self._eos, dev),
            qparams=engine.qparams, live_cap=live_cap_for(n_live, self._b))
        self._tok_d = toks_d[-1]
        host = torch.cat([done_d.to(torch.int32)[None], emitted_d[None],
                          toks_d]).cpu().numpy()          # the boundary sync
        self._done = host[0].astype(bool)
        self._emitted = host[1].astype(np.int32)
        toks = host[2:]
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self._chunk
        for r in range(self._b):
            st = self._states[r]
            if st is None:
                continue
            keep = int(self._emitted[r] - emitted_before[r])
            st.tokens.extend(int(t) for t in toks[:keep, r])
            if self._done[r]:
                self._states[r] = None          # evict: free to admit
                self._finalize(st)

    def _finalize(self, st: _SlotState) -> None:
        from repro_torch.serving.engine import GenerationResult

        now = time.perf_counter()
        st.handle._finish(GenerationResult(
            tokens=st.tokens, wall_s=now - st.admit_t,
            queue_wait_s=st.queue_wait_s, decode_wall_s=now - st.decode_t0))

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> List:
        """Submit every request, step until idle, return the results in
        submission order."""
        if not requests:
            return []
        b = self._num_slots or min(len(requests), DEFAULT_SLOTS)
        self._ensure_started(
            num_slots=max(1, min(b, len(requests))),
            slots_len=max(r.prompt_len + r.max_new_tokens for r in requests))
        handles = [self.submit(r) for r in requests]
        max_chunks = sum(-(-max(r.max_new_tokens - 1, 0) // self._chunk)
                         for r in requests) + len(requests) + 1
        while self.step():
            assert self.stats["chunks"] <= max_chunks, \
                f"scheduler made no progress after {max_chunks} chunks"
        assert all(h.done for h in handles)
        return [h.result() for h in handles]
