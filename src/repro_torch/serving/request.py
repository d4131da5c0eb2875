"""Serving request record, its sampling parameters and the request handle
(torch port of ``repro/serving/request.py``; priorities, deadlines,
streaming and cancellation are not ported yet).

``SamplingParams`` is validated at construction: a malformed request
fails at submission, never mid-chunk inside the scheduler where it would
poison a whole slot batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

__all__ = ["Request", "RequestHandle", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` is greedy. ``temperature > 0`` draws from the
    (optionally top-k truncated) categorical; the PRNG stream is derived
    from ``seed`` (``fold_in(PRNGKey(seed), token_index)``), which makes
    sampled tokens equal between solo ``generate`` and continuous
    batching, and invariant to ``decode_chunk`` and admission order.
    ``temperature > 0`` without a seed (or an explicit ``rng_key``) falls
    back to greedy with a warning.
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None

    def __post_init__(self):
        # `not >= 0` (instead of `< 0`) also rejects NaN
        if not (self.temperature >= 0.0) or math.isinf(self.temperature):
            raise ValueError(
                f"SamplingParams.temperature must be a finite float >= 0, "
                f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(
                f"SamplingParams.top_k must be >= 0, got {self.top_k}")


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_token: Optional[int] = None   # stop (inclusive) when emitted
    request_id: Optional[str] = None
    seed: Optional[int] = None        # per-request PRNG stream root
    # a construction convenience, not a stored field (InitVar): when given
    # it overwrites temperature/top_k/seed, which stay the single source of
    # truth; read the validated bundle back via ``sampling_params``
    sampling: dataclasses.InitVar[Optional[SamplingParams]] = None

    def __post_init__(self, sampling: Optional[SamplingParams]):
        # fail at submission, not mid-chunk inside the scheduler
        if len(self.prompt_tokens) == 0:
            raise ValueError("Request.prompt_tokens must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(f"Request.max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        if sampling is not None:
            self.temperature = sampling.temperature
            self.top_k = sampling.top_k
            self.seed = sampling.seed
        # validate (constructing SamplingParams raises on bad values)
        SamplingParams(temperature=self.temperature, top_k=self.top_k,
                       seed=self.seed)

    @property
    def sampling_params(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, seed=self.seed)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


class RequestHandle:
    """Live view of one submitted request; :meth:`result` drives the
    session's ``step()`` until the request finalizes."""

    def __init__(self, session, index: int, request: Request,
                 submit_t: float):
        self._session = session
        self.index = index
        self.request = request
        self.request_id = request.request_id or f"req-{index}"
        self.submit_t = submit_t
        # effective sampling state, resolved at submission (greedy
        # fallback applied); key is host uint32[2] or None
        self.temperature = 0.0
        self.top_k = 0
        self.key = None
        self._result = None

    @property
    def done(self) -> bool:
        return self._result is not None

    def _finish(self, result) -> None:
        self._result = result

    def result(self):
        while self._result is None:
            if not self._session.step():
                raise RuntimeError(f"{self.request_id} cannot make progress:"
                                   " the session is idle but the request "
                                   "never finalized")
        return self._result
