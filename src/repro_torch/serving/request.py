"""Serving request record and the request handle (torch port of
``repro/serving/request.py``, greedy only: sampling, priorities and
deadlines are not ported yet, so a Request has no such fields)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["Request", "RequestHandle"]


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    eos_token: Optional[int] = None   # stop (inclusive) when emitted
    request_id: Optional[str] = None

    def __post_init__(self):
        # fail at submission, not mid-chunk inside the scheduler
        if len(self.prompt_tokens) == 0:
            raise ValueError("Request.prompt_tokens must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(f"Request.max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")

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
