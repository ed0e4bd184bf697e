"""Typed serving-layer failures (the requeue path's vocabulary): a copy of
``tpudes/serving/errors.py`` (``:1-44``).  A routed member lost is
recoverable (requeue the batch; the results are equal by the coalesce
contract), a study whose program is broken must not burn the retry
budget.
"""

from __future__ import annotations

__all__ = ["MemberLostError", "RetryBudgetError"]


class MemberLostError(RuntimeError):
    """A routed member process is gone or its frame stream is no longer
    trustworthy: EOF/closed pipe (the process died), a
    ``WireFormatError`` (truncated/corrupted/
    mixed-version frame — the stream cannot be resynchronized), or a
    reply timeout (a hung member is indistinguishable from a dead one
    and its late reply would desync the next batch).  Carries the
    member ids so the router can exclude them from future launches."""

    def __init__(self, members, detail: str = ""):
        self.members = tuple(members)
        msg = f"routed member(s) {list(self.members)} lost"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class RetryBudgetError(RuntimeError):
    """A study was requeued past its retry budget; ``__cause__`` chains
    the last transient failure.  Raised through the study's handle —
    the caller decides whether to resubmit."""

    def __init__(self, retries: int, last: BaseException):
        super().__init__(
            f"study failed after {retries} retries "
            f"(last: {type(last).__name__}: {last})"
        )
        self.retries = retries
        self.__cause__ = last
