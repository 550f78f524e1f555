"""Cross-process trace context for serving (a copy of
``hetu_tpu/telemetry/tracecontext.py``).

A request that crosses processes keeps one identity: a ``traceparent``
token

    ``<trace_id>-<span_id>``

where ``trace_id`` is the 12-hex request trace id (the id the serving
front end prints in its ``ID <id> <trace_id>`` replies) and ``span_id``
is an 8-hex parent-span id minted per hop. The token rides in the line
protocol's SUBMIT/GENERATE/PREFILL/EVICT/SWAPWEIGHTS payloads (see
:data:`TRACEPARENT_VERBS`), so every process stamps its requests with
the *originating* trace id.

Stdlib only: ``rpc/`` must stay importable without the compute stack.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from typing import Iterator, Optional, Tuple

__all__ = [
    "TRACEPARENT_VERBS",
    "make_traceparent",
    "parse_traceparent",
    "new_span_id",
    "current_traceparent",
    "use_trace",
]

#: Line-protocol verbs whose payloads carry an optional ``traceparent``
#: key.
TRACEPARENT_VERBS: Tuple[str, ...] = (
    "SUBMIT", "GENERATE", "PREFILL", "EVICT", "SWAPWEIGHTS")

_TRACE_ID_LEN = 12
_SPAN_ID_LEN = 8


def new_span_id() -> str:
    """Fresh 8-hex span id (one per hop)."""
    return uuid.uuid4().hex[:_SPAN_ID_LEN]


def make_traceparent(trace_id: str, span_id: Optional[str] = None) -> str:
    """``"<trace_id>-<span_id>"`` token for wire payloads."""
    return f"{trace_id}-{span_id or new_span_id()}"


def parse_traceparent(tp: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """``(trace_id, span_id)`` from a token; ``(None, None)`` on junk.

    Tolerant by design — a malformed token from an old peer must never
    take down a request, it just fails to join the trace.
    """
    if not tp or not isinstance(tp, str):
        return None, None
    head, sep, tail = tp.partition("-")
    if not sep or not head or not tail:
        return None, None
    try:
        int(head, 16), int(tail, 16)
    except ValueError:
        return None, None
    return head, tail


# -- process-wide active trace ------------------------------------------
#
# A plain stack under a lock, NOT a contextvar: the consumers are
# cross-thread correlators that must see the trace a *different* thread
# activated. Scope is "this process is currently
# doing fleet work for trace X", which is exactly process-global.

_lock = threading.Lock()
_stack: list = []


def current_traceparent() -> Optional[str]:
    """Innermost active traceparent in this process, or ``None``."""
    with _lock:
        return _stack[-1] if _stack else None


@contextlib.contextmanager
def use_trace(traceparent: Optional[str]) -> Iterator[None]:
    """Mark ``traceparent`` active for the duration of the block.

    ``None`` is accepted and makes the block a no-op, so call sites can
    pass an optional token unconditionally.
    """
    if not traceparent:
        yield
        return
    with _lock:
        _stack.append(traceparent)
    try:
        yield
    finally:
        with _lock:
            try:
                _stack.remove(traceparent)
            except ValueError:
                pass
