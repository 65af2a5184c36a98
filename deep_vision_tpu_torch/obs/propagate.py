"""Trace-context propagation, W3C `traceparent` style (the port of
deep_vision_tpu/obs/propagate.py).

A `TraceContext` ties one request's events together across threads and
processes:

    trace_id        32 lowercase hex chars, one per request or batch,
                    minted at ingress and constant across every hop
    span_id         16 lowercase hex chars, one per hop
    parent_span_id  the span this hop was born from (None at the root)

The wire form is the W3C `traceparent` header, version 00:

    00-<trace_id>-<span_id>-01

The Server mints one per request at submit and carries it on the
Request object (the dispatcher thread cannot see the submitting
thread's slot). Journal events written while a context is installed
(`use(ctx)`) are stamped with trace_id/span_id/parent_span_id
(obs/journal.py), and spans opened under one carry the ids as args
(obs/trace.py).

Stdlib only, no torch at import (data workers import it). A malformed
wire context parses to None and never raises: propagation is telemetry,
and telemetry degrades rather than kill the request it describes. The
installed context is thread-local.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
from typing import Iterator, Optional

__all__ = [
    "TraceContext",
    "new_trace",
    "from_traceparent",
    "current",
    "use",
]

TRACEPARENT_VERSION = "00"
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# journal field names, shared with check_journal's schema
TRACE_FIELDS = ("trace_id", "span_id", "parent_span_id")


class TraceContext:
    """One hop of one request: ids only, no timing (timing lives in the
    journal events and trace spans the ids are stamped onto)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def child(self) -> "TraceContext":
        """A new hop of the same request: fresh span, this one as parent."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def to_traceparent(self) -> str:
        return f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    def fields(self) -> dict:
        """The journal-event stamping: {trace_id, span_id[, parent_span_id]}."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        return out

    def __repr__(self) -> str:  # debugging aid, not a wire format
        return (f"TraceContext({self.trace_id[:8]}../{self.span_id}"
                f"{' <- ' + self.parent_span_id if self.parent_span_id else ''})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_span_id == other.parent_span_id)


def _new_span_id() -> str:
    return os.urandom(8).hex()


def new_trace() -> TraceContext:
    """Mint a root context — call at request/batch ingress."""
    return TraceContext(os.urandom(16).hex(), _new_span_id(), None)


def from_traceparent(value) -> Optional[TraceContext]:
    """Parse a wire `traceparent`; None on anything malformed.

    The parsed context's span becomes the PARENT of the receiving hop:
    callers should `.child()` it before stamping local events, so the
    two sides of the wire stay distinct spans of one trace.
    """
    if isinstance(value, bytes):
        try:
            value = value.decode("ascii")
        except UnicodeDecodeError:
            return None
    if not isinstance(value, str):
        return None
    # lowercase-only by the W3C spec: an uppercase-hex producer is
    # malformed, and silently lowercasing would make our journal ids
    # disagree with what actually crossed the wire
    m = _TRACEPARENT_RE.match(value.strip())
    if not m:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":  # forbidden by the W3C spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, None)


def valid_trace_id(value) -> bool:
    return isinstance(value, str) and bool(_TRACE_ID_RE.match(value))


def valid_span_id(value) -> bool:
    return isinstance(value, str) and bool(_SPAN_ID_RE.match(value))


# -- the ambient (thread-local) context ------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context installed on THIS thread, or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Install `ctx` as this thread's ambient context for the block.

    Journal writes inside the block are stamped with the context's ids;
    nesting restores the outer context on exit. `use(None)` masks an
    outer context (e.g. a maintenance write inside a traced region).
    """
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev
