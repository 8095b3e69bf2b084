"""Spans of a rank process, in the span log format of ``tpudra.trace``.

The port's own copy of the part of ``tpudra.trace`` that a rank process
needs, so that the port imports nothing of the JAX package: the switches
(``TPUDRA_TRACE``, ``TPUDRA_TRACE_LOG``), the traceparent that the grant env
carries (``TPUDRA_TRACEPARENT``), and ``start_span`` used as a context
manager.  A closed span is one JSON line with the keys and meaning of
``tpudra.trace``'s records (``t``, ``trace``, ``span``, ``parent``, ``name``,
``start``, ``dur_ms``, ``pid``, ``thread``, and ``attrs`` when set, ``error``
when the body raised), so ``tpudra.trace.read_log`` and
``tools/trace_report.py`` read the port's spans unchanged.

Unlike ``tpudra.trace``, which buffers records and writes them in batches,
each span is written when it closes, as one ``write`` of one line to a
descriptor opened with ``O_APPEND``: the ranks of a gang share one log, and
a rank that its launcher kills keeps every span it had closed.  An
unwritable log drops the span with one warning per process; tracing never
fails the traced work.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

ENV_TRACE = "TPUDRA_TRACE"
ENV_TRACE_LOG = "TPUDRA_TRACE_LOG"
DEFAULT_LOG = "tpudra-trace.jsonl"
#: The grant env's trace context of the bind that granted the claim.
TRACEPARENT_ENV = "TPUDRA_TRACEPARENT"


def enabled() -> bool:
    return os.environ.get(ENV_TRACE, "") not in ("", "0")


def log_path() -> str:
    return os.environ.get(ENV_TRACE_LOG, "") or os.path.join(os.getcwd(), DEFAULT_LOG)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[tuple]:
    """(trace_id, span_id) from a ``00-<trace>-<span>-01`` string; None on
    anything malformed, so a garbled traceparent starts a fresh trace."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return (trace_id, span_id)


_write_warned = False


def _write(record: dict) -> None:
    global _write_warned
    line = (json.dumps(record, sort_keys=True, default=repr) + "\n").encode()
    try:
        fd = os.open(log_path(), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
    except OSError as e:
        if not _write_warned:
            _write_warned = True
            logger.warning("trace log %s is unwritable (%s): dropping spans", log_path(), e)


class Span:
    """One traced operation; use only as a context manager."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs", "_t0", "_wall0")

    def __init__(self, trace_id: str, span_id: str, parent_id: str, name: str, attrs: dict):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._wall0 = 0.0

    def __enter__(self) -> "Span":
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        record = {
            "t": "span",
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "start": round(self._wall0, 6),
            "dur_ms": round(dur * 1000.0, 3),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
        }
        if exc_type is not None:
            record["error"] = f"{exc_type.__name__}: {exc}"
        if self.attrs:
            record["attrs"] = self.attrs
        _write(record)
        return False


class _NoopSpan:
    """The disabled path: one shared instance that records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


def start_span(name: str, parent: Optional[str] = None, attrs: Optional[dict] = None):
    """Open a span named ``name`` under the ``parent`` traceparent (a remote
    context, such as the grant env's); a missing or garbled one starts a new
    trace.  Returns the shared no-op span when tracing is off."""
    if not enabled():
        return NOOP_SPAN
    trace_id, parent_id = parse_traceparent(parent) or (os.urandom(16).hex(), "")
    return Span(trace_id, os.urandom(8).hex(), parent_id, name, dict(attrs or {}))
