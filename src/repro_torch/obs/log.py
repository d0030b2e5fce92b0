"""Structured logging helper — one emit path for all watcher/monitor
components (DESIGN.md §10.5).

``log_event(logger, "delta_checksum_mismatch", version=12, path=...)``
renders a grep-friendly ``key=value`` message AND attaches the full record
as ``record.structured`` so a handler (or test) can consume the fields
without re-parsing the text. Correlation ids are ordinary fields:
``version`` (update plane), ``trace_id`` (request plane), ``watcher``
(component instance).
"""
from __future__ import annotations

import logging
from typing import Optional


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if " " in s or "=" in s:
        return repr(s)
    return s


def log_event(logger: logging.Logger, event: str,
              level: int = logging.INFO,
              exc_info: bool = False, **fields) -> dict:
    """Emit one structured record. Returns the field dict (handy for
    tests). ``None``-valued fields are dropped so call sites can pass
    optional correlation ids unconditionally."""
    record = {"event": event}
    record.update((k, v) for k, v in fields.items() if v is not None)
    msg = " ".join([event] + [f"{k}={_fmt_value(v)}"
                              for k, v in record.items() if k != "event"])
    logger.log(level, "%s", msg, exc_info=exc_info,
               extra={"structured": record})
    return record


class CapturingHandler(logging.Handler):
    """Test helper: collects the ``structured`` dicts of records passing
    through a logger, so assertions read fields instead of regexing text."""

    def __init__(self, level: int = logging.DEBUG):
        super().__init__(level)
        self.records: list[dict] = []
        self.messages: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        structured = getattr(record, "structured", None)
        if structured is not None:
            self.records.append(dict(structured))
            self.messages.append(record.getMessage())

    def events(self, name: Optional[str] = None) -> list[dict]:
        if name is None:
            return list(self.records)
        return [r for r in self.records if r.get("event") == name]
