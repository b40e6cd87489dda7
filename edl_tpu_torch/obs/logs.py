"""Structured logging: the ``--log-format json`` backend.

Pod logs are machine-parsed (fluentd/loki in a real cluster, grep -c in
CI); the reference's log15 at least had key=value pairs — free-text
``%(message)s`` lines are the one format nothing downstream can use.
:class:`JsonLogFormatter` renders every record as one JSON object per
line; :func:`configure_logging` is the single setup entry the CLI and the
launcher share, so every process in a pod formats identically.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional, TextIO

__all__ = ["JsonLogFormatter", "configure_logging"]


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record: ts (epoch seconds), level, logger, msg,
    plus exception text and any ``extra={...}`` fields that don't collide
    with LogRecord internals."""

    #: LogRecord attributes that are plumbing, not payload.
    _RESERVED = frozenset(
        logging.LogRecord("", 0, "", 0, "", (), None).__dict__
    ) | {"message", "asctime", "taskName"}

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        for key, value in record.__dict__.items():
            if key in self._RESERVED or key.startswith("_"):
                continue
            try:
                json.dumps(value)
                out[key] = value
            except (TypeError, ValueError):
                out[key] = repr(value)
        return json.dumps(out, ensure_ascii=False)


def configure_logging(level: str = "info", fmt: str = "text",
                      stream: Optional[TextIO] = None) -> None:
    """Root-logger setup shared by ``edl-tpu`` and ``edl-launch``.

    ``fmt="json"`` installs :class:`JsonLogFormatter`; ``"text"`` keeps the
    classic asctime format. Replaces existing root handlers (``force``) so
    a re-exec'd entry or a test calling twice converges instead of
    double-logging.
    """
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"
        ))
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
