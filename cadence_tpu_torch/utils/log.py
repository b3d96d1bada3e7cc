"""Structured logging: stdlib logging + typed tags.

Reference: common/log/loggerimpl/logger.go:29 (zap sugared logger) and
log/tag/ (typed tag constructors — WorkflowID, ShardID, Domain...). The
contract kept: every log line carries machine-parseable key=value tags,
loggers compose tags incrementally (`With`), and the library never
configures handlers (hosts/CLI own the sink — NullHandler by default,
exactly how a library should behave).
"""
from __future__ import annotations

import logging
from typing import Any, Dict

_ROOT = logging.getLogger("cadence_tpu_torch")
_ROOT.addHandler(logging.NullHandler())


class TaggedLogger:
    """A logger carrying a tag set; `with_tags` derives a child logger
    (loggerimpl.WithTags analog). Tags render as sorted key=value pairs
    appended to the message."""

    def __init__(self, logger: logging.Logger = _ROOT,
                 tags: Dict[str, Any] = None) -> None:
        self._logger = logger
        self._tags = dict(tags or {})

    def with_tags(self, **tags: Any) -> "TaggedLogger":
        merged = dict(self._tags)
        merged.update(tags)
        return TaggedLogger(self._logger, merged)

    def _render(self, msg: str, tags: Dict[str, Any]) -> str:
        merged = dict(self._tags)
        merged.update(tags)
        if not merged:
            return msg
        suffix = " ".join(f"{k}={merged[k]}" for k in sorted(merged))
        return f"{msg} {suffix}"

    def isEnabledFor(self, level: int) -> bool:
        return self._logger.isEnabledFor(level)

    def debug(self, msg: str, **tags: Any) -> None:
        if self._logger.isEnabledFor(logging.DEBUG):
            self._logger.debug(self._render(msg, tags))

    def info(self, msg: str, **tags: Any) -> None:
        if self._logger.isEnabledFor(logging.INFO):
            self._logger.info(self._render(msg, tags))

    def warning(self, msg: str, **tags: Any) -> None:
        if self._logger.isEnabledFor(logging.WARNING):
            self._logger.warning(self._render(msg, tags))

    def error(self, msg: str, **tags: Any) -> None:
        if self._logger.isEnabledFor(logging.ERROR):
            self._logger.error(self._render(msg, tags))


#: the default cluster logger; components derive tagged children from it
DEFAULT_LOGGER = TaggedLogger()


def configure_stderr(level: int = logging.INFO) -> None:
    """Host/CLI convenience: send cadence_tpu_torch logs to stderr (the library
    itself never does this)."""
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s"))
    _ROOT.addHandler(handler)
    _ROOT.setLevel(level)
