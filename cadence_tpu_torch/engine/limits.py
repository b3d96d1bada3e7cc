"""Size and count limits with warn/error thresholds.

Reference: the limit checks threaded through the frontend and the
decision checker (service/history/decision/checker.go blob-size checks;
common/util.go CheckEventBlobSizeLimit) and the history size/count
enforcement that TERMINATES a workflow whose history outgrows the store's
contract (host/size_limit_test.go): exceeding warn logs + counts,
exceeding error refuses the write (blobs) or terminates the run
(history growth) — growth without bounds is how one workflow takes down
a shard.
"""
from __future__ import annotations

from ..utils.log import DEFAULT_LOGGER
from ..utils.metrics import DEFAULT_REGISTRY

TERMINATE_REASON = "history limit exceeded"


class LimitExceededError(Exception):
    """Request refused: a payload/size limit was breached
    (types.LimitExceededError / EntityNotExistsError in the reference)."""


def check_blob_size(payload: bytes, config, api: str, domain: str = "",
                    metrics=None, log=None) -> None:
    """Warn past the warn threshold; REFUSE past the error threshold
    (CheckEventBlobSizeLimit)."""
    from ..utils.dynamicconfig import (
        KEY_BLOB_SIZE_LIMIT_ERROR,
        KEY_BLOB_SIZE_LIMIT_WARN,
    )
    size = len(payload or b"")
    error_limit = int(config.get(KEY_BLOB_SIZE_LIMIT_ERROR, domain=domain))
    warn_limit = int(config.get(KEY_BLOB_SIZE_LIMIT_WARN, domain=domain))
    if error_limit and size > error_limit:
        (metrics or DEFAULT_REGISTRY).inc("limits", "blob-size-exceeded")
        raise LimitExceededError(
            f"{api}: payload {size}B exceeds the {error_limit}B blob limit")
    if warn_limit and size > warn_limit:
        (metrics or DEFAULT_REGISTRY).inc("limits", "blob-size-warnings")
        (log or DEFAULT_LOGGER).warning(
            "payload above warn threshold", api=api, domain=domain,
            size=size, warn_limit=warn_limit)


def history_limits(config, domain: str = ""):
    """(count_warn, count_error, size_warn, size_error) for one domain."""
    from ..utils.dynamicconfig import (
        KEY_HISTORY_COUNT_LIMIT_ERROR,
        KEY_HISTORY_COUNT_LIMIT_WARN,
        KEY_HISTORY_SIZE_LIMIT_ERROR,
        KEY_HISTORY_SIZE_LIMIT_WARN,
    )
    return (int(config.get(KEY_HISTORY_COUNT_LIMIT_WARN, domain=domain)),
            int(config.get(KEY_HISTORY_COUNT_LIMIT_ERROR, domain=domain)),
            int(config.get(KEY_HISTORY_SIZE_LIMIT_WARN, domain=domain)),
            int(config.get(KEY_HISTORY_SIZE_LIMIT_ERROR, domain=domain)))
