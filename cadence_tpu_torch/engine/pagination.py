"""Opaque page tokens: every list-shaped API hands back bounded pages.

Reference: the serialized token structs the frontend threads through
GetWorkflowExecutionHistory / List* (workflowHandler.go:3745-3811
getHistory nextPageToken; elasticsearch visibility tokens). Tokens are
opaque bytes to callers — base64(JSON) here — and carry exactly the
resume position, so they survive the wire and process restarts.
"""
from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, NamedTuple, Optional


class PageTokenError(Exception):
    """Malformed/foreign page token (BadRequestError in the reference)."""


def encode_token(fields: Dict[str, Any]) -> bytes:
    return base64.b64encode(
        json.dumps(fields, separators=(",", ":")).encode("utf-8"))


def decode_token(token: bytes) -> Dict[str, Any]:
    try:
        return json.loads(base64.b64decode(token).decode("utf-8"))
    except Exception as exc:
        raise PageTokenError(f"invalid page token: {exc}") from exc


class HistoryPage(NamedTuple):
    events: List
    next_page_token: Optional[bytes]
    run_id: str


class VisibilityPage(NamedTuple):
    records: List
    next_page_token: Optional[bytes]
