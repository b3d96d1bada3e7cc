"""Wire protocol: length-prefixed frames over TCP.

Reference: common/rpc/factory.go:27-90 builds YARPC gRPC+TChannel
inbounds; the equivalent here is a minimal length-prefixed binary framing
(4-byte big-endian length + pickle body) shared by every service role.

TRUST BOUNDARY: frames carry pickled engine/store objects, so the wire is
an INTERNAL cluster transport (the posture of the reference's TChannel and
Cassandra native protocol: authenticated network, not the public edge).
The public edge would terminate in the frontend role with a schema codec
(core/codec.py carries the history blobs already); pickle here keeps the
whole MutableState/persistence surface transportable without a parallel
serialization tier.
"""
from __future__ import annotations

import hashlib
import hmac
import io
import os
import pickle
import socket
import struct
from typing import Any, Optional, Tuple

from ..utils import deadline as deadline_mod
from ..utils import tracing
from ..utils.deadline import DeadlineExceeded
from . import chaos as chaos_mod

_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024

#: per-hop ceiling when no caller deadline is bound (the old fixed value,
#: now only an upper bound — live deadlines shrink it per call)
DEFAULT_TIMEOUT_S = 30.0
#: floor for derived socket timeouts: a nearly-expired budget still gets
#: a sliver of wire time instead of a zero/negative timeout
MIN_TIMEOUT_S = 0.001


class WireError(ConnectionError):
    """Framing violation or truncated peer stream."""


def effective_timeout(base: float = DEFAULT_TIMEOUT_S) -> float:
    """Socket timeout for the next hop: the caller's remaining deadline
    budget when one is bound (clamped to [MIN, base]), else `base`.
    Raises DeadlineExceeded instead of dialing when the budget is gone —
    the cheapest possible rejection."""
    current = deadline_mod.current()
    if current is None:
        return base
    remaining = current.remaining()
    if remaining <= 0:
        raise DeadlineExceeded(
            f"deadline expired {-remaining:.3f}s before the call")
    return max(MIN_TIMEOUT_S, min(base, remaining))


# -- connection authentication ---------------------------------------------
#
# The trust-boundary docstring above is ENFORCED, not just declared: every
# connection opens with a challenge-response handshake keyed by a
# per-cluster shared secret — the server sends a fresh random nonce, the
# client answers HMAC-SHA256(secret, nonce || context) — so a recorded
# preamble is worthless on the next connection (replay-proof); a peer that
# cannot produce the response is disconnected before any frame is
# unpickled. The ORIGINAL static preamble, HMAC(secret, context) with no
# nonce, is kept only as a documented LEGACY fallback: the server still
# accepts it unless CADENCE_TPU_WIRE_ALLOW_STATIC=0, which closes the
# replay window — set it once every peer in the cluster speaks the
# challenge. The fallback is ONE-directional by design: it covers OLD
# clients dialing NEW servers, so a rolling upgrade must roll the server
# side first (a new client dialing an old server would wait for a nonce
# that never comes and burn its socket timeout). The secret comes
# from CADENCE_TPU_WIRE_SECRET (explicit per-cluster deployment), falling
# back to a 0600 per-user secret file — so on a multi-user host, reaching
# the port is not enough: an unrelated local user cannot read the key
# material.

_HELLO_CTX = b"cadence-tpu-wire-v1"
_HELLO_LEN = hashlib.sha256().digest_size
_NONCE_LEN = 32
_LEGACY_ENV = "CADENCE_TPU_WIRE_ALLOW_STATIC"
_SECRET_CACHE: Optional[bytes] = None


def cluster_secret() -> bytes:
    global _SECRET_CACHE
    if _SECRET_CACHE is not None:
        return _SECRET_CACHE
    env = os.environ.get("CADENCE_TPU_WIRE_SECRET")
    if env:
        _SECRET_CACHE = env.encode("utf-8")
        return _SECRET_CACHE
    path = os.path.join(os.path.expanduser("~"), ".cadence_tpu_wire_secret")
    try:
        with open(path, "rb") as fh:
            _SECRET_CACHE = fh.read()
            return _SECRET_CACHE
    except FileNotFoundError:
        pass
    secret = os.urandom(32)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        with os.fdopen(fd, "wb") as fh:
            fh.write(secret)
    except FileExistsError:
        with open(path, "rb") as fh:  # lost the creation race: theirs wins
            secret = fh.read()
    _SECRET_CACHE = secret
    return secret


def _hello_mac() -> bytes:
    """The LEGACY static preamble (pre-challenge peers)."""
    return hmac.new(cluster_secret(), _HELLO_CTX, hashlib.sha256).digest()


def _challenge_mac(nonce: bytes) -> bytes:
    return hmac.new(cluster_secret(), nonce + _HELLO_CTX,
                    hashlib.sha256).digest()


def _legacy_allowed() -> bool:
    return os.environ.get(_LEGACY_ENV, "1") not in ("0", "false", "no")


def send_hello(sock: socket.socket) -> None:
    """Client side of the handshake: read the server's fresh nonce, answer
    HMAC(secret, nonce || context) — the response only opens THIS
    connection; replaying it elsewhere fails against a different nonce."""
    nonce = _read_exact(sock, _NONCE_LEN)
    sock.sendall(_challenge_mac(nonce))


def verify_hello(sock: socket.socket) -> None:
    """Server side: challenge, then read+check the response BEFORE the
    first pickle load. Raises WireError (and the caller drops the
    connection) on mismatch. The static legacy preamble is accepted only
    while CADENCE_TPU_WIRE_ALLOW_STATIC permits it."""
    nonce = os.urandom(_NONCE_LEN)
    sock.sendall(nonce)
    mac = _read_exact(sock, _HELLO_LEN)
    if hmac.compare_digest(mac, _challenge_mac(nonce)):
        return
    if _legacy_allowed() and hmac.compare_digest(mac, _hello_mac()):
        return
    raise WireError("unauthenticated peer (bad cluster secret)")


def _encode_frame(obj: Any) -> Tuple[bytes, bytes]:
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(body) > MAX_FRAME:
        raise WireError(f"frame {len(body)}B exceeds {MAX_FRAME}B")
    return _LEN.pack(len(body)), body


def send_frame(sock: socket.socket, obj: Any) -> None:
    header, body = _encode_frame(obj)
    sock.sendall(header + body)


def send_request_frame(sock: socket.socket, obj: Any) -> None:
    """The CLIENT request leg of send_frame: the chaos injector (when
    installed) may drop, delay, or sever here — before the server can
    have dispatched anything, so injected faults are always retryable.
    Server RESPONSE sends stay on plain send_frame: a chaos'd response
    would lose applied work and break at-least-once semantics.

    Encode failures (oversized frame, unpicklable argument) are tagged
    `_wire_local`: they happen before any byte reaches the peer, so they
    are neither evidence against the target (breakers must not charge
    them) nor worth a resend of the identical payload."""
    try:
        header, body = _encode_frame(obj)
    except BaseException as exc:
        try:
            exc._wire_local = True
        except Exception:
            pass
        raise
    chaos = chaos_mod.active()
    if chaos is not None:
        chaos.before_send(sock, header, body)
    sock.sendall(header + body)


def _mark_relayed(exc: BaseException) -> BaseException:
    """Tag an exception that arrived as an ("err", exc) RESPONSE: the
    peer ANSWERED — the failure (possibly ConnectionError-shaped, from
    the peer's own outbound hop) is not evidence against this transport,
    and client breakers must not charge it (rpc/client._Pool reads the
    tag). Best-effort: exotic exception types without a __dict__ simply
    go untagged."""
    try:
        exc._wire_relayed = True
    except Exception:
        pass
    return exc


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise WireError("peer closed mid-frame")
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def recv_frame(sock: socket.socket) -> Any:
    header = _read_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(f"frame {length}B exceeds {MAX_FRAME}B")
    return pickle.loads(_read_exact(sock, length))


def call(address: Tuple[str, int], request: Any, timeout: float = 30.0) -> Any:
    """One-shot request/response over a fresh connection. The response is
    ("ok", value) or ("err", exception) — errors re-raise at the caller,
    carrying the service-level type (ShardOwnershipLostError & co) across
    the process boundary. An active caller deadline rides the envelope
    and shrinks the socket timeout."""
    chaos_mod.check_partition(address)
    timeout = effective_timeout(timeout)
    with socket.create_connection(address, timeout=timeout) as sock:
        send_hello(sock)
        send_request_frame(sock, deadline_mod.inject(tracing.inject(request)))
        kind, payload = recv_frame(sock)
    if kind == "err":
        raise _mark_relayed(payload)
    return payload


class Connection:
    """A pooled client connection (one in-flight request at a time)."""

    def __init__(self, address: Tuple[str, int],
                 timeout: float = DEFAULT_TIMEOUT_S) -> None:
        self.address = address
        self.timeout = timeout
        self._sock: socket.socket | None = None

    def _ensure(self, timeout: float) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.address,
                                                  timeout=timeout)
            send_hello(self._sock)
        else:
            # pooled socket: re-derive the timeout from THIS call's
            # remaining budget, not whatever the opening call had left
            self._sock.settimeout(timeout)
        return self._sock

    def call(self, request: Any) -> Any:
        for attempt in (0, 1):
            # an installed partition cuts pooled connections too: check
            # per call (not per dial), close the idle socket so healing
            # redials fresh, and raise before any byte leaves — the
            # nothing-was-applied contract ChaosError promises
            table = chaos_mod.active_partitions()
            if table is not None and table.is_blocked(self.address):
                self.close()
                table.check(self.address)
            # derived per attempt: send-retry time counts against the budget
            timeout = effective_timeout(self.timeout)
            sock = self._ensure(timeout)
            try:
                send_request_frame(sock, request)
            except (OSError, WireError) as exc:
                # a LOCAL encode failure is deterministic: reconnecting
                # and re-encoding the same payload cannot help
                if getattr(exc, "_wire_local", False):
                    raise
                # a SEND failure on a pooled socket is the peer-restarted-
                # between-calls case (stale FIN): nothing of this request
                # was processed, so one reconnect+resend is safe
                self.close()
                if attempt:
                    raise
                continue
            try:
                kind, payload = recv_frame(sock)
            except (OSError, WireError):
                # a RECEIVE failure is NOT retried: the peer may already
                # have applied the request (signal appended, task created)
                # and blind resend would double-apply a non-idempotent op —
                # the caller owns that decision (FrontendClient retries
                # only errors the fence makes safe)
                self.close()
                raise
            if kind == "err":
                raise _mark_relayed(payload)
            return payload

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
