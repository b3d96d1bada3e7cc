"""Authorization seam: every frontend/admin call passes an authorizer.

Reference: common/authorization/authorizer.go:88 (Authorize(ctx,
*Attributes) → Result Allow/Deny), the noop authorizer (allow-all
default), and the accessControlled handler wrappers
(service/frontend/accessControlledHandler.go). The oauth claim-mapping
impl is out of scope; the SEAM is what matters — admin APIs are no
longer structurally wide open."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DECISION_ALLOW = 1
DECISION_DENY = 2

#: permission levels (authorization/authorizer.go PermissionRead/Write/Admin)
PERMISSION_READ = "read"
PERMISSION_WRITE = "write"
PERMISSION_ADMIN = "admin"


class UnauthorizedError(Exception):
    """Request denied by the authorizer (errUnauthorized)."""


@dataclass(frozen=True)
class AuthAttributes:
    """authorization.Attributes: what is being attempted, by whom."""

    api: str
    permission: str
    domain: str = ""
    actor: str = ""


class NoopAuthorizer:
    """authorization/noopAuthorizer: everything allowed (the default, as
    in the reference — turning authz ON is a deployment choice)."""

    def authorize(self, attributes: AuthAttributes) -> int:
        return DECISION_ALLOW


class RoleAuthorizer:
    """A minimal claims-based authorizer: actors carry roles; admin APIs
    need the admin role, writes need write-or-admin, reads any role.
    Stands in for the oauth authorizer's permission mapping
    (authorization/oauthAuthorizer.go)."""

    _RANK = {PERMISSION_READ: 0, PERMISSION_WRITE: 1, PERMISSION_ADMIN: 2}

    def __init__(self, roles: dict, default_role: Optional[str] = None) -> None:
        #: actor name → highest permitted permission
        self.roles = dict(roles)
        self.default_role = default_role

    def authorize(self, attributes: AuthAttributes) -> int:
        role = self.roles.get(attributes.actor, self.default_role)
        if role is None:
            return DECISION_DENY
        if self._RANK.get(role, -1) >= self._RANK[attributes.permission]:
            return DECISION_ALLOW
        return DECISION_DENY


class OAuthAuthorizer:
    """JWT-validating authorizer (authorization/oauthAuthorizer.go): the
    actor credential is a compact HS256 JWT whose claims map to
    permissions — `sub` (identity), `permission` (read/write/admin),
    optional `domain` binding, `admin` override, `exp` expiry. Denies on
    bad signature, expiry, insufficient permission, or a domain-bound
    token used against another domain. Tokens mint via `make_token`
    (the reference validates RS256 against public keys; the HMAC shape
    keeps the same claim semantics without a key-distribution tier)."""

    _RANK = {PERMISSION_READ: 0, PERMISSION_WRITE: 1, PERMISSION_ADMIN: 2}

    def __init__(self, secret: bytes, clock=None) -> None:
        self.secret = secret
        import time as _time
        self.clock = clock if clock is not None else _time.time

    def authorize(self, attributes: AuthAttributes) -> int:
        claims = verify_token(self.secret, attributes.actor)
        if claims is None:
            return DECISION_DENY
        exp = claims.get("exp")
        if exp is not None and self.clock() > exp:
            return DECISION_DENY
        if claims.get("admin"):
            return DECISION_ALLOW
        bound = claims.get("domain")
        if bound and attributes.domain and bound != attributes.domain:
            return DECISION_DENY
        granted = claims.get("permission", PERMISSION_READ)
        if self._RANK.get(granted, -1) >= self._RANK[attributes.permission]:
            return DECISION_ALLOW
        return DECISION_DENY


def _b64url(data: bytes) -> bytes:
    import base64
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: str) -> bytes:
    import base64
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def make_token(secret: bytes, sub: str, permission: str = PERMISSION_READ,
               domain: str = "", admin: bool = False,
               ttl_seconds: int = 3600, now: Optional[float] = None) -> str:
    """Mint a compact HS256 JWT for OAuthAuthorizer (ops/test helper)."""
    import hashlib
    import hmac as _hmac
    import json as _json
    import time as _time
    now = _time.time() if now is None else now
    header = _b64url(_json.dumps({"alg": "HS256", "typ": "JWT"},
                                 separators=(",", ":")).encode())
    claims = {"sub": sub, "permission": permission,
              "iat": int(now), "exp": int(now + ttl_seconds)}
    if domain:
        claims["domain"] = domain
    if admin:
        claims["admin"] = True
    body = _b64url(_json.dumps(claims, separators=(",", ":")).encode())
    signing = header + b"." + body
    sig = _b64url(_hmac.new(secret, signing, hashlib.sha256).digest())
    return (signing + b"." + sig).decode("ascii")


def verify_token(secret: bytes, token: str) -> Optional[dict]:
    """Claims when the signature checks out, else None."""
    import hashlib
    import hmac as _hmac
    import json as _json
    try:
        header, body, sig = token.split(".")
        expected = _b64url(_hmac.new(
            secret, f"{header}.{body}".encode("ascii"),
            hashlib.sha256).digest()).decode("ascii")
        if not _hmac.compare_digest(sig, expected):
            return None
        if _json.loads(_b64url_decode(header)).get("alg") != "HS256":
            return None  # alg-confusion guard: only HS256 accepted
        return _json.loads(_b64url_decode(body))
    except Exception:
        return None


def check(authorizer, attributes: AuthAttributes) -> None:
    """Raise UnauthorizedError unless allowed (the accessControlled
    wrapper's guard)."""
    if authorizer.authorize(attributes) != DECISION_ALLOW:
        raise UnauthorizedError(
            f"{attributes.actor or '<anonymous>'} may not "
            f"{attributes.api} (needs {attributes.permission})")
