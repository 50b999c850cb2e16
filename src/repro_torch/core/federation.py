"""RBAC-lite identity layer: roles, limited-duration tokens, federation stub.

Paper §III.G/H: MyAccessID-federated single sign-on, KeyCloak+OPA RBAC with
limited-duration tokens, tenant-admin vs infrastructure-admin personas.  This
module provides exactly the subset the scheduler/tenancy APIs need to enforce
those semantics in-process (no network identity provider is emulated — the
federation handshake is reduced to ``federated_login`` returning a token).

A copy of the JAX package's ``core/federation.py`` (it holds no JAX).
"""

from __future__ import annotations

import enum
import hashlib
import hmac
import time
from dataclasses import dataclass, field
from typing import Optional


class Role(enum.Enum):
    USER = "user"
    TENANT_ADMIN = "tenant_admin"
    INFRA_ADMIN = "infra_admin"


_ORDER = {Role.USER: 0, Role.TENANT_ADMIN: 1, Role.INFRA_ADMIN: 2}


@dataclass
class Identity:
    subject: str  # e.g. "alice@bristol.ac.uk"
    home_idp: str  # institutional IdP (eduGAIN federation)
    roles: dict[str, Role] = field(default_factory=dict)  # scope -> role


@dataclass
class Token:
    subject: str
    issued: float
    expires: float
    mac: str


class IAM:
    """In-process KeyCloak/OPA stand-in with HMAC'd expiring tokens."""

    def __init__(self, *, token_ttl: float = 3600.0, secret: bytes = b"isambard-ai", clock=time.monotonic):
        self.token_ttl = token_ttl
        self._secret = secret
        self._clock = clock
        self.identities: dict[str, Identity] = {}
        self._tokens: dict[str, Token] = {}

    # ------------------------------------------------------------------
    def federated_login(self, subject: str, home_idp: str) -> str:
        """MyAccessID-style login: auto-provision on first arrival."""
        ident = self.identities.setdefault(subject, Identity(subject, home_idp))
        ident.roles.setdefault("*", Role.USER)
        now = self._clock()
        payload = f"{subject}|{now}".encode()
        mac = hmac.new(self._secret, payload, hashlib.sha256).hexdigest()[:32]
        tok = Token(subject=subject, issued=now, expires=now + self.token_ttl, mac=mac)
        self._tokens[mac] = tok
        return mac

    def grant(self, subject: str, role: Role, scope: str = "*") -> None:
        ident = self.identities.setdefault(subject, Identity(subject, "local"))
        ident.roles[scope] = role

    # ------------------------------------------------------------------
    def resolve(self, token: str) -> Identity:
        tok = self._tokens.get(token)
        if tok is None:
            raise PermissionError("unknown token")
        if self._clock() > tok.expires:
            raise PermissionError("token expired")
        return self.identities[tok.subject]

    def require(self, token: str, role: Role, scope: str = "*") -> Identity:
        ident = self.resolve(token)
        have = ident.roles.get(scope, ident.roles.get("*", Role.USER))
        if _ORDER[have] < _ORDER[role]:
            raise PermissionError(f"{ident.subject} lacks {role.value} on {scope!r}")
        return ident
