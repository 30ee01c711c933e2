"""Vault-shaped secrets provider (reference: nomad/vault.go — the
server-side vaultClient that derives per-task tokens with TTL + renewal;
client/allocrunner/taskrunner/vault_hook.go — the client hook writing
the token into the task's secrets dir and renewing it; and
taskrunner/template/template.go — templates that render secrets and
re-render when they change).

The provider embeds a versioned KV store and a token-lease engine in
the server process, leader-local like the reference's external-Vault
client state (not raft state); its RPC callers, the Vault endpoints,
come with the port's RPC layer (ROADMAP A4).  The
shape the rest of the system sees is the reference's: tasks declare a
`vault { policies = [...] }` stanza, the client derives a renewable
token scoped to those policies, the token lands in secrets/vault_token,
and templates read secrets through the token — never through ambient
server state.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.utils import generate_uuid


class SecretsError(Exception):
    pass


@dataclass
class _Lease:
    token: str
    alloc_id: str
    task: str
    policies: List[str]
    ttl_s: float
    expires: float
    revoked: bool = False
    renewals: int = 0


@dataclass
class _Entry:
    data: Dict[str, str] = field(default_factory=dict)
    version: int = 1


class SecretsProvider:
    """Embedded KV + token leases.  Policies are path prefixes: a token
    carrying policy "db" may read secret paths "db" and "db/...", the
    reference's policy->path mapping reduced to its prefix core."""

    def __init__(self, default_ttl_s: float = 3600.0):
        self.default_ttl_s = default_ttl_s
        self._kv: Dict[str, _Entry] = {}
        self._leases: Dict[str, _Lease] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- kv

    def put(self, path: str, data: Dict[str, str]) -> int:
        """Write a secret; bumps the version (templates watch it)."""
        if not path:
            raise SecretsError("empty secret path")
        with self._lock:
            e = self._kv.get(path)
            if e is None:
                self._kv[path] = _Entry(dict(data))
                return 1
            e.data = dict(data)
            e.version += 1
            return e.version

    def delete(self, path: str) -> None:
        with self._lock:
            self._kv.pop(path, None)

    # ------------------------------------------------------------- tokens

    def derive_token(self, alloc_id: str, task: str,
                     policies: List[str],
                     ttl_s: Optional[float] = None) -> dict:
        """Per-task token derivation (vault.go CreateToken): renewable,
        scoped to the task's vault policies."""
        ttl = float(ttl_s or self.default_ttl_s)
        lease = _Lease(token=generate_uuid(), alloc_id=alloc_id,
                       task=task, policies=list(policies),
                       ttl_s=ttl, expires=time.time() + ttl)
        with self._lock:
            if len(self._leases) > 4096:
                self._prune_locked()
            self._leases[lease.token] = lease
        return {"token": lease.token, "ttl_s": ttl,
                "policies": lease.policies}

    def _prune_locked(self) -> None:
        """Drop revoked/expired leases (amortized; the reference's
        revocation daemon, vault.go revokeDaemon)."""
        now = time.time()
        dead = [t for t, l in self._leases.items()
                if l.revoked or l.expires < now]
        for t in dead:
            del self._leases[t]

    def renew(self, token: str) -> dict:
        """Extend the lease (vault.go RenewToken); expired/revoked
        tokens fail and the client's change_mode kicks in."""
        now = time.time()
        with self._lock:
            lease = self._leases.get(token)
            if lease is None or lease.revoked or lease.expires < now:
                raise SecretsError("token expired or revoked")
            lease.expires = now + lease.ttl_s
            lease.renewals += 1
            return {"ttl_s": lease.ttl_s, "renewals": lease.renewals}

    def revoke_for_alloc(self, alloc_id: str) -> int:
        """Revoke every lease of a terminal alloc (vault.go
        RevokeTokens on alloc GC/stop)."""
        with self._lock:
            dead = [t for t, l in self._leases.items()
                    if l.alloc_id == alloc_id]
            for t in dead:
                del self._leases[t]
        return len(dead)

    def _check(self, token: str, path: str) -> _Lease:
        now = time.time()
        lease = self._leases.get(token)
        if lease is None or lease.revoked or lease.expires < now:
            raise SecretsError("token expired or revoked")
        for pol in lease.policies:
            if path == pol or path.startswith(pol + "/"):
                return lease
        raise SecretsError(f"token policies {lease.policies} do not "
                           f"cover path {path!r}")

    # --------------------------------------------------------------- read

    def read(self, path: str, token: str) -> Tuple[Dict[str, str], int]:
        """Token-gated read -> (data, version)."""
        with self._lock:
            self._check(token, path)
            e = self._kv.get(path)
            if e is None:
                raise SecretsError(f"no secret at {path!r}")
            return dict(e.data), e.version

    def version(self, path: str, token: str) -> int:
        """Cheap change-watch primitive for template re-rendering."""
        with self._lock:
            self._check(token, path)
            e = self._kv.get(path)
            return e.version if e is not None else 0
