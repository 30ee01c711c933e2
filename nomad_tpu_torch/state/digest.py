"""Canonical state encoding of an FSM snapshot (reference:
nomad_tpu/state/digest.py, the encoding its scenario battery and its
replica-integrity plane share).

Two snapshots are canon-equal (`canon`) if and only if every per-table
digest (`table_digest`) matches, modulo hash collisions.  The port's
dev-mode server uses them to check a snapshot round trip; the raft
integrity plane that exchanges the digests between replicas is not
ported yet.

Encoding rules:

- tables are visited in sorted key order — never set/dict-arrival order
- list tables compare as a SORTED multiset of standalone pickles: the
  big snapshot pickle's string memoization means two byte-different
  blobs can hold equal values, so each item is re-pickled on its own
- dict tables compare per sorted key, values re-pickled standalone
- scalars compare as their standalone pickle

Digests are length-framed SHA-256 over the canonical encoding, so "item
boundary" ambiguity can't alias two different tables onto one digest.
"""
from __future__ import annotations

import hashlib
import pickle
import struct
from typing import Dict


def canon_table(val):
    """Canonical form of ONE snapshot table value: a sorted list of
    standalone pickles (list tables), a sorted-key dict of standalone
    pickles (dict tables), or the standalone pickle (scalars)."""
    if isinstance(val, list):
        return sorted(pickle.dumps(v) for v in val)
    if isinstance(val, dict):
        return {k: pickle.dumps(v) for k, v in sorted(val.items())}
    return pickle.dumps(val)


def canon(blob: bytes) -> dict:
    """Canonical form of a whole FSM snapshot blob: two blobs hold the
    same state if and only if their canonical forms are equal."""
    data = pickle.loads(blob)
    out = {}
    for key, val in sorted(data.items()):
        out[key] = canon_table(val)
    return out


def _frame(h, b: bytes) -> None:
    h.update(struct.pack("<I", len(b)))
    h.update(b)


def table_digest(val) -> str:
    """Digest of one table value over its canonical form (16 hex chars:
    64 bits — plenty for a 3..5-replica equality vote, small enough to
    ride every heartbeat ack)."""
    h = hashlib.sha256()
    c = canon_table(val)
    if isinstance(c, list):
        h.update(b"L")
        for b in c:
            _frame(h, b)
    elif isinstance(c, dict):
        h.update(b"D")
        for k, b in c.items():        # insertion order == sorted keys
            _frame(h, pickle.dumps(k))
            _frame(h, b)
    else:
        h.update(b"S")
        _frame(h, c)
    return h.hexdigest()[:16]


def tables_digests(tables: dict) -> Dict[str, str]:
    """Per-table digests of a snapshot record dict (the pre-pickle form
    `NomadFSM.snapshot_tables` returns, or `pickle.loads(blob)`)."""
    out: Dict[str, str] = {}
    for key in sorted(tables):
        out[key] = table_digest(tables[key])
    return out


def blob_digests(blob: bytes) -> Dict[str, str]:
    """Per-table digests straight from a snapshot blob."""
    return tables_digests(pickle.loads(blob))


def combine(per_table: Dict[str, str]) -> str:
    """One rolling digest over the per-table digests, visited in sorted
    table order (16 hex chars)."""
    h = hashlib.sha256()
    for key in sorted(per_table):
        _frame(h, key.encode())
        _frame(h, per_table[key].encode())
    return h.hexdigest()[:16]


def first_divergence(a: Dict[str, str], b: Dict[str, str]):
    """First table (sorted order) whose digests differ, or None: the
    table to name when two states diverge."""
    for key in sorted(set(a) | set(b)):
        if a.get(key) != b.get(key):
            return key
    return None
