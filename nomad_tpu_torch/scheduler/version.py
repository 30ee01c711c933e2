"""Version constraint matching (reference: hashicorp/go-version as used by
scheduler/feasible.go checkVersionMatch; semver mode rejects pre-release
versions unless explicitly constrained, like ConstraintSemver).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)(?:-([0-9A-Za-z.-]+))?(?:\+[0-9A-Za-z.-]+)?$")


class Version:
    __slots__ = ("segments", "prerelease", "raw")

    def __init__(self, raw: str):
        m = _VERSION_RE.match(raw.strip())
        if not m:
            raise ValueError(f"invalid version {raw!r}")
        self.raw = raw
        segs = [int(x) for x in m.group(1).split(".")]
        while len(segs) < 3:
            segs.append(0)
        self.segments = tuple(segs)
        self.prerelease = m.group(2) or ""

    def _pre_key(self) -> Tuple:
        # a version with a prerelease sorts before the same release
        if not self.prerelease:
            return (1,)
        parts = []
        for p in self.prerelease.split("."):
            parts.append((0, int(p)) if p.isdigit() else (1, p))
        return (0, tuple(parts))

    def key(self) -> Tuple:
        return (self.segments, self._pre_key())

    def __lt__(self, other): return self.key() < other.key()
    def __le__(self, other): return self.key() <= other.key()
    def __gt__(self, other): return self.key() > other.key()
    def __ge__(self, other): return self.key() >= other.key()
    def __eq__(self, other): return self.key() == other.key()
    def __hash__(self): return hash(self.key())


_CONSTRAINT_RE = re.compile(r"^\s*(>=|<=|!=|~>|>|<|=)?\s*(.+?)\s*$")


def parse_constraints(spec: str) -> List[Tuple[str, Version]]:
    out = []
    for part in spec.split(","):
        m = _CONSTRAINT_RE.match(part)
        if not m or not m.group(2):
            raise ValueError(f"invalid constraint {part!r}")
        out.append((m.group(1) or "=", Version(m.group(2))))
    return out


def _check_one(op: str, v: Version, target: Version) -> bool:
    if op == "=":
        return v == target
    if op == "!=":
        return v != target
    if op == ">":
        return v > target
    if op == "<":
        return v < target
    if op == ">=":
        return v >= target
    if op == "<=":
        return v <= target
    if op == "~>":
        # pessimistic: >= target, and the segment one finer than specified
        # must not roll over (go-version Constraint semantics)
        if v < target:
            return False
        spec_len = len(target.raw.lstrip("v").split("-")[0].split("."))
        lock = max(spec_len - 1, 1)
        return v.segments[:lock] == target.segments[:lock]
    return False


def version_matches(value: str, spec: str, semver: bool = False) -> bool:
    """True iff `value` satisfies the comma-separated constraint `spec`.
    semver mode: pre-release values only match when every constraint
    operand also carries a pre-release (hashicorp/go-version
    WithoutPrerelease semantics used by ConstraintSemver)."""
    try:
        v = Version(value)
        cons = parse_constraints(spec)
    except ValueError:
        return False
    if semver and v.prerelease and not all(t.prerelease for _, t in cons):
        return False
    return all(_check_one(op, v, target) for op, target in cons)
