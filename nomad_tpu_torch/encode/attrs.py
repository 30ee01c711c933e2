"""Attribute codec: string node attributes -> numeric codes.

The reference evaluates constraints per node with string operations
(scheduler/feasible.go:769-841 resolveTarget/checkConstraint).  Here we
instead pre-encode every referenced attribute column into
- a **hash code** column (int64, stable blake2b) for =, !=, is_set ops, and
- an **ordinal code** column (int32 rank within the lexically sorted distinct
  values, -1 = missing) for <, <=, >, >= lexical ordering
so a constraint becomes a vectorized integer comparison over all nodes at
once.  regexp / version / semver / set_contains operators are evaluated on
the host over *distinct values only* and scattered into a boolean mask
column (the analog of the reference's "escaped" constraints,
scheduler/context.go:252-420).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MISSING_CODE = np.int64(0)


def hash_code(value: str) -> np.int64:
    """Stable 63-bit non-zero hash of a string value."""
    h = int.from_bytes(hashlib.blake2b(value.encode(), digest_size=8).digest(),
                       "little") & 0x7FFF_FFFF_FFFF_FFFF
    if h == 0:
        h = 1
    return np.int64(h)


class AttrColumn:
    """One attribute column over the node axis."""

    __slots__ = ("name", "values", "hash_codes", "_ordinals", "_order_dirty")

    def __init__(self, name: str, n: int):
        self.name = name
        self.values: List[Optional[str]] = [None] * n
        self.hash_codes = np.zeros(n, dtype=np.int64)
        self._ordinals: Optional[np.ndarray] = None
        self._order_dirty = True

    def resize(self, n: int) -> None:
        cur = len(self.values)
        if n <= cur:
            return
        self.values.extend([None] * (n - cur))
        self.hash_codes = np.concatenate(
            [self.hash_codes, np.zeros(n - cur, dtype=np.int64)])
        self._order_dirty = True

    def set(self, row: int, value: Optional[str]) -> None:
        self.values[row] = value
        self.hash_codes[row] = MISSING_CODE if value is None else hash_code(value)
        self._order_dirty = True

    def ordinals(self) -> np.ndarray:
        """int32 rank of each row's value among the sorted distinct values;
        -1 where missing.  Lexical ordering matches the reference's
        checkLexicalOrder (plain string comparison)."""
        if self._order_dirty or self._ordinals is None:
            distinct = sorted({v for v in self.values if v is not None})
            rank = {v: i for i, v in enumerate(distinct)}
            self._ordinals = np.array(
                [rank[v] if v is not None else -1 for v in self.values],
                dtype=np.int32)
            self._order_dirty = False
        return self._ordinals

    def ordinal_of(self, value: str) -> Tuple[int, bool]:
        """(rank r, exact) such that value sorts at position r among distinct
        node values.  If not an exact member, r is the insertion point and
        callers must use half-open comparisons."""
        distinct = sorted({v for v in self.values if v is not None})
        import bisect
        i = bisect.bisect_left(distinct, value)
        exact = i < len(distinct) and distinct[i] == value
        return i, exact

    def distinct(self) -> List[str]:
        return sorted({v for v in self.values if v is not None})

    def host_mask(self, predicate) -> np.ndarray:
        """Evaluate `predicate(value)->bool` over distinct values, scatter to
        a bool mask over rows (missing rows -> False)."""
        table = {v: bool(predicate(v)) for v in {x for x in self.values if x is not None}}
        return np.array([table.get(v, False) for v in self.values], dtype=bool)


class AttrTable:
    """All attribute columns for a set of nodes.

    Column names follow the reference's interpolation targets
    (feasible.go:769-802): "node.unique.id", "node.datacenter",
    "node.unique.name", "node.class", "attr.<key>", "meta.<key>".
    Driver columns are exposed as "attr.driver.<name>" like the reference.
    """

    def __init__(self, n: int = 0):
        self.n = n
        self.columns: Dict[str, AttrColumn] = {}

    def column(self, name: str) -> AttrColumn:
        col = self.columns.get(name)
        if col is None:
            col = AttrColumn(name, self.n)
            self.columns[name] = col
        return col

    def resize(self, n: int) -> None:
        self.n = n
        for col in self.columns.values():
            col.resize(n)

    def set_node_row(self, row: int, node) -> None:
        """Populate every column for one node (creates columns on demand for
        attrs this node carries; other rows stay missing)."""
        self.column("node.unique.id").set(row, node.id)
        self.column("node.datacenter").set(row, node.datacenter)
        self.column("node.unique.name").set(row, node.name)
        self.column("node.class").set(row, node.node_class)
        seen = {"node.unique.id", "node.datacenter", "node.unique.name", "node.class"}
        for k, v in node.attributes.items():
            name = f"attr.{k}"
            self.column(name).set(row, str(v))
            seen.add(name)
        for k, v in node.meta.items():
            name = f"meta.{k}"
            self.column(name).set(row, str(v))
            seen.add(name)
        # clear stale values in columns this node doesn't define
        for name, col in self.columns.items():
            if name not in seen:
                col.set(row, None)

    def clear_row(self, row: int) -> None:
        for col in self.columns.values():
            col.set(row, None)

    @staticmethod
    def target_to_column(target: str) -> Optional[str]:
        """Map a constraint LTarget interpolation to a column name; a
        non-interpolated target is a literal (returns None).  Mirrors
        resolveTarget (feasible.go:769-802)."""
        if not target.startswith("${"):
            return None
        inner = target[2:-1] if target.endswith("}") else target[2:]
        if inner in ("node.unique.id", "node.datacenter", "node.unique.name",
                     "node.class"):
            return inner
        if inner.startswith("attr.") or inner.startswith("meta."):
            return inner
        return "__unresolvable__"
