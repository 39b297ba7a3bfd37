"""Partition rules mapping rows → region numbers.

Range semantics follow MySQL RANGE COLUMNS as the reference does
(src/partition/src/columns.rs:49): regions are ordered by their exclusive
upper bounds; a row belongs to the first region whose bound tuple is
strictly greater than the row's partition-column tuple. MAXVALUE sorts
above everything. Hash semantics follow MySQL PARTITION BY HASH with a
process-independent hash (crc32 over a canonical encoding — Python's
builtin `hash` is salted per process and would scatter a table's rows
differently on every datanode restart).

`find_regions_by_filters` prunes the region set by the query's
predicates (reference: src/partition/src/manager.rs:192). It may return
an EMPTY list — contradictory predicates (`host < 'a' AND host > 'z'`)
prove no region can hold a matching row, and the distributed scatter
then contacts nobody.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


class _MaxValue:
    """Sorts above every concrete value (singleton MAXVALUE sentinel)."""

    def __repr__(self) -> str:
        return "MAXVALUE"


MAXVALUE = _MaxValue()


def _lt(a: Any, b: Any) -> bool:
    """value < bound, where bound may be MAXVALUE."""
    if b is MAXVALUE:
        return True
    if a is MAXVALUE:
        return False
    return a < b


def _tuple_lt(row: Sequence, bound: Sequence) -> bool:
    for a, b in zip(row, bound):
        if _lt(a, b):
            return True
        if b is not MAXVALUE and a == b:
            continue
        return False
    return False


class PartitionRule:
    """Maps a row (tuple of partition-column values) to a region number."""

    def partition_columns(self) -> List[str]:
        raise NotImplementedError

    def find_region(self, values: Sequence) -> int:
        raise NotImplementedError

    def region_numbers(self) -> List[int]:
        raise NotImplementedError

    def find_regions_by_filters(self, filters: Sequence) -> List[int]:
        """Prune regions by simple predicates (reference:
        src/partition/src/manager.rs:192). May return an empty list when
        the predicates are contradictory. Default: no pruning."""
        return self.region_numbers()


@dataclass
class RangePartitionRule(PartitionRule):
    """Single-column range rule: bounds are exclusive upper bounds, sorted
    ascending, last may be MAXVALUE (reference: src/partition/src/range.rs:64)."""

    column: str
    bounds: List[Any]                  # len == number of regions
    regions: List[int]                 # region number per bound

    def partition_columns(self) -> List[str]:
        return [self.column]

    def region_numbers(self) -> List[int]:
        return list(self.regions)

    def find_region(self, values: Sequence) -> int:
        v = values[0] if isinstance(values, (list, tuple)) else values
        for bound, region in zip(self.bounds, self.regions):
            if _lt(v, bound):
                return region
        raise ValueError(
            f"value {v!r} above all partition bounds of {self.column!r} "
            f"(missing MAXVALUE partition)")

    def find_regions_by_filters(self, filters: Sequence) -> List[int]:
        from ..sql.ast import BinaryOp, Column, Literal
        cand = _equality_candidates(filters, [self.column])
        if self.column in cand:
            # equality / IN pins the column to a finite value set: map
            # each value to its region (a value above all bounds of a
            # MAXVALUE-less table matches no region at all)
            hit = set()
            for v in cand[self.column]:
                try:
                    hit.add(self.find_region(v))
                except ValueError:
                    pass
            return [r for r in self.regions if r in hit]
        lo: Optional[Any] = None       # conservative AND-only pruning
        hi: Optional[Any] = None
        hi_strict = False              # v < hi (True) vs v <= hi (False)

        def visit(e: Any) -> None:
            nonlocal lo, hi, hi_strict
            if isinstance(e, BinaryOp):
                if e.op == "and":
                    visit(e.left)
                    visit(e.right)
                    return
                col, lit, op = None, None, e.op
                if isinstance(e.left, Column) and isinstance(e.right, Literal):
                    col, lit = e.left, e.right
                elif isinstance(e.right, Column) and isinstance(e.left, Literal):
                    col, lit = e.right, e.left
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
                if col is None or col.name != self.column or lit.value is None:
                    return
                v = lit.value
                if op in ("<", "<="):
                    if hi is None or v < hi:
                        hi, hi_strict = v, op == "<"
                    elif v == hi and op == "<":
                        hi_strict = True
                elif op in (">", ">="):
                    lo = v if lo is None else max(lo, v)
                elif op == "=":
                    lo = v
                    if hi is None or v < hi:
                        hi, hi_strict = v, False

        for f in filters or ():
            visit(f)
        out = []
        prev_bound: Optional[Any] = None
        for bound, region in zip(self.bounds, self.regions):
            # region covers [prev_bound, bound)
            keep = True
            if lo is not None and not _lt(lo, bound):
                keep = False               # all region values <= lo
            if hi is not None and prev_bound is not None:
                if _lt(hi, prev_bound) or (hi == prev_bound and hi_strict):
                    keep = False           # all region values > hi
            if keep:
                out.append(region)
            prev_bound = bound
        return out


@dataclass
class RangeColumnsPartitionRule(PartitionRule):
    """Multi-column range rule with tuple bounds
    (reference: src/partition/src/columns.rs:49)."""

    columns: List[str]
    bounds: List[Tuple]                # tuple upper bound per region
    regions: List[int]

    def partition_columns(self) -> List[str]:
        return list(self.columns)

    def region_numbers(self) -> List[int]:
        return list(self.regions)

    def find_region(self, values: Sequence) -> int:
        for bound, region in zip(self.bounds, self.regions):
            if _tuple_lt(values, bound):
                return region
        raise ValueError(
            f"value {tuple(values)!r} above all partition bounds "
            f"(missing MAXVALUE partition)")

    def find_regions_by_filters(self, filters: Sequence) -> List[int]:
        if len(self.columns) == 1:
            return RangePartitionRule(
                self.columns[0], [b[0] for b in self.bounds],
                list(self.regions)).find_regions_by_filters(filters)
        return self.region_numbers()


def _equality_candidates(filters: Sequence,
                         columns: Sequence[str]) -> dict:
    """Per-column candidate value sets proven by the filters' equality /
    IN conjuncts: {col: set(values)} — a column absent means the filters
    do not pin it. Conservative AND-only walk; OR and non-literal shapes
    contribute nothing. An empty set means contradictory equalities."""
    from ..sql.ast import BinaryOp, Column, InList, Literal
    colset = set(columns)
    cand: dict = {}

    def narrow(name: str, values: set) -> None:
        cur = cand.get(name)
        cand[name] = values if cur is None else (cur & values)

    def visit(e: Any) -> None:
        if isinstance(e, BinaryOp):
            if e.op == "and":
                visit(e.left)
                visit(e.right)
                return
            if e.op != "=":
                return
            col, lit = None, None
            if isinstance(e.left, Column) and isinstance(e.right, Literal):
                col, lit = e.left, e.right
            elif isinstance(e.right, Column) and isinstance(e.left, Literal):
                col, lit = e.right, e.left
            if col is not None and col.name in colset and \
                    lit.value is not None:
                narrow(col.name, {lit.value})
            return
        if isinstance(e, InList) and not e.negated and \
                isinstance(e.expr, Column) and e.expr.name in colset:
            vals = set()
            for item in e.items:
                if not isinstance(item, Literal):
                    return             # non-literal member: unprovable
                if item.value is not None:
                    vals.add(item.value)
            narrow(e.expr.name, vals)

    for f in filters or ():
        visit(f)
    return cand


def _stable_hash_bytes(v: Any) -> bytes:
    """Canonical bytes for hashing a partition value: identical across
    processes, across int/float representations of the same number, and
    across numpy scalars vs Python builtins (ingest routes np.int64
    array values; query pruning routes Python literals — they MUST land
    in the same bucket)."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        v = v.item()                   # numpy scalar → Python builtin
    if isinstance(v, bool):
        v = int(v)                     # True == 1 must bucket like 1
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if isinstance(v, int):
        return b"i" + str(v).encode()
    if isinstance(v, bytes):
        return b"y" + v
    return b"s" + str(v).encode()


#: cap on how many equality-candidate combinations hash pruning will
#: enumerate — an adversarial IN list must not turn pruning into work
_MAX_HASH_COMBOS = 256


@dataclass
class HashPartitionRule(PartitionRule):
    """MySQL-style PARTITION BY HASH (col, ...) PARTITIONS n: a row maps
    to region crc32(values) % n. Equality / IN predicates covering every
    hash column prune to exactly the regions their value combinations
    hash to — the distributed point-query fast path."""

    columns: List[str]
    regions: List[int]                 # len == number of hash buckets

    def partition_columns(self) -> List[str]:
        return list(self.columns)

    def region_numbers(self) -> List[int]:
        return list(self.regions)

    def _bucket(self, values: Sequence) -> int:
        h = 0
        for v in values:
            h = zlib.crc32(_stable_hash_bytes(v), h)
        return h % len(self.regions)

    def find_region(self, values: Sequence) -> int:
        if not isinstance(values, (list, tuple)):
            values = (values,)
        if len(values) != len(self.columns):
            raise ValueError(
                f"hash rule over {self.columns} got {len(values)} values")
        return self.regions[self._bucket(values)]

    def find_regions_by_filters(self, filters: Sequence) -> List[int]:
        import itertools
        cand = _equality_candidates(filters, self.columns)
        if any(c in cand and not cand[c] for c in self.columns):
            return []                  # contradictory equalities: no rows
        if not all(c in cand for c in self.columns):
            return self.region_numbers()
        combos = 1
        for c in self.columns:
            combos *= len(cand[c])
        if combos > _MAX_HASH_COMBOS:
            return self.region_numbers()
        hit = {self.regions[self._bucket(vals)]
               for vals in itertools.product(
                   *(sorted(cand[c], key=repr) for c in self.columns))}
        return [r for r in self.regions if r in hit]


def rule_from_partitions(partitions: Any,
                         region_numbers: Optional[List[int]] = None
                         ) -> PartitionRule:
    """Build a rule from a parsed `sql.ast.Partitions` clause."""
    if getattr(partitions, "kind", "range") == "hash":
        n = int(partitions.num_partitions or 0)
        if n < 1:
            raise ValueError("PARTITION BY HASH requires PARTITIONS >= 1")
        regions = list(region_numbers) if region_numbers is not None \
            else list(range(n))
        if len(regions) != n:
            raise ValueError(
                f"hash rule needs {n} regions, got {len(regions)}")
        return HashPartitionRule(list(partitions.columns), regions)
    regions = list(region_numbers) if region_numbers is not None \
        else list(range(len(partitions.entries)))
    bounds = []
    for e in partitions.entries:
        bounds.append(tuple(MAXVALUE if v == "MAXVALUE" else v
                            for v in e.values))
    if len(partitions.columns) == 1:
        return RangePartitionRule(partitions.columns[0],
                                  [b[0] for b in bounds], regions)
    return RangeColumnsPartitionRule(list(partitions.columns), bounds, regions)
