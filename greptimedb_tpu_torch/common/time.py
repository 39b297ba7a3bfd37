"""Timestamps with multiple units and time ranges.

Reference behavior: src/common/time/src/{timestamp.rs,range.rs} — a
`Timestamp` is an i64 value plus a unit (s/ms/us/ns); conversions between
units; `TimestampRange` is a half-open [start, end) range used for SST
pruning and window queries.
"""

from __future__ import annotations

import datetime as _dt
import enum
import re
from dataclasses import dataclass
from typing import Optional


class TimeUnit(enum.Enum):
    SECOND = "s"
    MILLISECOND = "ms"
    MICROSECOND = "us"
    NANOSECOND = "ns"

    @property
    def factor(self) -> int:
        """Ticks of this unit per second... inverted: number of this unit in one second."""
        return _FACTORS[self]

    def short_name(self) -> str:
        return self.value


_FACTORS = {
    TimeUnit.SECOND: 1,
    TimeUnit.MILLISECOND: 1_000,
    TimeUnit.MICROSECOND: 1_000_000,
    TimeUnit.NANOSECOND: 1_000_000_000,
}

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


@dataclass(frozen=True, order=False, eq=False)
class Timestamp:
    value: int
    unit: TimeUnit = TimeUnit.MILLISECOND

    def convert_to(self, unit: TimeUnit) -> "Timestamp":
        """Convert to another unit. Down-conversion truncates toward
        negative infinity (floor), matching integer arithmetic on the
        storage path."""
        if unit == self.unit:
            return self
        sf, tf = self.unit.factor, unit.factor
        if tf >= sf:
            mul = tf // sf
            return Timestamp(self.value * mul, unit)
        div = sf // tf
        # floor division keeps ordering for negative timestamps
        return Timestamp(self.value // div, unit)

    def to_millis(self) -> int:
        return self.convert_to(TimeUnit.MILLISECOND).value

    def to_datetime(self) -> _dt.datetime:
        # integer path: microsecond resolution is datetime's limit anyway
        us = Timestamp(self.value, self.unit).convert_to(TimeUnit.MICROSECOND).value
        return _EPOCH + _dt.timedelta(microseconds=us)

    def to_iso8601(self) -> str:
        return self.to_datetime().isoformat()

    @staticmethod
    def from_datetime(dt: _dt.datetime, unit: TimeUnit = TimeUnit.MILLISECOND) -> "Timestamp":
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        delta = dt - _EPOCH
        # integer arithmetic: float total_seconds() loses ns/us precision
        us = (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds
        return Timestamp(us, TimeUnit.MICROSECOND).convert_to(unit)

    @staticmethod
    def from_str(s: str, unit: TimeUnit = TimeUnit.MILLISECOND) -> "Timestamp":
        """Parse '2023-01-02 03:04:05[.fff]' / ISO8601 / raw integer strings."""
        s = s.strip()
        if re.fullmatch(r"[+-]?\d+", s):
            return Timestamp(int(s), unit)
        txt = s.replace("T", " ")
        # strip timezone suffix 'Z' or +hh:mm
        tz = _dt.timezone.utc
        m = re.search(r"([+-]\d{2}:?\d{2}|Z)$", txt)
        if m:
            suffix = m.group(1)
            txt = txt[: m.start()].strip()
            if suffix not in ("Z", "+00:00", "+0000"):
                sign = 1 if suffix[0] == "+" else -1
                hh = int(suffix[1:3])
                mm = int(suffix[-2:])
                tz = _dt.timezone(sign * _dt.timedelta(hours=hh, minutes=mm))
        fmts = ["%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"]
        for fmt in fmts:
            try:
                dt = _dt.datetime.strptime(txt, fmt).replace(tzinfo=tz)
                return Timestamp.from_datetime(dt, unit)
            except ValueError:
                continue
        raise ValueError(f"invalid timestamp literal: {s!r}")

    # ordering/equality/hash all compare the actual instant, across units
    def _cmp_key(self) -> int:
        return self.convert_to(TimeUnit.NANOSECOND).value

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Timestamp):
            return NotImplemented
        return self._cmp_key() == other._cmp_key()

    def __hash__(self) -> int:
        return hash(self._cmp_key())

    def __lt__(self, other: "Timestamp") -> bool:
        return self._cmp_key() < other._cmp_key()

    def __le__(self, other: "Timestamp") -> bool:
        return self._cmp_key() <= other._cmp_key()

    def __gt__(self, other: "Timestamp") -> bool:
        return self._cmp_key() > other._cmp_key()

    def __ge__(self, other: "Timestamp") -> bool:
        return self._cmp_key() >= other._cmp_key()


@dataclass(frozen=True)
class TimestampRange:
    """Half-open range [start, end) in a single unit; None = unbounded."""

    start: Optional[int] = None
    end: Optional[int] = None
    unit: TimeUnit = TimeUnit.MILLISECOND

    def is_empty(self) -> bool:
        return self.start is not None and self.end is not None and self.start >= self.end

    def contains(self, value: int) -> bool:
        if self.start is not None and value < self.start:
            return False
        if self.end is not None and value >= self.end:
            return False
        return True

    def intersects(self, other: "TimestampRange") -> bool:
        assert self.unit == other.unit, "unit mismatch"
        lo = max(x for x in (self.start, other.start) if x is not None) \
            if (self.start is not None or other.start is not None) else None
        hi = min(x for x in (self.end, other.end) if x is not None) \
            if (self.end is not None or other.end is not None) else None
        if lo is None or hi is None:
            return True
        return lo < hi

    def intersect(self, other: "TimestampRange") -> "TimestampRange":
        assert self.unit == other.unit
        starts = [x for x in (self.start, other.start) if x is not None]
        ends = [x for x in (self.end, other.end) if x is not None]
        return TimestampRange(max(starts) if starts else None,
                              min(ends) if ends else None, self.unit)


_DURATION_RE = re.compile(
    r"(?P<value>\d+(?:\.\d+)?)(?P<unit>ms|us|ns|[smhdwy])")


def parse_duration_ms(s: str) -> int:
    """Parse PromQL/humantime-style durations ('5m', '1h30m', '100ms') → ms."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {s!r}")
        pos = m.end()
        v = float(m.group("value"))
        u = m.group("unit")
        mult = {
            "ns": 1e-6, "us": 1e-3, "ms": 1.0, "s": 1e3, "m": 6e4,
            "h": 3.6e6, "d": 8.64e7, "w": 6.048e8, "y": 3.1536e10,
        }[u]
        total += v * mult
    if pos != len(s):
        raise ValueError(f"invalid duration: {s!r}")
    return int(total)


def parse_prom_time(v, default: Optional[float] = None) -> Optional[int]:
    """Prometheus API time parameter: unix seconds (float/str) or RFC3339
    → epoch ms (reference: src/servers/src/prom.rs query params)."""
    if v is None or v == "":
        if default is None:
            return None
        return int(float(default) * 1000)
    if isinstance(v, (int, float)):
        return int(float(v) * 1000)
    s = str(v).strip().strip("'\"")
    try:
        return int(float(s) * 1000)
    except ValueError:
        pass
    # RFC3339 through this module's own parser: the port needs no pandas
    return Timestamp.from_str(s, TimeUnit.MILLISECOND).value


def parse_prom_duration(v) -> int:
    """Prometheus step/duration parameter: '15s' / '1m' / bare seconds → ms."""
    if isinstance(v, (int, float)):
        return int(float(v) * 1000)
    s = str(v).strip().strip("'\"")
    try:
        return int(float(s) * 1000)
    except ValueError:
        pass
    try:
        return parse_duration_ms(s)
    except ValueError as e:
        from ..errors import InvalidArgumentsError
        raise InvalidArgumentsError(f"invalid duration {v!r}") from e
