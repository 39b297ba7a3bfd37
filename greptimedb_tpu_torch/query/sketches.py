"""Sketch partials for distributed aggregation.

The partial-state algebra of `tpu_exec` ships decomposable *moments*
(sum/count/min/max/...) so distributed GROUP BY never moves raw rows.
Two aggregate families break that algebra — ``count(DISTINCT x)`` and
percentiles — because their exact state is the whole value set. This
module supplies mergeable sketch partials for both, the reference shape
being DataFusion's ``approx_distinct`` (HyperLogLog) and
``approx_percentile_cont`` (t-digest) accumulators:

- :class:`DistinctSketch` — exact value set below a bounded size (the
  partial IS the deduplicated value set, so small-cardinality
  ``count(DISTINCT)`` stays exact end to end), degrading to a dense
  HyperLogLog past the bound (documented standard error
  ``1.04/sqrt(2^p)`` ≈ 0.8% at the default p=14). ``SET
  exact_distinct = 1`` refuses the sketch path entirely and forces the
  raw-row fallback.
- :class:`TDigest` — Dunning's merging t-digest with the k1
  (arcsin) scale function; rank error ≈ ``1/delta`` near the median
  and tighter in the tails (default delta=200 → well under 1% on p95).

Both are associative and commutative under :meth:`merge`, so datanodes
build per-group sketches, slices fold into regions, regions into the
statement — the exact same fold tree the numeric moments ride.

Wire codec: ``encode_sketch`` / ``decode_sketch`` frame every partial as
``magic + version + type + payload + crc32``. A corrupt or truncated
frame raises the typed :class:`SketchCodecError` (never a wrong answer):
the frontend counts ``greptime_sketch_degrade_total`` and retries the
statement through the raw-row path. The ``sketch_codec`` failpoint
injects exactly that.

Ported whole from greptimedb_tpu/query/sketches.py (numpy only): the
registers, centroids and frames are bit-identical to the reference's.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Union

import numpy as np

from ..common.failpoint import fail_point, register as _fp_register
from ..errors import InvalidArgumentsError, SketchCodecError
from ..utils import env_flag

_fp_register("sketch_codec")

# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

#: per-group value-set bound below which count(DISTINCT) partials stay
#: an exact set; past it the partial degrades to HLL
EXACT_SET_LIMIT = 4096

#: SET exact_distinct = 1 — refuse sketch partials for count(DISTINCT)
#: and take the raw-row path (exact at any cardinality, full wire cost)
_EXACT_DISTINCT = [env_flag("GREPTIME_EXACT_DISTINCT", False)]

#: SET approx_error_target — drives the HLL precision p
#: (1.04/sqrt(2^p) <= target) and the t-digest compression
#: (delta ~ 1/target); default 0.01
_ERROR_TARGET = [0.01]
_HLL_P = [14]
_TDIGEST_DELTA = [200.0]


def configure(*, exact_distinct: Optional[bool] = None,
              error_target: Optional[float] = None) -> None:
    """SET exact_distinct / approx_error_target."""
    if exact_distinct is not None:
        _EXACT_DISTINCT[0] = bool(exact_distinct)
    if error_target is not None:
        t = float(error_target)
        if not (0.001 <= t <= 0.25):
            raise InvalidArgumentsError(
                f"approx_error_target must be in [0.001, 0.25], got {t}")
        _ERROR_TARGET[0] = t
        # HLL standard error is 1.04/sqrt(m), m = 2^p
        p = int(np.ceil(2 * np.log2(1.04 / t)))
        _HLL_P[0] = min(16, max(6, p))
        _TDIGEST_DELTA[0] = min(1000.0, max(50.0, 2.0 / t))


def exact_distinct_forced() -> bool:
    return _EXACT_DISTINCT[0]


def error_target() -> float:
    return _ERROR_TARGET[0]


def hll_precision() -> int:
    return _HLL_P[0]


def tdigest_delta() -> float:
    return _TDIGEST_DELTA[0]


# ---------------------------------------------------------------------------
# hashing (process-stable: sketches merge across processes and restarts)
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)
_SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def hash64(values: np.ndarray) -> np.ndarray:
    """Stable vectorized 64-bit hash. Numeric arrays hash their int64
    bit pattern through splitmix64; object arrays (strings) hash utf-8
    bytes through crc32 pairs folded into the same finalizer — never
    Python's seeded hash()."""
    a = np.asarray(values)
    if a.dtype == object or a.dtype.kind in "US":
        out = np.empty(len(a), dtype=np.uint64)
        for i, v in enumerate(a):
            b = str(v).encode("utf-8")
            out[i] = (zlib.crc32(b) << np.uint64(32)) | np.uint64(
                zlib.crc32(b, 0x9E3779B9))
        x = out
    else:
        if a.dtype.kind == "f":
            # canonicalize: -0.0 == 0.0 and all NaNs hash alike (callers
            # drop NaN-nulls before hashing, this is belt and braces)
            a = np.asarray(a, dtype=np.float64) + 0.0
            x = a.view(np.uint64).copy()
        else:
            x = a.astype(np.int64).view(np.uint64).copy()
    with np.errstate(over="ignore"):
        x = (x + _SPLITMIX_GAMMA)
        x ^= x >> np.uint64(30)
        x *= _SPLITMIX_C1
        x ^= x >> np.uint64(27)
        x *= _SPLITMIX_C2
        x ^= x >> np.uint64(31)
    return x


# ---------------------------------------------------------------------------
# HyperLogLog (dense registers)
# ---------------------------------------------------------------------------

class HyperLogLog:
    """Dense HLL over 64-bit hashes: 2^p uint8 registers; standard
    bias-corrected estimate with linear-counting small-range correction
    (the Flajolet et al. estimator DataFusion's approx_distinct uses)."""

    __slots__ = ("p", "registers")

    def __init__(self, p: Optional[int] = None,
                 registers: Optional[np.ndarray] = None):
        self.p = int(p if p is not None else _HLL_P[0])
        if not (4 <= self.p <= 18):
            raise InvalidArgumentsError(f"HLL precision {self.p}")
        m = 1 << self.p
        if registers is not None:
            if len(registers) != m:
                raise SketchCodecError(
                    f"HLL register count {len(registers)} != 2^{self.p}")
            self.registers = np.asarray(registers, dtype=np.uint8)
        else:
            self.registers = np.zeros(m, dtype=np.uint8)

    def add_hashes(self, h: np.ndarray) -> None:
        if len(h) == 0:
            return
        h = np.asarray(h, dtype=np.uint64)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        # rank = leading-zero count of the remaining 64-p bits, + 1
        rest = (h << np.uint64(self.p)) | np.uint64((1 << self.p) - 1)
        rank = np.zeros(len(h), dtype=np.uint8)
        probe = np.uint64(1) << np.uint64(63)
        live = np.ones(len(h), dtype=bool)
        for r in range(1, 64 - self.p + 2):
            hit = live & ((rest & probe) != 0)
            rank[hit] = r
            live &= ~hit
            if not live.any():
                break
            probe >>= np.uint64(1)
        np.maximum.at(self.registers, idx, rank)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.p != self.p:
            # precision changed mid-flight (SET approx_error_target):
            # fold the coarser way — rebuild at the smaller p by
            # folding register groups with max
            p = min(self.p, other.p)
            a, b = self._fold_to(p), other._fold_to(p)
            a.registers = np.maximum(a.registers, b.registers)
            return a
        self.registers = np.maximum(self.registers, other.registers)
        return self

    def _fold_to(self, p: int) -> "HyperLogLog":
        if p == self.p:
            out = HyperLogLog(p)
            out.registers = self.registers.copy()
            return out
        # max-fold is an upper-bound approximation of re-hashing; the
        # mid-statement precision change is a degenerate operator case
        m = 1 << p
        folded = self.registers.reshape(m, -1).max(axis=1)
        return HyperLogLog(p, folded)

    def estimate(self) -> float:
        m = float(len(self.registers))
        regs = self.registers.astype(np.float64)
        est = _hll_alpha(int(m)) * m * m / np.sum(np.power(2.0, -regs))
        if est <= 2.5 * m:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                return m * np.log(m / zeros)   # linear counting
        return float(est)

    def result(self) -> int:
        return int(round(self.estimate()))


def _hll_alpha(m: int) -> float:
    if m <= 16:
        return 0.673
    if m <= 32:
        return 0.697
    if m <= 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


# ---------------------------------------------------------------------------
# distinct sketch: exact value set below the bound, HLL past it
# ---------------------------------------------------------------------------

class DistinctSketch:
    """count(DISTINCT) partial. ``values`` is the exact deduplicated
    value set (numeric ndarray or list of strings) while it fits under
    ``EXACT_SET_LIMIT``; ``hll`` takes over past the bound. NULLs are
    excluded by the caller (SQL count distinct ignores them)."""

    __slots__ = ("values", "hll")

    def __init__(self, values=None, hll: Optional[HyperLogLog] = None):
        self.values = values
        self.hll = hll

    @property
    def exact(self) -> bool:
        return self.hll is None

    @classmethod
    def from_values(cls, values: np.ndarray) -> "DistinctSketch":
        a = np.asarray(values)
        if a.dtype == object or a.dtype.kind in "US":
            uniq = sorted({str(v) for v in a if v is not None})
            sk = cls(values=uniq)
        else:
            if a.dtype.kind == "f":
                a = a[~np.isnan(a)] + 0.0    # drop NaN, fold -0.0
            sk = cls(values=np.unique(a))
        if len(sk.values) > EXACT_SET_LIMIT:
            sk._degrade()
        return sk

    def _degrade(self) -> None:
        from ..common.telemetry import increment_counter
        hll = HyperLogLog()
        if isinstance(self.values, list):
            hll.add_hashes(hash64(np.asarray(self.values, dtype=object)))
        else:
            hll.add_hashes(hash64(self.values))
        self.values = None
        self.hll = hll
        increment_counter("distinct_exact_to_hll")

    def merge(self, other: "DistinctSketch") -> "DistinctSketch":
        if self.exact and other.exact:
            if isinstance(self.values, list) or isinstance(other.values,
                                                           list):
                a = self.values if isinstance(self.values, list) \
                    else [str(v) for v in self.values]
                b = other.values if isinstance(other.values, list) \
                    else [str(v) for v in other.values]
                self.values = sorted(set(a) | set(b))
            else:
                self.values = np.union1d(self.values, other.values)
            if len(self.values) > EXACT_SET_LIMIT:
                self._degrade()
            return self
        if self.exact:
            self._degrade()
        if other.exact:
            other = DistinctSketch(values=other.values)
            other._degrade()
        self.hll = self.hll.merge(other.hll)
        return self

    def result(self) -> int:
        if self.exact:
            return len(self.values)
        return self.hll.result()


# ---------------------------------------------------------------------------
# merging t-digest (Dunning), k1 / arcsin scale function
# ---------------------------------------------------------------------------

class TDigest:
    """Weighted centroids (mean-sorted) + an unmerged buffer; compress
    merges adjacent centroids while the k1 scale function's q-width
    budget holds, keeping centroid count O(delta) regardless of input
    size. merge() is buffer concatenation + compress, so digests fold
    across slices/regions/datanodes like any moment."""

    __slots__ = ("delta", "means", "weights", "_buf_means", "_buf_weights")

    def __init__(self, delta: Optional[float] = None,
                 means: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None):
        self.delta = float(delta if delta is not None else _TDIGEST_DELTA[0])
        self.means = np.asarray(means, dtype=np.float64) \
            if means is not None else np.empty(0, np.float64)
        self.weights = np.asarray(weights, dtype=np.float64) \
            if weights is not None else np.empty(0, np.float64)
        self._buf_means: List[np.ndarray] = []
        self._buf_weights: List[np.ndarray] = []

    @classmethod
    def from_values(cls, values: np.ndarray) -> "TDigest":
        d = cls()
        d.add(values)
        d.compress()
        return d

    def add(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64)
        v = v[~np.isnan(v)]
        if len(v):
            self._buf_means.append(v)
            self._buf_weights.append(np.ones(len(v), np.float64))

    def merge(self, other: "TDigest") -> "TDigest":
        if len(other.means):
            self._buf_means.append(other.means)
            self._buf_weights.append(other.weights)
        self._buf_means.extend(other._buf_means)
        self._buf_weights.extend(other._buf_weights)
        self.delta = max(self.delta, other.delta)
        self.compress()
        return self

    def _k(self, q: np.ndarray) -> np.ndarray:
        return (self.delta / (2 * np.pi)) * np.arcsin(
            np.clip(2 * q - 1, -1.0, 1.0))

    def compress(self) -> None:
        """Vectorized k-cell compression: sort points/centroids by
        mean, map each midpoint quantile through the k1 scale, and
        merge everything sharing a k-cell (floor(k)) with one reduceat
        pass — every cluster's k-width stays <= 1, the t-digest
        invariant, with no per-point Python loop."""
        if not self._buf_means and len(self.means) <= self.delta * 3:
            return
        means = np.concatenate([self.means] + self._buf_means) \
            if self._buf_means else self.means
        weights = np.concatenate([self.weights] + self._buf_weights) \
            if self._buf_weights else self.weights
        self._buf_means, self._buf_weights = [], []
        if len(means) == 0:
            return
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        total = float(weights.sum())
        qmid = (np.cumsum(weights) - weights / 2.0) / total
        cell = np.floor(self._k(qmid)).astype(np.int64)
        starts_mask = np.empty(len(cell), dtype=bool)
        starts_mask[0] = True
        np.not_equal(cell[1:], cell[:-1], out=starts_mask[1:])
        starts = np.nonzero(starts_mask)[0]
        w = np.add.reduceat(weights, starts)
        m = np.add.reduceat(means * weights, starts) / w
        self.means = m
        self.weights = w

    @property
    def count(self) -> float:
        n = float(self.weights.sum()) if len(self.weights) else 0.0
        for w in self._buf_weights:
            n += float(w.sum())
        return n

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile q in [0, 100] (SQL percentile convention),
        interpolated through centroid midpoints."""
        self.compress()
        if not len(self.means):
            return None
        q = float(q) / 100.0
        if len(self.means) == 1:
            return float(self.means[0])
        total = float(self.weights.sum())
        target = q * total
        # cumulative weight at each centroid's MIDPOINT
        cum = np.cumsum(self.weights) - self.weights / 2.0
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = int(np.searchsorted(cum, target) - 1)
        span = cum[i + 1] - cum[i]
        frac = (target - cum[i]) / span if span > 0 else 0.0
        return float(self.means[i] + frac * (self.means[i + 1] -
                                             self.means[i]))


# ---------------------------------------------------------------------------
# wire codec: magic + version + type + payload + crc32
# ---------------------------------------------------------------------------

_MAGIC = b"GSK"
_VERSION = 1
_T_DISTINCT_NUM = 1
_T_DISTINCT_STR = 2
_T_DISTINCT_HLL = 3
_T_TDIGEST = 4

Sketch = Union[DistinctSketch, TDigest]


def encode_sketch(sk: Sketch) -> bytes:
    """Versioned + crc32'd frame for one sketch partial."""
    if isinstance(sk, TDigest):
        sk.compress()
        payload = struct.pack("<dI", sk.delta, len(sk.means)) + \
            sk.means.astype("<f8").tobytes() + \
            sk.weights.astype("<f8").tobytes()
        body = _MAGIC + bytes([_VERSION, _T_TDIGEST]) + payload
    elif isinstance(sk, DistinctSketch):
        if not sk.exact:
            payload = bytes([sk.hll.p]) + sk.hll.registers.tobytes()
            body = _MAGIC + bytes([_VERSION, _T_DISTINCT_HLL]) + payload
        elif isinstance(sk.values, list):
            parts = [struct.pack("<I", len(sk.values))]
            for s in sk.values:
                b = s.encode("utf-8")
                parts.append(struct.pack("<I", len(b)))
                parts.append(b)
            body = _MAGIC + bytes([_VERSION, _T_DISTINCT_STR]) + \
                b"".join(parts)
        else:
            a = np.asarray(sk.values)
            tag = b"i" if a.dtype.kind in "iu" else b"f"
            arr = a.astype("<i8") if tag == b"i" else a.astype("<f8")
            payload = tag + struct.pack("<I", len(arr)) + arr.tobytes()
            body = _MAGIC + bytes([_VERSION, _T_DISTINCT_NUM]) + payload
    else:
        raise SketchCodecError(f"cannot encode {type(sk).__name__}")
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def decode_sketch(data: bytes) -> Sketch:
    """Decode one sketch frame; raises SketchCodecError on any corrupt,
    truncated or version-skewed frame — a bad partial must surface as a
    typed error (the statement retries raw), never a wrong answer."""
    try:
        fail_point("sketch_codec")
    except Exception as e:
        # the failpoint models a corrupt frame off the wire: it must
        # surface as the SAME typed error real corruption raises, so
        # the degrade path under test IS the production path
        raise SketchCodecError(f"injected sketch corruption: {e}") from e
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise SketchCodecError(
            f"sketch frame is {type(data).__name__}, not bytes")
    data = bytes(data)
    if len(data) < len(_MAGIC) + 2 + 4:
        raise SketchCodecError(f"truncated sketch frame ({len(data)}B)")
    body, crc_raw = data[:-4], data[-4:]
    (crc,) = struct.unpack("<I", crc_raw)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise SketchCodecError("sketch frame crc mismatch")
    if body[:3] != _MAGIC:
        raise SketchCodecError("bad sketch magic")
    version, kind = body[3], body[4]
    if version != _VERSION:
        raise SketchCodecError(f"unsupported sketch codec version "
                               f"{version} (expected {_VERSION})")
    payload = body[5:]
    try:
        if kind == _T_TDIGEST:
            delta, n = struct.unpack_from("<dI", payload, 0)
            off = 12
            need = off + 16 * n
            if len(payload) < need:
                raise SketchCodecError("truncated t-digest payload")
            means = np.frombuffer(payload, "<f8", n, off)
            weights = np.frombuffer(payload, "<f8", n, off + 8 * n)
            return TDigest(delta, means.copy(), weights.copy())
        if kind == _T_DISTINCT_HLL:
            p = payload[0]
            regs = np.frombuffer(payload, np.uint8, offset=1)
            return DistinctSketch(hll=HyperLogLog(p, regs.copy()))
        if kind == _T_DISTINCT_NUM:
            tag = payload[:1]
            (n,) = struct.unpack_from("<I", payload, 1)
            if len(payload) < 5 + 8 * n:
                raise SketchCodecError("truncated distinct payload")
            dt = "<i8" if tag == b"i" else "<f8"
            vals = np.frombuffer(payload, dt, n, 5)
            return DistinctSketch(values=vals.copy())
        if kind == _T_DISTINCT_STR:
            (n,) = struct.unpack_from("<I", payload, 0)
            off = 4
            vals: List[str] = []
            for _ in range(n):
                (ln,) = struct.unpack_from("<I", payload, off)
                off += 4
                vals.append(payload[off:off + ln].decode("utf-8"))
                off += ln
            return DistinctSketch(values=vals)
    except SketchCodecError:
        raise
    except Exception as e:
        raise SketchCodecError(f"corrupt sketch payload: {e}") from e
    raise SketchCodecError(f"unknown sketch type {kind}")
