// Sorted-segment moments on Hopper (sm_90a): every moment of an aggregate
// plan over runs of consecutive rows, in one launch (two passes).
//
// Replaces XLA code, not a Pallas kernel: the sorted-segment group-by of
// greptimedb_tpu/ops/kernels.py, sorted_grouped_aggregate (:730) ->
// _sorted_grouped_aggregate_pre (:757) -> _sga_body (:796), with its
// sub-kernels _sorted_seg_sum, _sorted_seg_minmax, _seg_minmax_doubling,
// _seg_argext_doubling and _sorted_seg_argext. Their 32-row blocks,
// sparse tables and shift-doubling passes exist because gathers were
// costly on the TPU; here each run is reduced where its rows lie.
//
// Input: rows sorted by run; run g is rows [ends[g-1], ends[g]) (ends[-1]
// = 0), ends non-decreasing and <= n; a row mask; per moment a value
// column (float32 or int32) and a column mask (or none). A row counts for
// a moment when row mask and column mask are both set; other rows stay in
// place and add the identity. Output per run: each moment and the row
// count (row mask only), in device memory the caller allocated.
//
//   count   int32   rows of the run that count
//   sum     float32 (double accumulation, rounded once) or int32 (wraps
//                   mod 2^32, as the reference's int32 accumulation does)
//   sum_sq  float32 sum of x*x, squares and sums in double
//   min/max column type; NaN propagates; empty: +-inf or INT32_MAX/MIN
//   first   value at the smallest (ts, row) among counted rows whose ts
//           is not INT32_MAX; empty: NaN (float) or 0 (int)
//   last    value at the largest (ts, row), ts not INT32_MIN; same empty
//
// ts is not assumed sorted inside a run (a run may span many series).
//
// Bound: bytes. The function must read the row mask and the run ends
// once, each distinct value column, column mask and (for first/last) ts
// once at the rows the row mask lets through, and write each output
// once; a handful of operations per row and moment is far below the
// card's double and integer rates. Run lengths range from one row to
// every row in one launch.
//
// Design: a row-tiled segmented reduction with a carry fold.
// - Pass 1: one block of kWarps warps per tile of kTile rows.
//   - Warps 0 and 1 find the runs that end in the tile, plus the run that
//     continues past it, by a 32-way search in ends (about five dependent
//     loads at 3 M runs). The block writes each run's piece of the tile
//     (start, end, inside or crossing) to shared memory, kChunk pieces at
//     a time, since empty runs leave a tile's piece count unbounded.
//   - The block loads the tile's row mask into shared memory once, one
//     16-byte load per thread, and each distinct column mask of the launch
//     ANDed with it (slot s of the mask array; a column mask equal to the
//     row mask is slot 0). Bytes become 0/1 there, so four rows' masks are
//     one 32-bit word and a count is a popcount. No moment reads a mask
//     from device memory again, and no value load waits on a mask load.
//   - __syncthreads_or says whether any row of the tile is live. A dead
//     tile loads no column mask, value or ts: every piece gets its
//     identity state (Q4's filter leaves 16 of 4219 tiles live).
//   - Pieces of at most kShort rows go one per lane, warp w taking the
//     moments m = w mod kWarps (the row count is one more moment), while
//     warp 0 also lists the longer pieces. Those go to a whole warp,
//     (piece, moment) pairs dealt round-robin over the warps: lanes stride
//     the rows in groups of four, one 16-byte load per group and column,
//     kVec groups in flight per lane, then a shuffle butterfly. A piece
//     start or end that is not a multiple of four is covered by scalar
//     loads, and a column pointer that is not 16-byte aligned (a view)
//     loads each group as four scalars.
//   - A run inside the tile is written to the output. A run that crosses
//     the tile's edge leaves a partial state in scratch: the "head" slot
//     for the run holding the tile's first row, the "tail" slot for a run
//     that starts inside the tile and continues past it.
// - Pass 2: one warp per tile folds the partials of the crossing run
//   that ends in that tile (pass 1 names it), from the tile where it
//   started, in a fixed order (lane strides, then a butterfly). A run over
//   more than kWarpFold tiles is folded by the block with one warp per
//   moment, each with kUnroll partials per lane in flight: one barrier per
//   block, none per moment.
// No atomics anywhere, and each (piece, moment) is reduced in a fixed
// order: the same inputs give the same bits on every run.
//
// What the card showed (PERF.md; python3 -m
// greptimedb_tpu_torch.tools.segment_moments_bench, device time behind a
// spin kernel, H100 80GB HBM3 at 700 W). The earlier design (a warp per
// tile, each moment re-reading the masks byte by byte, four bytes per
// value load) took 0.81 / 0.23 / 0.49 ms at the SQL path's Q1 / Q4 / Q6
// (27 / 14 / 14 % of the byte bound); this one takes 0.355 / 0.100 /
// 0.169 ms (61 / 33 / 40 %), 48 registers in pass 1. Timed beside it and
// not kept (copies changed in one place, timed with the tool's
// --source; PERF.md has the times): 4 warps per block, 2048-row tiles,
// 8 loads in flight per lane, 16 partials in flight in pass 2, pass 1
// held to fewer registers for more blocks per SM (spills), and L2
// prefetch of a warp's next piece or next loop trip (no gain).
// What holds Q1 and Q6, as far as these timings show, is the bytes in
// flight per SM: one piece's loads per warp at a time, and at Q6 two of
// eight warps load nothing (counts) while four read the same ts. Q4 moved
// with none of the variants; each of its 4219 blocks runs a chain of
// dependent steps (the search, the mask, the outputs), not measured.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMoments = 32;
constexpr int kTile = 4096;    // rows per block in pass 1
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kShort = 32;     // pieces up to this long go one per lane
constexpr int kVec = 4;        // 16-byte loads per lane in flight (pass 1)
constexpr int kUnroll = 8;     // partials per lane in flight (pass 2)
constexpr int kChunk = 512;    // run pieces in shared memory at a time
constexpr int kWarpFold = 64;  // pass 2: a warp folds runs over <= this many tiles
constexpr unsigned kFull = 0xffffffffu;

enum Op : int {
  kCount = 0, kSum = 1, kSumSq = 2, kMin = 3, kMax = 4, kFirst = 5,
  kLast = 6, kRows = 7  // kRows: the per-run row count (row mask only)
};

struct State {
  double f;              // sum, sum_sq, min, max
  unsigned long long u;  // count, int32 sum (mod 2^32 at the end)
  int key;               // first/last: ts of the chosen row
  int pos;               // first/last: the chosen row, -1 for none
};

struct Moment {
  const void* val;
  void* out;
  int op;
  int is_int;
  int slot;  // its mask in shared memory: 0 the row mask, s > 0 the row
             // mask AND Params::cmask[s - 1]
  int vec;   // val is 16-byte aligned
};

struct Params {
  const int* ends;
  const unsigned char* rmask;
  const int* ts;
  int* counts;      // nullptr: no row counts in this launch
  State* scratch;   // [ntiles][2][nmom + 1]
  int* fold_run;    // [ntiles]: run pass 2 folds in this tile, or -1
  int nruns;
  int n;
  int ntiles;
  int nmom;
  int nslots;       // distinct column masks (mask slots 1 .. nslots)
  int rmask_vec;    // rmask is 16-byte aligned
  int ts_vec;       // ts is 16-byte aligned
  unsigned cmask_vec;  // bit s: cmask[s] is 16-byte aligned
  const unsigned char* cmask[kMaxMoments];
  Moment mom[kMaxMoments];
};

__device__ __forceinline__ int run_start(const int* ends, int g) {
  return g ? __ldg(ends + g - 1) : 0;
}

// The first index in [0, len) whose value is > x (len if none), found by
// one warp with 32 probes per step.
__device__ int warp_upper_bound(const int* a, int len, int x, int lane) {
  int lo = 0, hi = len;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) / 32;
    const int i = lo + lane * stride;
    const bool le = i < hi && __ldg(a + i) <= x;
    const int c = __popc(__ballot_sync(kFull, le));
    if (c == 0) return lo;
    const int next_lo = lo + (c - 1) * stride + 1;
    hi = min(lo + c * stride, hi);
    lo = next_lo;
  }
  const int i = lo + lane;
  const bool le = i < hi && __ldg(a + i) <= x;
  return lo + __popc(__ballot_sync(kFull, le));
}

// NaN-propagating min / max (fmin/fmax would drop the NaN)
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ State init_state(int op) {
  State s;
  s.f = op == kMin ? INFINITY : (op == kMax ? -INFINITY : 0.0);
  s.u = 0;
  s.key = 0;
  s.pos = -1;
  return s;
}

__host__ __device__ constexpr bool reads_val(int op) {
  return op == kSum || op == kSumSq || op == kMin || op == kMax;
}
__host__ __device__ constexpr bool reads_ts(int op) {
  return op == kFirst || op == kLast;
}

__device__ __forceinline__ double word_val(unsigned w, int is_int) {
  return is_int ? static_cast<double>(static_cast<int>(w))
                : static_cast<double>(__uint_as_float(w));
}

// Row i (which counts for the moment) into s, given its value as a raw
// 32-bit word w (float32 or int32) and its ts k. Ties of ts go to the
// smaller (first) or larger (last) row, so rows may come in any order.
__device__ __forceinline__ void add_word(State& s, int op, int is_int,
                                         unsigned w, int k, int i) {
  switch (op) {
    case kCount:
    case kRows:
      s.u += 1;
      break;
    case kSum:
      if (is_int) s.u += w; else s.f += static_cast<double>(__uint_as_float(w));
      break;
    case kSumSq: {
      const double x = word_val(w, is_int);
      s.f += x * x;
      break;
    }
    case kMin:
      s.f = nan_min(s.f, word_val(w, is_int));
      break;
    case kMax:
      s.f = nan_max(s.f, word_val(w, is_int));
      break;
    case kFirst:
      if (k != INT_MAX &&
          (s.pos < 0 || k < s.key || (k == s.key && i < s.pos))) {
        s.key = k;
        s.pos = i;
      }
      break;
    case kLast:
      if (k != INT_MIN &&
          (s.pos < 0 || k > s.key || (k == s.key && i > s.pos))) {
        s.key = k;
        s.pos = i;
      }
      break;
    default:
      break;
  }
}

// a := a (+) b; commutative for every op, so both sides of a butterfly
// agree bit for bit.
__device__ __forceinline__ void combine(State& a, const State& b, int op,
                                        int is_int) {
  switch (op) {
    case kCount:
    case kRows:
      a.u += b.u;
      break;
    case kSum:
      if (is_int) a.u += b.u; else a.f += b.f;
      break;
    case kSumSq:
      a.f += b.f;
      break;
    case kMin:
      a.f = nan_min(a.f, b.f);
      break;
    case kMax:
      a.f = nan_max(a.f, b.f);
      break;
    case kFirst:
      if (b.pos >= 0 && (a.pos < 0 || b.key < a.key ||
                         (b.key == a.key && b.pos < a.pos))) {
        a.key = b.key;
        a.pos = b.pos;
      }
      break;
    case kLast:
      if (b.pos >= 0 && (a.pos < 0 || b.key > a.key ||
                         (b.key == a.key && b.pos > a.pos))) {
        a.key = b.key;
        a.pos = b.pos;
      }
      break;
    default:
      break;
  }
}

// Butterfly over the warp, shuffling only the fields the op uses.
__device__ __forceinline__ void warp_reduce(State& s, int op, int is_int) {
  const bool uses_f = op == kSumSq || op == kMin || op == kMax ||
                      (op == kSum && !is_int);
  const bool uses_pos = op == kFirst || op == kLast;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    State b = s;
    if (uses_pos) {
      b.key = __shfl_xor_sync(kFull, s.key, o);
      b.pos = __shfl_xor_sync(kFull, s.pos, o);
    } else if (uses_f) {
      b.f = __shfl_xor_sync(kFull, s.f, o);
    } else {
      b.u = __shfl_xor_sync(kFull, s.u, o);
    }
    combine(s, b, op, is_int);
  }
}

struct MomentView {
  const unsigned* val;
  int op;
  int is_int;
  int slot;
  bool vec;
};

__device__ __forceinline__ MomentView view(const Params& p, int m) {
  if (m == p.nmom) return MomentView{nullptr, kRows, 0, 0, false};
  const Moment& mo = p.mom[m];
  return MomentView{static_cast<const unsigned*>(mo.val), mo.op, mo.is_int,
                    mo.slot, mo.vec != 0};
}

// The op as compile-time constants: f(OpT<op, is_int>{}), so the inner
// loops carry no switch (kRows reduces as a count).
template <int O, bool I>
struct OpT {
  static constexpr int op = O;
  static constexpr bool is_int = I;
};

template <typename F>
__device__ __forceinline__ void with_op(int op, int is_int, F&& f) {
  switch (op) {
    case kCount:
    case kRows:
      f(OpT<kCount, false>{});
      break;
    case kSum:
      if (is_int) f(OpT<kSum, true>{}); else f(OpT<kSum, false>{});
      break;
    case kSumSq:
      if (is_int) f(OpT<kSumSq, true>{}); else f(OpT<kSumSq, false>{});
      break;
    case kMin:
      if (is_int) f(OpT<kMin, true>{}); else f(OpT<kMin, false>{});
      break;
    case kMax:
      if (is_int) f(OpT<kMax, true>{}); else f(OpT<kMax, false>{});
      break;
    case kFirst:
      f(OpT<kFirst, false>{});
      break;
    case kLast:
      f(OpT<kLast, false>{});
      break;
    default:
      break;
  }
}

// Moment m's output array, as 32-bit words (int32 or float32).
__device__ __forceinline__ unsigned* out_of(const Params& p, int m) {
  return m == p.nmom ? reinterpret_cast<unsigned*>(p.counts)
                     : static_cast<unsigned*>(p.mom[m].out);
}

// Moment m's output word for the final state s.
__device__ unsigned out_word(const Params& p, int m, const State& s) {
  if (m == p.nmom) return static_cast<unsigned>(s.u);
  const Moment& mo = p.mom[m];
  switch (mo.op) {
    case kCount:
      return static_cast<unsigned>(s.u);
    case kSum:
      return mo.is_int ? static_cast<unsigned>(s.u)
                       : __float_as_uint(static_cast<float>(s.f));
    case kSumSq:
      return __float_as_uint(static_cast<float>(s.f));
    case kMin:
    case kMax:
      if (!mo.is_int) return __float_as_uint(static_cast<float>(s.f));
      return static_cast<unsigned>(
          s.f == INFINITY ? INT_MAX
                          : (s.f == -INFINITY ? INT_MIN
                                              : static_cast<int>(s.f)));
    case kFirst:
    case kLast:
      if (s.pos >= 0) return __ldg(static_cast<const unsigned*>(mo.val) + s.pos);
      return mo.is_int ? 0u : __float_as_uint(NAN);
    default:
      return 0u;
  }
}

__device__ __forceinline__ void write_out(const Params& p, int m, int g,
                                          const State& s) {
  out_of(p, m)[g] = out_word(p, m, s);
}

__device__ __forceinline__ State* slot_ptr(const Params& p, int tile,
                                           int slot, int m) {
  return p.scratch +
         (static_cast<long long>(tile) * 2 + slot) * (p.nmom + 1) + m;
}

// The result of run g's piece [ps, pe) in `tile`: final when the run lies
// inside the tile, else a partial in the head (ps == r0) or tail slot.
__device__ __forceinline__ void emit(const Params& p, int tile, int r0, int g,
                                     int ps, bool inside, int m,
                                     const State& s) {
  if (inside)
    write_out(p, m, g, s);
  else
    *slot_ptr(p, tile, ps == r0 ? 0 : 1, m) = s;
}

// Each byte 0 or 1: whether it was nonzero.
__device__ __forceinline__ unsigned nz_bytes(unsigned x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

// Rows [r0, r1) of src into dst[0, kTile) as 0/1 bytes (0 past r1), ANDed
// with `with` when given; one 16-byte load per thread and kTile / 16
// rows. Returns whether any of this thread's bytes is set.
__device__ __forceinline__ bool stage_mask(unsigned char* dst,
                                           const unsigned char* src, bool vec,
                                           int r0, int r1,
                                           const unsigned char* with) {
  unsigned any = 0;
  for (int v = threadIdx.x; v < kTile / 16; v += kThreads) {
    const int row = r0 + v * 16;
    unsigned w[4];
    if (vec && row + 16 <= r1) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + row));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = row + j * 4 + b;
          if (i < r1) w[j] |= static_cast<unsigned>(__ldg(src + i)) << (8 * b);
        }
      }
    }
    uint4 out;
    out.x = nz_bytes(w[0]);
    out.y = nz_bytes(w[1]);
    out.z = nz_bytes(w[2]);
    out.w = nz_bytes(w[3]);
    if (with != nullptr) {
      const uint4 m = reinterpret_cast<const uint4*>(with)[v];
      out.x &= m.x; out.y &= m.y; out.z &= m.z; out.w &= m.w;
    }
    reinterpret_cast<uint4*>(dst)[v] = out;
    any |= out.x | out.y | out.z | out.w;
  }
  return any != 0;
}

// Rows r .. r + 3 of a 32-bit column: one 16-byte load when it is aligned.
__device__ __forceinline__ uint4 load4(const unsigned* p, int r, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + r));
  return make_uint4(__ldg(p + r), __ldg(p + r + 1), __ldg(p + r + 2),
                    __ldg(p + r + 3));
}

// A piece [ps, pe) of at most kShort rows, by one lane; sm is the
// moment's mask of the tile starting at row r0.
template <int OP, bool INT>
__device__ __forceinline__ State lane_piece(const unsigned char* sm,
                                            const unsigned* val,
                                            const int* ts, int r0, int ps,
                                            int pe) {
  State st = init_state(OP);
#pragma unroll 4
  for (int i = ps; i < pe; ++i)
    if (sm[i - r0])
      add_word(st, OP, INT, reads_val(OP) ? __ldg(val + i) : 0u,
               reads_ts(OP) ? __ldg(ts + i) : 0, i);
  return st;
}

// A longer piece by the whole warp: lanes stride groups of four rows,
// kVec groups in flight per lane, then the butterfly.
template <int OP, bool INT>
__device__ __forceinline__ State warp_piece(const unsigned char* sm,
                                            const unsigned* val, bool vvec,
                                            const int* ts, bool tvec, int r0,
                                            int ps, int pe, int lane) {
  constexpr bool kVal = reads_val(OP), kTs = reads_ts(OP);
  const unsigned* tsw = reinterpret_cast<const unsigned*>(ts);
  State st = init_state(OP);
  const int q0 = min((ps + 3) & ~3, pe);  // groups cover [q0, q1)
  const int q1 = max(pe & ~3, q0);
  {
    // at most three rows before q0 (lanes 0-2) and three from q1 (3-5)
    const int i = lane < 3 ? ps + lane : q1 + lane - 3;
    if (lane < 6 && i < (lane < 3 ? q0 : pe) && sm[i - r0])
      add_word(st, OP, INT, kVal ? __ldg(val + i) : 0u,
               kTs ? __ldg(ts + i) : 0, i);
  }
  for (int base = q0 + 4 * lane; base < q1; base += 4 * 32 * kVec) {
    unsigned mw[kVec];
    uint4 v[kVec], t[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int r = base + u * 128;
      mw[u] = r < q1 ? *reinterpret_cast<const unsigned*>(sm + (r - r0)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int r = base + u * 128;
      v[u] = make_uint4(0, 0, 0, 0);
      t[u] = make_uint4(0, 0, 0, 0);
      if constexpr (kVal) if (mw[u]) v[u] = load4(val, r, vvec);
      if constexpr (kTs) if (mw[u]) t[u] = load4(tsw, r, tvec);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if constexpr (OP == kCount) {
        st.u += __popc(mw[u]);
      } else {
        const int r = base + u * 128;
        const unsigned vv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const unsigned tt[4] = {t[u].x, t[u].y, t[u].z, t[u].w};
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((mw[u] >> (8 * b)) & 1u)
            add_word(st, OP, INT, vv[b], static_cast<int>(tt[b]), r + b);
      }
    }
  }
  warp_reduce(st, OP, INT);
  return st;
}

__global__ void __launch_bounds__(kThreads)
moments_pass1(const __grid_constant__ Params p) {
  extern __shared__ uint4 mask_words[];  // [1 + nslots][kTile] bytes
  unsigned char* masks = reinterpret_cast<unsigned char*>(mask_words);
  __shared__ int2 pieces[kChunk];  // (start, end | inside << 31)
  __shared__ int longs[kChunk];    // the pieces over kShort rows, in order
  __shared__ int span[2];
  __shared__ int nlong;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int r0 = tile * kTile;
  const int r1 = min(r0 + kTile, p.n);
  // runs ending in (r0, r1] (tile 0 also takes empty runs at row 0): [a, b)
  if (warp < 2) {
    const int x = warp == 1 ? r1 : (tile == 0 ? -1 : r0);
    const int i = warp_upper_bound(p.ends, p.nruns, x, lane);
    if (lane == 0) span[warp] = i;
  }
  const bool any = stage_mask(masks, p.rmask, p.rmask_vec != 0, r0, r1,
                              nullptr);
  const bool live = __syncthreads_or(any);
  if (live) {
    for (int s = 0; s < p.nslots; ++s)
      stage_mask(masks + (s + 1) * kTile, p.cmask[s],
                 (p.cmask_vec >> s) & 1u, r0, r1, masks);
    __syncthreads();
  }
  const int a = span[0];
  const int b = span[1];
  // and the run that holds row r1 - 1 and continues past r1
  const int items = b - a + (b < p.nruns && run_start(p.ends, b) < r1);
  const int nm = p.nmom + (p.counts != nullptr ? 1 : 0);
  // pass 2's work here: the run holding row r0, if it began in an
  // earlier tile and ends in this one
  if (threadIdx.x == 0)
    p.fold_run[tile] =
        tile > 0 && a < b && run_start(p.ends, a) < r0 ? a : -1;

  if (!live) {
    // no row of the tile counts: each piece gets its identity, and only
    // the first and last piece can cross the tile's edges, so no piece
    // bounds are read
    const bool head = tile > 0 && items > 0 && run_start(p.ends, a) < r0;
    const bool tail = items > b - a;
    const int tail_ps = tail ? max(run_start(p.ends, b), r0) : 0;
    for (int m = warp; m < nm; m += kWarps) {
      const State id = init_state(view(p, m).op);
      const unsigned word = out_word(p, m, id);
      unsigned* out = out_of(p, m);
      for (int k = lane; k < items; k += 32) {
        const bool first = k == 0 && head;
        if (first || (k == items - 1 && tail))
          *slot_ptr(p, tile, first || tail_ps == r0 ? 0 : 1, m) = id;
        else
          out[a + k] = word;
      }
    }
    return;
  }

  for (int c0 = 0; c0 < items; c0 += kChunk) {
    const int cnt = min(kChunk, items - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the last chunk
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const int g = a + c0 + k;
      const int s = run_start(p.ends, g);
      const int e = __ldg(p.ends + g);
      pieces[k] = make_int2(max(s, r0), min(e, r1) |
                                            (s >= r0 && e <= r1 ? INT_MIN : 0));
    }
    __syncthreads();

    // the pieces over kShort rows, listed by warp 0 in order
    if (warp == 0) {
      int count = 0;
      for (int kb = 0; kb < cnt; kb += 32) {
        const int k = kb + lane;
        const int2 pc = k < cnt ? pieces[k] : make_int2(0, 0);
        const bool lg = k < cnt && (pc.y & INT_MAX) - pc.x > kShort;
        const unsigned bal = __ballot_sync(kFull, lg);
        if (lg) longs[count + __popc(bal & ((1u << lane) - 1))] = k;
        count += __popc(bal);
      }
      if (lane == 0) nlong = count;
    }

    // pieces of at most kShort rows: one per lane, warp w taking the
    // moments m = w mod kWarps
    for (int m = warp; m < nm; m += kWarps) {
      const MomentView mv = view(p, m);
      const unsigned char* sm = masks + mv.slot * kTile;
      for (int k = lane; k < cnt; k += 32) {
        const int2 pc = pieces[k];
        const int ps = pc.x, pe = pc.y & INT_MAX;
        if (pe - ps > kShort) continue;
        State st = init_state(mv.op);
        with_op(mv.op, mv.is_int, [&](auto t) {
          using T = decltype(t);
          st = lane_piece<T::op, T::is_int>(sm, mv.val, p.ts, r0, ps, pe);
        });
        emit(p, tile, r0, a + c0 + k, ps, pc.y < 0, m, st);
      }
    }
    __syncthreads();  // the list of long pieces is complete

    // longer pieces: the whole warp, (piece, moment) pairs dealt
    // round-robin over the warps
    const int npairs = nlong * nm;
    for (int j = warp; j < npairs; j += kWarps) {
      const int k = longs[j / nm], m = j % nm;
      const int2 q = pieces[k];
      const int ps = q.x, pe = q.y & INT_MAX;
      const MomentView mv = view(p, m);
      State st = init_state(mv.op);
      with_op(mv.op, mv.is_int, [&](auto t) {
        using T = decltype(t);
        st = warp_piece<T::op, T::is_int>(
            masks + mv.slot * kTile, mv.val, mv.vec, p.ts, p.ts_vec != 0,
            r0, ps, pe, lane);
      });
      if (lane == 0) emit(p, tile, r0, a + c0 + k, ps, q.y < 0, m, st);
    }
  }
}

struct Fold {
  int g;           // the run, -1 for none
  int t0;          // the tile where it began
  int cnt;         // partials to fold: tiles t0 .. tile
  int first_slot;  // head (0) or tail (1) slot in tile t0
};

__device__ __forceinline__ Fold fold_of(const Params& p, int tile) {
  Fold f{-1, 0, 0, 0};
  if (tile >= p.ntiles) return f;
  f.g = p.fold_run[tile];
  if (f.g < 0) return f;
  const int s = run_start(p.ends, f.g);
  f.t0 = s / kTile;
  f.cnt = tile - f.t0 + 1;
  f.first_slot = s == f.t0 * kTile ? 0 : 1;
  return f;
}

// Moment m of run f.g by one warp: the partials in lane strides, kUnroll
// loads in flight, folded in a fixed order, then the butterfly.
__device__ __forceinline__ void fold_moment(const Params& p, const Fold& f,
                                            int m, int lane) {
  const MomentView mv = view(p, m);
  State acc = init_state(mv.op);
  for (int base = lane; base < f.cnt; base += 32 * kUnroll) {
    State part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * 32;
      part[u] = k < f.cnt
                    ? *slot_ptr(p, f.t0 + k, k == 0 ? f.first_slot : 0, m)
                    : init_state(mv.op);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) combine(acc, part[u], mv.op, mv.is_int);
  }
  warp_reduce(acc, mv.op, mv.is_int);
  if (lane == 0) write_out(p, m, f.g, acc);
}

__global__ void __launch_bounds__(kThreads)
moments_pass2(const __grid_constant__ Params p) {
  __shared__ int big[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nm = p.nmom + (p.counts != nullptr ? 1 : 0);
  const int tile = blockIdx.x * kWarps + warp;
  const Fold f = fold_of(p, tile);
  // a run over at most kWarpFold tiles: this warp folds every moment
  if (f.g >= 0 && f.cnt <= kWarpFold)
    for (int m = 0; m < nm; ++m) fold_moment(p, f, m, lane);
  // longer runs: the block, one warp per moment
  if (lane == 0) big[warp] = f.g >= 0 && f.cnt > kWarpFold ? tile : -1;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (big[w] < 0) continue;  // block-uniform
    const Fold fb = fold_of(p, big[w]);
    for (int m = warp; m < nm; m += kWarps) fold_moment(p, fb, m, lane);
  }
}

int num_tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

int segment_moments_max_moments() { return kMaxMoments; }

// Bytes of scratch a launch over n rows with nmom moments needs.
long long segment_moments_scratch_bytes(int n, int nmom) {
  return static_cast<long long>(num_tiles(n)) *
         (2 * (nmom + 1) * static_cast<long long>(sizeof(State)) +
          static_cast<long long>(sizeof(int)));
}

// Launches both passes on `stream` (a cudaStream_t passed as a pointer) of
// the calling thread's current device. Device pointers: ends int32
// [nruns], row_mask bool [n], ts int32 [n] (read by first/last only),
// counts int32 [nruns] or null, each vals[m] float32 or int32 [n] (is_int
// says which), each cmasks[m] bool [n] or null, each outs[m] [nruns] of
// the moment's output type, scratch of segment_moments_scratch_bytes.
// Any pointer may be 4-byte aligned only (1-byte for the masks). The
// pointer arrays and ops / is_int live on the host. Returns the CUDA
// error code (0 on success).
int segment_moments_launch(const int* ends, int nruns, int n,
                           const unsigned char* row_mask, const int* ts,
                           int* counts, int nmom, const void* const* vals,
                           const unsigned char* const* cmasks,
                           void* const* outs, const int* ops,
                           const int* is_int, void* scratch, void* stream) {
  if (nruns < 0 || n < 0 || n > INT_MAX - kTile || nmom < 0 ||
      nmom > kMaxMoments)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nruns == 0) return 0;
  Params p{};
  p.ends = ends;
  p.rmask = row_mask;
  p.ts = ts;
  p.counts = counts;
  p.scratch = static_cast<State*>(scratch);
  p.nruns = nruns;
  p.n = n;
  p.ntiles = num_tiles(n);
  p.nmom = nmom;
  p.fold_run = reinterpret_cast<int*>(p.scratch + static_cast<long long>(
      p.ntiles) * 2 * (nmom + 1));
  p.rmask_vec = aligned16(row_mask);
  p.ts_vec = aligned16(ts);
  for (int m = 0; m < nmom; ++m) {
    if (ops[m] < kCount || ops[m] > kLast)
      return static_cast<int>(cudaErrorInvalidValue);
    // one mask slot per distinct column mask; the row mask is slot 0
    int slot = 0;
    const unsigned char* c = cmasks[m];
    if (c != nullptr && c != row_mask) {
      while (slot < p.nslots && p.cmask[slot] != c) ++slot;
      if (slot == p.nslots) {
        p.cmask[slot] = c;
        p.cmask_vec |= static_cast<unsigned>(aligned16(c)) << slot;
        ++p.nslots;
      }
      ++slot;
    }
    p.mom[m] = Moment{vals[m], outs[m], ops[m], is_int[m], slot,
                      aligned16(vals[m])};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (1 + p.nslots) * kTile;
  // set on every launch: the 48 KB default covers the static shared
  // memory too (about 6 KB), and a launch must not depend on what an
  // earlier one set on this device
  cudaError_t err = cudaFuncSetAttribute(
      moments_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_pass1<<<p.ntiles, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.ntiles > 1) {
    moments_pass2<<<(p.ntiles + kWarps - 1) / kWarps, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* segment_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
