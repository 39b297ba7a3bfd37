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
// Bound: bytes. The function reads each input once (row mask, each value
// column and column mask, ts for first/last, the run ends) and writes each
// output once, with a handful of operations per row and moment, far below
// the card's double and integer rates. The issue is not bandwidth but run
// lengths, which range from one row to every row in one launch.
//
// Design: a row-tiled segmented reduction with a carry fold.
// - Pass 1: one warp per tile of kTile rows. The warp finds the runs that
//   end in its tile, plus the run that continues past it, by binary search
//   in ends. Runs of at most kShort rows in the tile are reduced one per
//   lane, serially; longer ones by the whole warp, lanes striding the rows
//   (coalesced) with kUnroll rows per lane in flight (their masks, then
//   the values of the rows that count: two dependent loads per kUnroll
//   rows, not three per row), then a shuffle butterfly. A run inside the tile
//   is written to the output. A run that crosses the tile's edge leaves a
//   partial state in scratch: the "head" slot for the run holding the
//   tile's first row, the "tail" slot for a run that starts inside the
//   tile and continues past it. Every run is reduced with all the card's
//   warps at work, whether there are 3 M runs of 6 rows or one of 17 M.
// - Pass 2: one warp per tile folds the partials of the crossing run
//   that ends in that tile (pass 1 names it), from the tile where it
//   started, in a fixed order (lane strides, then a butterfly); a run
//   over more than kWarpFold tiles is folded by the whole block (thread
//   strides, a butterfly per warp, then the warps in order).
// No atomics anywhere: the same inputs give the same bits on every run.
//
// What the card showed (PERF.md): a first design with 1024-row tiles
// and a block per tile in pass 2 (barriers per moment) reached 8-12 % of
// the bound; pass 2's barriers and the number of run pieces (each costs a
// butterfly per moment), not load latency, set its time. Hence a warp per
// tile in pass 2, 4096-row tiles, butterflies that shuffle only the fields
// an op uses, and the wrapper merging identical moments (every count over
// one column mask is one count).
//
// Not done yet (later work): TMA loads, wider vector loads, loads in
// flight on the one-run-per-lane path, and reading the row mask once for
// all moments rather than once per moment.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMoments = 32;
constexpr int kTile = 4096;   // rows per warp in pass 1
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kShort = 32;    // runs up to this long go one per lane
constexpr int kUnroll = 8;    // rows per lane in flight in a warp's run
constexpr int kWarpFold = 64; // pass 2: a warp folds runs over <= this many tiles
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
  const unsigned char* cmask;  // nullptr: the row mask alone
  void* out;
  int op;
  int is_int;
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
  Moment mom[kMaxMoments];
};

__device__ __forceinline__ int upper_bound(const int* a, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int run_start(const int* ends, int g) {
  return g ? __ldg(ends + g - 1) : 0;
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

__device__ __forceinline__ bool reads_val(int op) {
  return op == kSum || op == kSumSq || op == kMin || op == kMax;
}
__device__ __forceinline__ bool reads_ts(int op) {
  return op == kFirst || op == kLast;
}

__device__ __forceinline__ double word_val(unsigned w, int is_int) {
  return is_int ? static_cast<double>(static_cast<int>(w))
                : static_cast<double>(__uint_as_float(w));
}

// Row i (which counts for the moment) into s, given its value as a raw
// 32-bit word w (float32 or int32) and its ts k; rows come in increasing
// order within one state.
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
      if (k != INT_MAX && (s.pos < 0 || k < s.key)) { s.key = k; s.pos = i; }
      break;
    case kLast:
      if (k != INT_MIN && (s.pos < 0 || k >= s.key)) { s.key = k; s.pos = i; }
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
  const void* val;
  const unsigned char* cmask;
  int op;
  int is_int;
};

__device__ __forceinline__ MomentView view(const Params& p, int m) {
  if (m == p.nmom) return MomentView{nullptr, nullptr, kRows, 0};
  const Moment& mo = p.mom[m];
  return MomentView{mo.val, mo.cmask, mo.op, mo.is_int};
}

__device__ __forceinline__ bool counts_row(const Params& p,
                                           const unsigned char* cmask, int i) {
  return __ldg(p.rmask + i) && (cmask == nullptr || __ldg(cmask + i));
}

__device__ void write_out(const Params& p, int m, int g, const State& s) {
  if (m == p.nmom) {
    p.counts[g] = static_cast<int>(s.u);
    return;
  }
  const Moment& mo = p.mom[m];
  int* oi = static_cast<int*>(mo.out);
  float* of = static_cast<float*>(mo.out);
  switch (mo.op) {
    case kCount:
      oi[g] = static_cast<int>(s.u);
      break;
    case kSum:
      if (mo.is_int)
        oi[g] = static_cast<int>(static_cast<unsigned>(s.u));
      else
        of[g] = static_cast<float>(s.f);
      break;
    case kSumSq:
      of[g] = static_cast<float>(s.f);
      break;
    case kMin:
    case kMax:
      if (mo.is_int)
        oi[g] = s.f == INFINITY ? INT_MAX
                                : (s.f == -INFINITY ? INT_MIN
                                                    : static_cast<int>(s.f));
      else
        of[g] = static_cast<float>(s.f);
      break;
    case kFirst:
    case kLast:
      if (mo.is_int)
        oi[g] = s.pos < 0 ? 0 : __ldg(static_cast<const int*>(mo.val) + s.pos);
      else
        of[g] = s.pos < 0 ? NAN
                          : __ldg(static_cast<const float*>(mo.val) + s.pos);
      break;
    default:
      break;
  }
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

__global__ void __launch_bounds__(kThreads)
moments_pass1(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= p.ntiles) return;  // whole warps leave together
  const int r0 = tile * kTile;
  const int r1 = min(r0 + kTile, p.n);
  // runs ending in (r0, r1] (tile 0 also takes empty runs at row 0), and
  // the run that holds row r1 - 1 and continues past r1
  const int a = upper_bound(p.ends, p.nruns, tile == 0 ? -1 : r0);
  const int b = upper_bound(p.ends, p.nruns, r1);
  const int extra = (b < p.nruns && run_start(p.ends, b) < r1) ? 1 : 0;
  const int items = b - a + extra;
  const int nm = p.nmom + (p.counts != nullptr ? 1 : 0);
  // pass 2's work here: the run holding row r0, if it began in an
  // earlier tile and ends in this one
  if (lane == 0)
    p.fold_run[tile] =
        tile > 0 && a < b && run_start(p.ends, a) < r0 ? a : -1;

  for (int base = 0; base < items; base += 32) {
    const int k = base + lane;
    const bool active = k < items;
    int g = a + k, ps = 0, pe = 0;
    bool inside = false;
    if (active) {
      const int s = run_start(p.ends, g);
      const int e = __ldg(p.ends + g);
      ps = max(s, r0);
      pe = min(e, r1);
      inside = s >= r0 && e <= r1;
    }
    const bool is_short = active && pe - ps <= kShort;
    unsigned longs = __ballot_sync(kFull, active && !is_short);
    if (is_short) {
      for (int m = 0; m < nm; ++m) {
        const MomentView mv = view(p, m);
        State st = init_state(mv.op);
        const unsigned* word = static_cast<const unsigned*>(mv.val);
        for (int i = ps; i < pe; ++i)
          if (counts_row(p, mv.cmask, i))
            add_word(st, mv.op, mv.is_int,
                     reads_val(mv.op) ? __ldg(word + i) : 0u,
                     reads_ts(mv.op) ? __ldg(p.ts + i) : 0, i);
        emit(p, tile, r0, g, ps, inside, m, st);
      }
    }
    while (longs) {
      const int l = __ffs(longs) - 1;
      longs &= longs - 1;
      const int gl = __shfl_sync(kFull, g, l);
      const int psl = __shfl_sync(kFull, ps, l);
      const int pel = __shfl_sync(kFull, pe, l);
      const bool inl = __shfl_sync(kFull, static_cast<int>(inside), l) != 0;
      for (int m = 0; m < nm; ++m) {
        const MomentView mv = view(p, m);
        const unsigned* word = static_cast<const unsigned*>(mv.val);
        const bool rv = reads_val(mv.op), rt = reads_ts(mv.op);
        State st = init_state(mv.op);
        for (int base = psl + lane; base < pel; base += 32 * kUnroll) {
          // kUnroll rows per lane in flight: their masks, then the
          // values of the rows that count, then the fold in row order
          bool on[kUnroll];
          unsigned w[kUnroll];
          int k[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = base + u * 32;
            const bool in = i < pel;
            const bool r = in && __ldg(p.rmask + i);
            const bool c = !in || mv.cmask == nullptr || __ldg(mv.cmask + i);
            on[u] = r && c;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = base + u * 32;
            w[u] = on[u] && rv ? __ldg(word + i) : 0u;
            k[u] = on[u] && rt ? __ldg(p.ts + i) : 0;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (on[u]) add_word(st, mv.op, mv.is_int, w[u], k[u], base + u * 32);
        }
        warp_reduce(st, mv.op, mv.is_int);
        if (lane == 0) emit(p, tile, r0, gl, psl, inl, m, st);
      }
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

// acc (+)= partials k = k0, k0 + stride, ... < f.cnt of moment m, kUnroll
// loads in flight, folded in a fixed order.
__device__ __forceinline__ void fold_partials(const Params& p, const Fold& f,
                                              int m, const MomentView& mv,
                                              int k0, int stride, State& acc) {
  for (int base = k0; base < f.cnt; base += stride * kUnroll) {
    State part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * stride;
      part[u] = k < f.cnt
                    ? *slot_ptr(p, f.t0 + k, k == 0 ? f.first_slot : 0, m)
                    : init_state(mv.op);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) combine(acc, part[u], mv.op, mv.is_int);
  }
}

__global__ void __launch_bounds__(kThreads)
moments_pass2(const __grid_constant__ Params p) {
  __shared__ int big[kWarps];
  __shared__ State warp_acc[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nm = p.nmom + (p.counts != nullptr ? 1 : 0);
  const int tile = blockIdx.x * kWarps + warp;
  const Fold f = fold_of(p, tile);
  // a run over at most kWarpFold tiles: this warp folds it
  if (f.g >= 0 && f.cnt <= kWarpFold) {
    for (int m = 0; m < nm; ++m) {
      const MomentView mv = view(p, m);
      State acc = init_state(mv.op);
      fold_partials(p, f, m, mv, lane, 32, acc);
      warp_reduce(acc, mv.op, mv.is_int);
      if (lane == 0) write_out(p, m, f.g, acc);
    }
  }
  // longer runs: the whole block, one at a time, in warp order
  if (lane == 0) big[warp] = f.g >= 0 && f.cnt > kWarpFold ? tile : -1;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (big[w] < 0) continue;  // block-uniform
    const Fold fb = fold_of(p, big[w]);
    for (int m = 0; m < nm; ++m) {
      const MomentView mv = view(p, m);
      State acc = init_state(mv.op);
      fold_partials(p, fb, m, mv, threadIdx.x, kThreads, acc);
      warp_reduce(acc, mv.op, mv.is_int);
      if (lane == 0) warp_acc[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        State r = warp_acc[0];
        for (int v = 1; v < kWarps; ++v)
          combine(r, warp_acc[v], mv.op, mv.is_int);
        write_out(p, m, fb.g, r);
      }
      __syncthreads();
    }
  }
}

int num_tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

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
// The pointer arrays and ops / is_int live on the host. Returns the CUDA
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
  for (int m = 0; m < nmom; ++m) {
    if (ops[m] < kCount || ops[m] > kLast)
      return static_cast<int>(cudaErrorInvalidValue);
    p.mom[m] = Moment{vals[m], cmasks[m], outs[m], ops[m], is_int[m]};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks1 = (p.ntiles + kWarps - 1) / kWarps;
  moments_pass1<<<blocks1, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.ntiles > 1) {
    moments_pass2<<<blocks1, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* segment_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
