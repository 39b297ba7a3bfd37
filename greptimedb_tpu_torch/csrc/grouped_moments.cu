// Grouped moments on Hopper (sm_90a): every moment of a group-by over
// UNSORTED group ids.
//
// Replaces XLA code, not a Pallas kernel: the scatter group-by of
// greptimedb_tpu/ops/kernels.py, grouped_aggregate (:77) ->
// _grouped_aggregate (:90): jax.ops.segment_sum / segment_min /
// segment_max over gids, with a scratch group for masked rows, and the
// per-shard fold of greptimedb_tpu/parallel/aggregate.py:34
// _partial_aggregate, whose collectives run outside the kernel here
// (torch.distributed in parallel/aggregate.py).
//
// Input: per row a group id (int32; a row whose id is outside [0, G)
// counts nowhere, as the reference's scatter drops it), a row mask, ts
// (int32, read by first/last only), and per moment a value column
// (float32 or int32) and a column mask (or none). A row counts for a
// moment when the row mask and the column mask are both set. Output per
// group, in device memory the caller allocated:
//
//   count      int32   rows that count
//   sum        float32 (double accumulation, rounded once) or int32
//                      (wraps mod 2^32, as the reference's int32 sums do)
//   sum_sq     float32 sum of x*x, squares and sums in double
//   min/max    column type; NaN propagates; empty: +-inf or INT32_MAX/MIN
//   first      value at the smallest (ts, row); empty: NaN (float) or 0
//   last       value at the largest ts, then the smallest row; same empty
//   first_key  int64 (ts << 32) + row of that winner (LLONG_MAX: none)
//   last_key   int64 (~ts << 32) + row of that winner (LLONG_MAX: none)
//
// Rows are numbered row_base + i, so a shard of a larger table keys its
// winners by the global row index: the smallest key over all shards is
// the reference's winner (parallel/aggregate.py all-reduces the keys
// with MIN and takes the owner's value).
//
// Bound: bytes at the widths the port runs. The function must read the
// row mask, the group ids and each value column, column mask and (for
// first/last) ts once, and write each output once; a handful of
// operations per row and moment is far below the card's rates. Nothing
// says where a group's rows lie, so every counted row updates its
// group's state in memory that other rows share. Kept in global memory
// (the state of TSBS's 48 000 host x hour groups is megabytes), each row
// and moment is one L2 atomic, and the L2's atomic units, not the bytes,
// set the pace: about 280 M atomics at 17.28 M rows (3.67 ms against the
// 0.25 ms byte bound on an H100 in this kernel's earlier design).
//
// Design: the state lives in shared memory, always.
// - A group's state is one slot per moment and a row count: 8 bytes for
//   a double sum or a packed first/last key, 4 for a count, an int32 sum
//   (mod 2^32) and a min / max, which take the order key of the value
//   (int32 itself; float32 as b >= 0 ? b : b ^ 0x7fffffff, NaN as
//   INT_MIN for min and INT_MAX for max, which no value's key reaches,
//   so NaN wins as jnp's NaN-propagating min / max lets it). A state
//   holds a multiple of 32 groups, and a group's index in it is
//   swizzled (`swizzle`) so that lanes a small stride apart in group id
//   fall in different banks.
// - Small G (G groups' state within kSmallBudget): every block keeps
//   all groups in shared memory, strides the rows with shared-memory
//   atomics, and adds each group it touched into global memory; an init
//   and a finalize kernel bracket it.
// - Above it, rows are partitioned by group range: Gp groups to a
//   partition, Gp the most whose state fits kPartBudget (one 1024-thread
//   block to an SM), P = ceil(G / Gp).
//   Pass 1: each warp counts its segment's live rows per partition in
//   warp-private shared counters (warp-aggregated increments), writes
//   them to [P][segments], and counts how many partitions its steps of
//   32 rows meet. A scan kernel per partition and one planning kernel
//   turn the counts into each (partition, segment) offset, each
//   partition's rows and work items: runs of about live / kTargetItems
//   rows (at least kMinChunk, whole block tiles), so a skewed partition
//   splits over many blocks.
//   Pass 2, rows that lie together (a step meets at most kCopyAbove
//   partitions on average, as in TSBS's time-major order, where a
//   partition's Gp / 12 hosts are a run of rows at every tick): each
//   warp reads its segment again and writes each live row's index into
//   its partition's slice, in row order (a lane's rank among the lanes
//   of its partition, a warp-private cursor). No global atomic.
//   Pass 2, rows in scattered order (above kCopyAbove, at most
//   kCopyParts partitions): pass 3's gathers would fetch a 32-byte
//   sector for about every value, so each block instead places a chunk
//   of rows in partition order in shared memory and writes, column by
//   column, the row index, the group within the partition and every
//   input column into partition order: coalesced reads, and one
//   contiguous write per partition and chunk.
//   The copies take the rows in chunks whose row list, groups and copied
//   columns fit kChunkBytes (512 MiB; 9.6 M rows at 19a's 17 moments),
//   each chunk with a plan of its own from pass 1's counts and pass 3
//   run over it; every partition then merges into the global state. So
//   beyond the groups' state and the counts, a launch's scratch is 4
//   bytes a row (the row list) or one chunk's copies, the larger.
//   Pass 3: persistent blocks take work items from a shared queue (a
//   block that finishes early takes more). A block sets its
//   partition's Gp groups to the identities in shared memory and walks
//   the item in tiles (each lane kUnroll rows): the rows' indices,
//   groups and, moment by moment, the inputs (gathered at the rows, or
//   read from the copies; the next moment's loads in flight while this
//   one updates), then shared-memory atomics. A partition owned by one
//   item writes its outputs from shared memory; a partition of several
//   items merges each touched group with one global atomic per slot,
//   and a finalize kernel writes those groups.
// - A tile whose rows share one group (rows sorted by group, or a hot
//   group) folds each lane's rows in registers and reduces across the
//   warp: one atomic per moment per tile; a step whose rows share one
//   reduces across the warp: one atomic per moment instead of 32 on one
//   address.
// What remains, in TSBS's time-major order at 17.28 M rows and 48 000
// groups (an H100, 1.06 ms in all): pass 3 about 0.86 ms, about half of
// it the moments' loads and a third the shared-memory atomics (a double
// add is a compare-and-swap loop there; bank conflicts of 2-3 ways
// remain), passes 1-2 about 0.15 ms. In random order (two chunks of
// copies) the copies take about 1.7 ms of 3.1, pass 3 1.2.
// Float sums depend on the order the atomics land in: the same inputs
// may differ in the last bits between runs (the reference's scatter sum
// is order-dependent too). Counts, min, max, first and last are exact.
//
// No launch keeps state between calls or in static device memory: all
// scratch is the caller's (concurrent callers on one device are safe).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMoments = 32;
constexpr int kMaxCols = 2 * kMaxMoments;  // copied input columns
// the partitions a warp step's rows fall in, on average, above which
// pass 3's gathers would fetch a sector for about every value (a
// sector holds 8 rows): the inputs are then copied in partition order
constexpr int kCopyAbove = 4;
constexpr int kCopyParts = 512;          // the most partitions copied
constexpr int kStage = 2048;             // rows scatter_copies places at once
constexpr int kThreads = 256;            // init, finalize, the small path
constexpr int kSmallBudget = 96 * 1024;  // small path: all G groups
constexpr int kPartBudget = 224 * 1024;  // partition path: Gp groups
constexpr int kAggThreads = 1024;        // pass 3: a block an SM
constexpr int kAggBlocksPerSm = 1;
constexpr int kSegWarps = 8;             // passes 1-2: a segment a warp
constexpr int kWindow = 2048;            // partitions a warp counts at once
constexpr int kScanThreads = 1024;
constexpr int kTargetItems = 768;        // pass 3's work items, about
constexpr int kMinChunk = 4096;          // rows of a work item, at least
// rows of a segment: about a chunk's rows over kSegments, within
// [kSegRowsMin, kSegRowsMax] (enough warps for passes 1-2 at any chunk)
constexpr int kSegRowsMin = 512;
constexpr int kSegRowsMax = 2048;
constexpr int kSegments = 8192;
constexpr long long kMaxCounts = 1 << 22;  // [partition][segment] counts
// where passes 2-3 copy, they take the rows in chunks whose row list,
// groups and copies fit kChunkBytes (at least kMinChunkRows rows)
constexpr long long kChunkBytes = 512ll << 20;
constexpr long long kMinChunkRows = 1 << 20;
constexpr int kUnroll = 4;               // pass 3: rows a lane holds at once
constexpr int kSegUnroll = 4;            // passes 1-2: rows a lane loads at once
constexpr long long kAlign = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Op : int {
  kCount = 0, kSum = 1, kSumSq = 2, kMin = 3, kMax = 4, kFirst = 5,
  kLast = 6, kFirstKey = 7, kLastKey = 8
};

struct Moment {
  const void* val;
  const unsigned char* cmask;  // nullptr: the row mask alone
  void* out;
  int op;
  int is_int;
  int wide;  // an 8-byte slot
  int slot;  // its index among the slots of its width
  int vcol;  // the copied column of its value (ts for first/last), or -1
  int mcol;  // the copied column of its column mask, or -1
};

// An input column that pass 2 copies into partition order when the rows'
// order scatters them (see Part::meta).
struct Column {
  const void* src;
  void* dst;   // [live rows], partition by partition, as the row list
  int bytes;   // 4 (a value column or ts) or 1 (a column mask)
};

struct Params {
  const int* gids;
  const unsigned char* rmask;
  const int* ts;
  int* counts;               // nullptr: no row counts in this launch
  long long row_base;
  int n;
  int G;
  int nmom;
  int need_ts;
  int n8;                    // 8-byte slots per group
  int n4;                    // 4-byte slots per group (then the rows)
  int ncol;                  // copied columns
  unsigned long long ident8[kMaxMoments];
  unsigned ident4[kMaxMoments + 1];
  Moment mom[kMaxMoments];
  Column col[kMaxCols];
};

// A plan of the partition path and its scratch (item_start == nullptr:
// the small path, every group's state in global memory). The launch's
// plan covers all rows; where the copies are taken in chunks, each
// chunk has a plan of its own over its segments.
struct Part {
  int Gp;
  int P;
  int S;            // rows of a segment
  int NSall;        // the launch's segments (rel's row stride)
  int seg0;         // this plan's first segment
  int NS;           // and its segments
  int target;       // its work items, about
  int mode;         // pass 3 runs this plan: 0 when the launch gathers,
                    // 1 when it copies, 2 either way
  int merge_copies; // 1: the copies come in several chunks, and when
                    // the launch copies, every partition merges into
                    // the global state
  int* rel;         // [P][NSall] counts, then offsets within the partition
  int* glen;        // [P] each partition's live rows (the launch's)
  int* part_len;    // [P] this plan's rows of each partition
  int* part_start;  // [P] where they start in the list
  int* origin;      // [P] part_start minus rel at seg0
  int* item_start;  // [P + 1]
  int* meta;        // [0]: rows of a work item; [1], [2] (the launch's
                    // plan): the partitions a warp step's live rows fall
                    // in, summed, and the steps; [3] (the launch's plan):
                    // 1 when that average passes kCopyAbove (passes 2-3
                    // then copy and read the inputs in partition order),
                    // else 0 (pass 3 gathers them); [4]: pass 3's next
                    // work item
  int* gmeta;       // the launch's plan's meta
  int* list;        // [live rows] row indices, partition by partition
  int* grp;         // [live rows] their groups within the partition (a
                    // copied column)
};

// A state of `stride` groups: [n8][stride] 8-byte slots, then
// [n4 + 1][stride] 4-byte slots (the last row: the row counts).
struct State {
  unsigned long long* w8;
  unsigned* w4;
  int stride;
};

__host__ __device__ inline bool is_wide(int op, int is_int) {
  return op == kSumSq || (op == kSum && !is_int) || op >= kFirst;
}

__device__ __forceinline__ unsigned long long* at8(const State& s,
                                                   const Moment& mo, int g) {
  return s.w8 + static_cast<long long>(mo.slot) * s.stride + g;
}

__device__ __forceinline__ unsigned* at4(const State& s, const Moment& mo,
                                         int g) {
  return s.w4 + static_cast<long long>(mo.slot) * s.stride + g;
}

__device__ __forceinline__ unsigned* rows_at(const Params& p,
                                             const State& s, int g) {
  return s.w4 + static_cast<long long>(p.n4) * s.stride + g;
}

__device__ __forceinline__ int order_key(unsigned raw) {
  const int b = static_cast<int>(raw);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

__device__ __forceinline__ int min_key(const Moment& mo, unsigned raw) {
  if (mo.is_int) return static_cast<int>(raw);
  const float x = __uint_as_float(raw);
  return x != x ? INT_MIN : order_key(raw);
}

__device__ __forceinline__ int max_key(const Moment& mo, unsigned raw) {
  if (mo.is_int) return static_cast<int>(raw);
  const float x = __uint_as_float(raw);
  return x != x ? INT_MAX : order_key(raw);
}

__device__ __forceinline__ double as_double(const Moment& mo,
                                            unsigned raw) {
  return mo.is_int ? static_cast<double>(static_cast<int>(raw))
                   : static_cast<double>(__uint_as_float(raw));
}

__device__ __forceinline__ long long pack_key(int op, int t,
                                              unsigned long long row) {
  const long long hi = (op == kFirst || op == kFirstKey) ? t : ~t;
  return static_cast<long long>(
      (static_cast<unsigned long long>(hi) << 32) | row);
}

// A group's index in a shared-memory state: within each aligned block of
// 32 groups the low five bits are XORed with a multiple of the block's
// number, so that lanes whose groups lie a small stride apart (TSBS's
// host x 12 + hour ids give 12) spread over the banks. A bijection on
// any state of a multiple of 32 groups.
__device__ __forceinline__ int swizzle(int g) {
  return (g & ~31) | ((g ^ ((g >> 5) * 7)) & 31);
}

// A warp's tile of rows: lane L holds the rows u * 32 + L of steps
// u < kUnroll, so each lane keeps kUnroll loads in flight.
struct Tile {
  int i[kUnroll];   // row
  int at[kUnroll];  // where its inputs are: i, or its place in the copies
  int g[kUnroll];   // the group's (swizzled) index in the state
  unsigned valid;   // bit u: this lane's row of step u counts
  unsigned any;     // bit u: some lane's row of step u counts
  unsigned uni;     // bit u: step u's counted rows share one group
  unsigned lead;    // bit u: this lane lands step u's reduced updates
  int one;          // the group of every row, when the tile's rows share one
};

// How a tile's steps update the state: each lane on its own (no step's
// rows share a group, the usual case), the whole tile reduced across
// the warp (all its rows in one group, as in rows sorted by group), or
// step by step (a step whose rows share a group reduced across the
// warp, the others lane by lane).
enum Mode : int { kLanes = 0, kGroup = 1, kMixed = 2 };

// Step u's votes and row counts, once the tile's rows and groups are in.
__device__ __forceinline__ int vote(const Params& p, const State& s,
                                    Tile& tl) {
  tl.any = tl.uni = tl.lead = 0u;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool v = (tl.valid >> u) & 1u;
    const unsigned vb = __ballot_sync(kFull, v);
    if (vb == 0u) continue;
    tl.any |= 1u << u;
    const int leader = __ffs(vb) - 1;
    const int g0 = __shfl_sync(kFull, tl.g[u], leader);
    if (__all_sync(kFull, !v || tl.g[u] == g0)) {
      tl.uni |= 1u << u;
      tl.g[u] = g0;
      if (lane == leader) {
        tl.lead |= 1u << u;
        atomicAdd(rows_at(p, s, g0), static_cast<unsigned>(__popc(vb)));
      }
    } else if (v) {
      atomicAdd(rows_at(p, s, tl.g[u]), 1u);
    }
  }
  if (tl.uni == 0u) return kLanes;
  if (tl.uni != tl.any) return kMixed;
  tl.one = -1;
  bool one = true;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (!((tl.any >> u) & 1u)) continue;
    if (tl.one < 0) tl.one = tl.g[u];
    one = one && tl.g[u] == tl.one;
  }
  return one ? kGroup : kMixed;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ long long warp_min(long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// A moment's inputs over the tile (from the columns, or from their
// copies in partition order): bit u of `has` when this lane's row of
// step u counts for it, raw[u] its value's bits (ts for first/last).
__device__ __forceinline__ void load_moment(const Params& p,
                                            const Moment& mo,
                                            const Tile& tl, bool copied,
                                            unsigned (&raw)[kUnroll],
                                            unsigned& has) {
  const unsigned* src;
  const unsigned char* cmask;
  if (copied) {
    src = mo.vcol < 0 ? nullptr
                      : static_cast<const unsigned*>(p.col[mo.vcol].dst);
    cmask = mo.mcol < 0
                ? nullptr
                : static_cast<const unsigned char*>(p.col[mo.mcol].dst);
  } else {
    src = mo.op >= kFirst ? reinterpret_cast<const unsigned*>(p.ts)
          : mo.op == kCount ? nullptr
                            : static_cast<const unsigned*>(mo.val);
    cmask = mo.cmask;
  }
  has = 0u;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    raw[u] = 0u;
    if ((tl.valid >> u) & 1u) {
      if (cmask == nullptr || __ldg(cmask + tl.at[u]) != 0)
        has |= 1u << u;
      if (src != nullptr) raw[u] = __ldg(src + tl.at[u]);
    }
  }
}

// One moment's updates over the tile, a lane's own atomic where a
// step's groups differ, a reduction across the lanes and one atomic
// where they share one. kKind is the op (kFirst stands for first, last
// and both keys).
template <int kKind, int kMode>
__device__ __forceinline__ void update(const Params& p, const Moment& mo,
                                       const State& s, const Tile& tl,
                                       const unsigned (&raw)[kUnroll],
                                       unsigned has) {
  if (kMode == kGroup) {
    // each lane folds its rows of the tile, then one reduction across
    // the warp and one atomic, landed by lane 0
    const int g = tl.one;
    const bool lead = (threadIdx.x & 31) == 0;
    if (kKind == kCount || (kKind == kSum && mo.is_int)) {
      unsigned v = 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if ((has >> u) & 1u) v += kKind == kCount ? 1u : raw[u];
      v = __reduce_add_sync(kFull, v);
      if (lead && v) atomicAdd(at4(s, mo, g), v);
    } else if (kKind == kSum || kKind == kSumSq) {
      double x = 0.0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const double y = ((has >> u) & 1u) ? as_double(mo, raw[u]) : 0.0;
        x += kKind == kSumSq ? y * y : y;
      }
      x = warp_sum(x);
      if (lead) atomicAdd(reinterpret_cast<double*>(at8(s, mo, g)), x);
    } else if (kKind == kMin || kKind == kMax) {
      int k = kKind == kMin ? INT_MAX : INT_MIN;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!((has >> u) & 1u)) continue;
        const int v = kKind == kMin ? min_key(mo, raw[u]) : max_key(mo, raw[u]);
        k = kKind == kMin ? (v < k ? v : k) : (v > k ? v : k);
      }
      k = kKind == kMin ? __reduce_min_sync(kFull, k)
                        : __reduce_max_sync(kFull, k);
      if (lead) {
        if (kKind == kMin)
          atomicMin(reinterpret_cast<int*>(at4(s, mo, g)), k);
        else
          atomicMax(reinterpret_cast<int*>(at4(s, mo, g)), k);
      }
    } else {  // first / last and their keys
      long long k = LLONG_MAX;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!((has >> u) & 1u)) continue;
        const unsigned long long row =
            (static_cast<unsigned long long>(p.row_base) + tl.i[u]) &
            0xffffffffull;
        const long long v = pack_key(mo.op, static_cast<int>(raw[u]), row);
        k = v < k ? v : k;
      }
      k = warp_min(k);
      if (lead) atomicMin(reinterpret_cast<long long*>(at8(s, mo, g)), k);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool h = (has >> u) & 1u;
    const bool uni = kMode == kMixed && ((tl.uni >> u) & 1u);
    if (!uni && !h) continue;
    const int g = tl.g[u];
    const bool lead = (tl.lead >> u) & 1u;
    if (kKind == kCount) {
      if (uni) {
        const unsigned c = __popc(__ballot_sync(kFull, h));
        if (lead && c) atomicAdd(at4(s, mo, g), c);
      } else {
        atomicAdd(at4(s, mo, g), 1u);
      }
    } else if (kKind == kSum && mo.is_int) {
      if (uni) {
        const unsigned v = __reduce_add_sync(kFull, h ? raw[u] : 0u);
        if (lead) atomicAdd(at4(s, mo, g), v);
      } else {
        atomicAdd(at4(s, mo, g), raw[u]);
      }
    } else if (kKind == kSum || kKind == kSumSq) {
      double x = h ? as_double(mo, raw[u]) : 0.0;
      if (kKind == kSumSq) x *= x;
      if (uni) x = warp_sum(x);
      if (!uni || lead)
        atomicAdd(reinterpret_cast<double*>(at8(s, mo, g)), x);
    } else if (kKind == kMin) {
      int k = h ? min_key(mo, raw[u]) : INT_MAX;
      if (uni) k = __reduce_min_sync(kFull, k);
      if (!uni || lead) atomicMin(reinterpret_cast<int*>(at4(s, mo, g)), k);
    } else if (kKind == kMax) {
      int k = h ? max_key(mo, raw[u]) : INT_MIN;
      if (uni) k = __reduce_max_sync(kFull, k);
      if (!uni || lead) atomicMax(reinterpret_cast<int*>(at4(s, mo, g)), k);
    } else {  // first / last and their keys
      const unsigned long long row =
          (static_cast<unsigned long long>(p.row_base) + tl.i[u]) &
          0xffffffffull;
      long long k = h ? pack_key(mo.op, static_cast<int>(raw[u]), row)
                      : LLONG_MAX;
      if (uni) k = warp_min(k);
      if (!uni || lead)
        atomicMin(reinterpret_cast<long long*>(at8(s, mo, g)), k);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void update_moment(const Params& p,
                                              const Moment& mo,
                                              const State& s, const Tile& tl,
                                              const unsigned (&raw)[kUnroll],
                                              unsigned has) {
  switch (mo.op) {
    case kCount: update<kCount, kMode>(p, mo, s, tl, raw, has); break;
    case kSum: update<kSum, kMode>(p, mo, s, tl, raw, has); break;
    case kSumSq: update<kSumSq, kMode>(p, mo, s, tl, raw, has); break;
    case kMin: update<kMin, kMode>(p, mo, s, tl, raw, has); break;
    case kMax: update<kMax, kMode>(p, mo, s, tl, raw, has); break;
    default: update<kFirst, kMode>(p, mo, s, tl, raw, has);
  }
}

// The tile's rows into the state: row counts, then moment by moment,
// each moment's loads issued before the previous moment's updates.
template <int kMode>
__device__ __forceinline__ void add_moments(const Params& p,
                                            const State& s, const Tile& tl,
                                            bool copied) {
  unsigned raw[kUnroll], has;
  load_moment(p, p.mom[0], tl, copied, raw, has);
  for (int m = 0; m < p.nmom; ++m) {
    unsigned next[kUnroll] = {}, next_has = 0u;
    if (m + 1 < p.nmom)
      load_moment(p, p.mom[m + 1], tl, copied, next, next_has);
    update_moment<kMode>(p, p.mom[m], s, tl, raw, has);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
    has = next_has;
  }
}

__device__ __forceinline__ void add_tile(const Params& p, const State& s,
                                         Tile& tl, bool copied) {
  const int mode = vote(p, s, tl);
  if (p.nmom == 0) return;
  if (mode == kLanes)
    add_moments<kLanes>(p, s, tl, copied);
  else if (mode == kGroup)
    add_moments<kGroup>(p, s, tl, copied);
  else
    add_moments<kMixed>(p, s, tl, copied);
}

// Every slot of a shared-memory state of s.stride groups to its identity.
__device__ __forceinline__ void init_shared(const Params& p,
                                            const State& s) {
  for (int k = 0; k < p.n8; ++k)
    for (int g = threadIdx.x; g < s.stride; g += blockDim.x)
      s.w8[k * s.stride + g] = p.ident8[k];
  for (int k = 0; k <= p.n4; ++k)
    for (int g = threadIdx.x; g < s.stride; g += blockDim.x)
      s.w4[k * s.stride + g] = p.ident4[k];
}

__device__ __forceinline__ float key_to_float(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7fffffff));
}

// Group lg of state s (its index there) as the outputs of group g.
__device__ void finish_group(const Params& p, const State& s, int lg,
                             int g) {
  if (p.counts != nullptr)
    p.counts[g] = static_cast<int>(*rows_at(p, s, lg));
  for (int m = 0; m < p.nmom; ++m) {
    const Moment& mo = p.mom[m];
    if (mo.wide) {
      const long long k = static_cast<long long>(*at8(s, mo, lg));
      if (mo.op == kSum || mo.op == kSumSq) {
        static_cast<float*>(mo.out)[g] =
            static_cast<float>(__longlong_as_double(k));
      } else if (mo.op == kFirstKey || mo.op == kLastKey) {
        static_cast<long long*>(mo.out)[g] = k;
      } else {  // first / last: the value at the winning row
        int bits = mo.is_int ? 0 : 0x7fc00000;
        if (k != LLONG_MAX)
          bits = __ldg(static_cast<const int*>(mo.val) +
                       ((k & 0xffffffffll) - p.row_base));
        static_cast<int*>(mo.out)[g] = bits;
      }
    } else {
      const int k = static_cast<int>(*at4(s, mo, lg));
      int bits = k;  // count, int32 sum, int32 min / max
      if (!mo.is_int && mo.op == kMin)
        bits = k == INT_MAX ? 0x7f800000
             : k == INT_MIN ? 0x7fc00000 : __float_as_int(key_to_float(k));
      else if (!mo.is_int && mo.op == kMax)
        bits = k == INT_MIN ? static_cast<int>(0xff800000u)
             : k == INT_MAX ? 0x7fc00000 : __float_as_int(key_to_float(k));
      static_cast<int*>(mo.out)[g] = bits;
    }
  }
}

// Group lg of the shared state sm into group g of the global state gl,
// one atomic per slot that holds more than its identity.
__device__ void merge_group(const Params& p, const State& sm,
                            const State& gl, int lg, int g) {
  const unsigned r = *rows_at(p, sm, lg);
  if (r == 0u) return;
  atomicAdd(rows_at(p, gl, g), r);
  for (int m = 0; m < p.nmom; ++m) {
    const Moment& mo = p.mom[m];
    if (mo.wide) {
      const unsigned long long v = *at8(sm, mo, lg);
      if (mo.op == kSum || mo.op == kSumSq) {
        if (v != 0ull)
          atomicAdd(reinterpret_cast<double*>(at8(gl, mo, g)),
                    __longlong_as_double(static_cast<long long>(v)));
      } else if (static_cast<long long>(v) != LLONG_MAX) {
        atomicMin(reinterpret_cast<long long*>(at8(gl, mo, g)),
                  static_cast<long long>(v));
      }
    } else {
      const unsigned v = *at4(sm, mo, lg);
      if (mo.op == kMin) {
        if (static_cast<int>(v) != INT_MAX)
          atomicMin(reinterpret_cast<int*>(at4(gl, mo, g)),
                    static_cast<int>(v));
      } else if (mo.op == kMax) {
        if (static_cast<int>(v) != INT_MIN)
          atomicMax(reinterpret_cast<int*>(at4(gl, mo, g)),
                    static_cast<int>(v));
      } else if (v != 0u) {
        atomicAdd(at4(gl, mo, g), v);
      }
    }
  }
}

// Whether group g's state lives in global memory (q: the launch's plan):
// every group on the small path and where the copies come in chunks,
// else a partition's of several work items.
__device__ __forceinline__ bool global_state(const Part& q, int g) {
  if (q.item_start == nullptr || (q.merge_copies && q.gmeta[3] != 0))
    return true;
  const int pp = g / q.Gp;
  return q.item_start[pp + 1] - q.item_start[pp] > 1;
}

__global__ void init_state(const __grid_constant__ Params p, State s,
                           Part q) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.G || !global_state(q, g)) return;
  for (int j = 0; j < p.n8; ++j)
    s.w8[static_cast<long long>(j) * s.stride + g] = p.ident8[j];
  for (int j = 0; j <= p.n4; ++j)
    s.w4[static_cast<long long>(j) * s.stride + g] = p.ident4[j];
}

__global__ void finalize(const __grid_constant__ Params p, State s,
                         Part q) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.G || !global_state(q, g)) return;
  finish_group(p, s, g, g);
}

// The small path: every block holds all G groups (a state of G rounded
// up to 32 groups, swizzled).
__global__ void __launch_bounds__(kThreads)
rows_shared(const __grid_constant__ Params p, State gl) {
  extern __shared__ unsigned long long smem[];
  const int stride = (p.G + 31) & ~31;
  const State sm{smem, reinterpret_cast<unsigned*>(
                           smem + static_cast<long long>(p.n8) * stride),
                 stride};
  init_shared(p, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x *
                         kUnroll;
  for (long long base = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         (threadIdx.x & ~31)) * kUnroll;
       base < p.n; base += step) {
    Tile tl;
    tl.valid = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      const bool in = i < p.n;
      const bool m = in && p.rmask[i];
      const int g = in ? __ldg(p.gids + i) : -1;
      const bool v = m && static_cast<unsigned>(g) <
                              static_cast<unsigned>(p.G);
      tl.i[u] = tl.at[u] = static_cast<int>(in ? i : 0);
      tl.g[u] = v ? swizzle(g) : 0;
      tl.valid |= static_cast<unsigned>(v) << u;
    }
    add_tile(p, sm, tl, false);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < p.G; g += blockDim.x)
    merge_group(p, sm, gl, swizzle(g), g);
}

// Passes 1 (counts) and 2 (scatter), over all rows: warp w of block b
// takes segment s = b * kSegWarps + w, rows [s * S, (s + 1) * S). Its
// counters (pass 1) or cursors (pass 2) are warp-private: no block
// barrier, no atomic.
template <bool kScatter>
__global__ void __launch_bounds__(kSegWarps * 32)
segments(const __grid_constant__ Params p, Part q) {
  extern __shared__ int cells[];  // [kSegWarps][window]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kSegWarps + warp;
  if (s >= q.NS) return;
  const int win = q.P < kWindow ? q.P : kWindow;
  int* mine = cells + warp * win;
  const long long r0 = static_cast<long long>(s) * q.S;
  const long long r1 = r0 + q.S < p.n ? r0 + q.S : p.n;
  const unsigned below = (1u << lane) - 1u;
  if (kScatter && q.gmeta[3] != 0) return;  // scatter_copies' turn
  int runs = 0, steps = 0;  // pass 1: partitions met, steps with rows
  for (int p0 = 0; p0 < q.P; p0 += win) {
    const int pw = q.P - p0 < win ? q.P - p0 : win;
    for (int k = lane; k < pw; k += 32)
      mine[k] = kScatter ? q.origin[p0 + k] +
                           q.rel[static_cast<long long>(p0 + k) * q.NSall + s]
                         : 0;
    __syncwarp();
    for (long long base = r0; base < r1; base += 32 * kSegUnroll) {
      // the steps' loads first, so they are in flight together
      int part[kSegUnroll];
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const long long i = base + u * 32 + lane;
        const bool in = i < r1;
        const bool m = in && p.rmask[i];
        const int g = in ? __ldg(p.gids + i) : -1;
        part[u] = m && static_cast<unsigned>(g) < static_cast<unsigned>(p.G)
                      ? g / q.Gp - p0 : -1;
        if (part[u] >= pw) part[u] = -1;
      }
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const int pt = part[u];
        const unsigned vb = __ballot_sync(kFull, pt >= 0);
        if (vb == 0u) continue;
        const int ref = __shfl_sync(kFull, pt, __ffs(vb) - 1);
        // the lanes of this lane's partition (the same for all of them)
        unsigned peers;
        if (__all_sync(kFull, pt < 0 || pt == ref))
          peers = pt >= 0 ? vb : 0u;
        else
          peers = __match_any_sync(kFull, pt);
        const bool first = pt >= 0 && lane == __ffs(peers) - 1;
        if (!kScatter) {
          runs += __popc(__ballot_sync(kFull, first));
          ++steps;
        }
        const int at = pt >= 0 ? mine[pt] : 0;
        if (kScatter && pt >= 0)
          q.list[at + __popc(peers & below)] =
              static_cast<int>(base + u * 32 + lane);
        __syncwarp();
        if (first) mine[pt] = at + __popc(peers);
        __syncwarp();
      }
    }
    if (!kScatter)
      for (int k = lane; k < pw; k += 32)
        q.rel[static_cast<long long>(p0 + k) * q.NSall + s] = mine[k];
    __syncwarp();
  }
  if (!kScatter && lane == 0 && steps > 0) {
    atomicAdd(q.meta + 1, runs);
    atomicAdd(q.meta + 2, steps);
  }
}

// Pass 2 where the rows' order scatters them (Part::meta[3]), over one
// plan's segments (p: their rows): block b takes its segments
// b * kSegWarps.. (one range of each partition's list),
// kStage rows at a time. It counts the chunk's rows per partition in
// shared memory and gives each row its place in the chunk's partition
// order (within a partition the rows keep no particular order); then,
// column by column (the row index, the group within the partition,
// each input column), the block reads the chunk's values coalesced,
// puts them in that order in shared memory, and writes each
// partition's run to its place in the list, one contiguous write.
__global__ void __launch_bounds__(kSegWarps * 32)
scatter_copies(const __grid_constant__ Params p, Part q) {
  constexpr int kPer = kStage / (kSegWarps * 32);  // rows a thread reads
  __shared__ int cur[kCopyParts], cnt[kCopyParts], off[kCopyParts];
  __shared__ unsigned buf[kStage];  // one column in partition order
  if (q.gmeta[3] == 0) return;
  const int s0 = blockIdx.x * kSegWarps;
  const long long r0 = static_cast<long long>(s0) * q.S;
  const long long r1 = r0 + static_cast<long long>(kSegWarps) * q.S < p.n
                           ? r0 + static_cast<long long>(kSegWarps) * q.S
                           : p.n;
  for (int k = threadIdx.x; k < q.P; k += blockDim.x)
    cur[k] = q.origin[k] +
             q.rel[static_cast<long long>(k) * q.NSall + q.seg0 + s0];
  for (long long c0 = r0; c0 < r1; c0 += kStage) {
    const int rows = r1 - c0 < kStage ? static_cast<int>(r1 - c0) : kStage;
    for (int k = threadIdx.x; k < q.P; k += blockDim.x) cnt[k] = 0;
    __syncthreads();
    // this thread's rows r = k * blockDim + tid: (partition << 16) |
    // group within it (-1: the row counts nowhere), and its rank
    int pg[kPer], place[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = k * kSegWarps * 32 + threadIdx.x;
      pg[k] = -1;
      if (r < rows && p.rmask[c0 + r]) {
        const int g = __ldg(p.gids + c0 + r);
        if (static_cast<unsigned>(g) < static_cast<unsigned>(p.G)) {
          const int pt = g / q.Gp;
          pg[k] = (pt << 16) | (g - pt * q.Gp);
          place[k] = atomicAdd(cnt + pt, 1);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // where each partition's run starts
      int carry = 0;
      for (int k0 = 0; k0 < q.P; k0 += 32) {
        const int k = k0 + threadIdx.x;
        const int v = k < q.P ? cnt[k] : 0;
        int x = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, x, o);
          if (threadIdx.x >= o) x += y;
        }
        if (k < q.P) off[k] = carry + x - v;
        carry += __shfl_sync(kFull, x, 31);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (pg[k] >= 0) place[k] += off[pg[k] >> 16];
    const int live = off[q.P - 1] + cnt[q.P - 1];
    // where each place of the chunk goes in the list: its partition
    // first (through buf), then the list index
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (pg[k] >= 0) buf[place[k]] = pg[k] >> 16;
    __syncthreads();
    int to[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = k * kSegWarps * 32 + threadIdx.x;
      to[k] = t < live ? cur[buf[t]] + t - off[buf[t]] : 0;
    }
    // column by column: -2 the row index, -1 the group, then the inputs
    for (int c = -2; c < p.ncol; ++c) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (pg[k] < 0) continue;
        const long long i = c0 + k * kSegWarps * 32 + threadIdx.x;
        buf[place[k]] =
            c == -2 ? static_cast<unsigned>(i)
            : c == -1 ? static_cast<unsigned>(pg[k] & 0xffff)
            : p.col[c].bytes == 4
                ? __ldg(static_cast<const unsigned*>(p.col[c].src) + i)
                : __ldg(static_cast<const unsigned char*>(p.col[c].src) + i);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int t = k * kSegWarps * 32 + threadIdx.x;
        if (t >= live) break;
        if (c == -2)
          q.list[to[k]] = static_cast<int>(buf[t]);
        else if (c == -1)
          q.grp[to[k]] = static_cast<int>(buf[t]);
        else if (p.col[c].bytes == 4)
          static_cast<unsigned*>(p.col[c].dst)[to[k]] = buf[t];
        else
          static_cast<unsigned char*>(p.col[c].dst)[to[k]] =
              static_cast<unsigned char>(buf[t]);
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < q.P; k += blockDim.x) cur[k] += cnt[k];
    __syncthreads();
  }
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sums[warp - 1] : 0;
  *total = sums[nwarps - 1];
  __syncthreads();
  return before + x - v;
}

// One block a partition: its segments' counts to offsets within the
// partition (each thread kScanPer consecutive counts at a time), and the
// partition's rows.
__global__ void __launch_bounds__(kScanThreads) scan_partitions(Part q) {
  constexpr int kScanPer = 8;
  int* row = q.rel + static_cast<long long>(blockIdx.x) * q.NSall;
  int carry = 0;
  for (int c0 = 0; c0 < q.NS; c0 += blockDim.x * kScanPer) {
    const int s = c0 + threadIdx.x * kScanPer;
    int v[kScanPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = s + k < q.NS ? row[s + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_scan(sum, &total);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (s + k < q.NS) row[s + k] = run;
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) q.glen[blockIdx.x] = carry;
}

// One block, one plan: each partition's rows in the plan's segments and
// where they start in the list, the rows of a work item (the live rows
// over q.target, at least kMinChunk, a whole number of pass 3's block
// tiles: a tile's lanes idle past an item's end) and each partition's
// first work item (an empty partition takes one, which writes its
// groups' empty outputs). The launch's plan (decide) also decides
// whether passes 2-3 copy; a chunk's plan is skipped when they gather.
__global__ void __launch_bounds__(kScanThreads) plan_items(Part q,
                                                           int decide) {
  if (!decide && q.gmeta[3] == 0) return;
  const int end = q.seg0 + q.NS;
  int carry = 0;
  for (int c0 = 0; c0 < q.P; c0 += blockDim.x) {
    const int pp = c0 + threadIdx.x;
    int v = 0, at0 = 0;
    if (pp < q.P) {
      const int* row = q.rel + static_cast<long long>(pp) * q.NSall;
      at0 = row[q.seg0];
      v = (end < q.NSall ? row[end] : q.glen[pp]) - at0;
    }
    int total;
    const int ex = block_scan(v, &total);
    if (pp < q.P) {
      q.part_len[pp] = v;
      q.part_start[pp] = carry + ex;
      q.origin[pp] = carry + ex - at0;
    }
    carry += total;
  }
  constexpr int kTile = kAggThreads * kUnroll;
  const int per = (carry + q.target - 1) / q.target;
  const int chunk = ((per > kMinChunk ? per : kMinChunk) + kTile - 1) /
                    kTile * kTile;
  int items = 0;
  for (int c0 = 0; c0 < q.P; c0 += blockDim.x) {
    const int pp = c0 + threadIdx.x;
    int v = 0;
    if (pp < q.P) {
      v = (q.part_len[pp] + chunk - 1) / chunk;
      v = v > 1 ? v : 1;
    }
    int total;
    const int ex = block_scan(v, &total);
    if (pp < q.P) q.item_start[pp] = items + ex;
    items += total;
  }
  if (threadIdx.x == 0) {
    q.item_start[q.P] = items;
    q.meta[0] = chunk;
    q.meta[4] = 0;
    if (decide)
      q.meta[3] = q.P <= kCopyParts &&
                  static_cast<long long>(q.meta[1]) >
                      static_cast<long long>(kCopyAbove) * q.meta[2];
  }
}

// Pass 3: persistent blocks over one plan's work items (p: its rows).
__global__ void __launch_bounds__(kAggThreads, kAggBlocksPerSm)
aggregate(const __grid_constant__ Params p, Part q, State gl) {
  extern __shared__ unsigned long long smem[];
  __shared__ int item, part_of_item;
  const State sm{smem, reinterpret_cast<unsigned*>(
                           smem + static_cast<long long>(p.n8) * q.Gp),
                 q.Gp};
  const int lane = threadIdx.x & 31;
  const bool copied = q.gmeta[3] != 0;
  if (q.mode != 2 && q.mode != static_cast<int>(copied)) return;
  const int total = q.item_start[q.P];
  const int chunk = q.meta[0];
  for (;;) {
    // the next work item from the shared queue (blocks that finish early
    // take more), and its partition
    __syncthreads();
    if (threadIdx.x == 0) {
      const int it = atomicAdd(q.meta + 4, 1);
      int lo = 0, hi = q.P;  // item_start[lo] <= it < item_start[hi]
      while (it < total && hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (q.item_start[mid] <= it) lo = mid; else hi = mid;
      }
      item = it;
      part_of_item = lo;
    }
    __syncthreads();
    const int it = item;
    if (it >= total) break;
    init_shared(p, sm);
    __syncthreads();
    const int pp = part_of_item;
    const int first = q.item_start[pp];
    const int nitems = q.item_start[pp + 1] - first;
    const int g0 = pp * q.Gp;
    const int gn = p.G - g0 < q.Gp ? p.G - g0 : q.Gp;
    const long long end = static_cast<long long>(q.part_start[pp]) +
                          q.part_len[pp];
    const long long j0 = q.part_start[pp] +
                         static_cast<long long>(it - first) * chunk;
    const long long j1 = j0 + chunk < end ? j0 + chunk : end;
    for (long long base = j0 + (threadIdx.x & ~31) * kUnroll; base < j1;
         base += static_cast<long long>(blockDim.x) * kUnroll) {
      Tile tl;
      tl.valid = 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = base + u * 32 + lane;
        const bool v = j < j1;
        tl.i[u] = v ? __ldg(q.list + j) : 0;
        tl.at[u] = copied ? static_cast<int>(v ? j : 0) : tl.i[u];
        if (copied) tl.g[u] = v ? swizzle(__ldg(q.grp + j)) : 0;
        tl.valid |= static_cast<unsigned>(v) << u;
      }
      if (!copied) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          tl.g[u] = (tl.valid >> u) & 1u
                        ? swizzle(__ldg(p.gids + tl.i[u]) - g0) : 0;
      }
      add_tile(p, sm, tl, copied);
    }
    __syncthreads();
    if (nitems == 1 && !(copied && q.merge_copies)) {
      for (int lg = threadIdx.x; lg < gn; lg += blockDim.x)
        finish_group(p, sm, swizzle(lg), g0 + lg);
    } else {
      for (int lg = threadIdx.x; lg < gn; lg += blockDim.x)
        merge_group(p, sm, gl, swizzle(lg), g0 + lg);
    }
  }
}

int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return 132;
  return sms;
}

long long align_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

int group_bytes(int nmom, const int* ops, const int* is_int) {
  int b = 4;  // the row count
  for (int m = 0; m < nmom; ++m) b += is_wide(ops[m], is_int[m]) ? 8 : 4;
  return b;
}

// The most groups a state within `budget` bytes holds: a multiple of
// 32 (the swizzle permutes aligned blocks of 32 groups).
int groups_within(int budget, int gb) { return budget / gb / 32 * 32; }

bool small_path(int n, int G, int gb) {
  return n == 0 || G <= groups_within(kSmallBudget, gb);
}

bool valid_ops(int nmom, const int* ops) {
  if (nmom < 0 || nmom > kMaxMoments) return false;
  for (int m = 0; m < nmom; ++m)
    if (ops[m] < kCount || ops[m] > kLastKey) return false;
  return true;
}

// The moments of a launch into p (slots, identities, the input columns
// pass 2 copies, each distinct column once by address: a value column
// for sum, sum_sq, min and max, ts for first/last, a column mask).
// outs may be null (sizing only).
void describe(Params& p, int nmom, const void* const* vals,
              const unsigned char* const* cmasks, void* const* outs,
              const int* ops, const int* is_int, const int* ts) {
  p.nmom = nmom;
  auto column = [&](const void* src, int bytes) {
    for (int c = 0; c < p.ncol; ++c)
      if (p.col[c].src == src && p.col[c].bytes == bytes) return c;
    p.col[p.ncol] = Column{src, nullptr, bytes};
    return p.ncol++;
  };
  for (int m = 0; m < nmom; ++m) {
    const int wide = is_wide(ops[m], is_int[m]) ? 1 : 0;
    const int slot = wide ? p.n8++ : p.n4++;
    const void* src = ops[m] >= kFirst ? static_cast<const void*>(ts)
                      : ops[m] == kCount ? nullptr : vals[m];
    p.mom[m] = Moment{vals[m], cmasks[m], outs ? outs[m] : nullptr, ops[m],
                      is_int[m], wide, slot,
                      src != nullptr ? column(src, 4) : -1,
                      cmasks[m] != nullptr ? column(cmasks[m], 1) : -1};
    if (wide)
      p.ident8[slot] = ops[m] == kSum || ops[m] == kSumSq
                           ? 0ull
                           : static_cast<unsigned long long>(LLONG_MAX);
    else
      p.ident4[slot] = ops[m] == kMin   ? static_cast<unsigned>(INT_MAX)
                       : ops[m] == kMax ? static_cast<unsigned>(INT_MIN)
                                        : 0u;
    if (ops[m] >= kFirst) p.need_ts = 1;
  }
  p.ident4[p.n4] = 0u;  // the row counts
}

// A launch's sizes and the byte offsets of its scratch's parts: the
// global state, then (partition path) the counts, the launch's plan and
// a chunk's, and one area that holds the row list of all rows where
// passes 2-3 gather, or one chunk's row list, groups and copied columns
// where they copy (the chunk's rows R: its part within kChunkBytes).
struct Sizes {
  bool small;
  int gb, Gp, P, S, NSall, chunk_segs, chunks;
  long long R;
  long long rel, plans[2], area, grp, copies, total;
};

// A plan's arrays: part_len, part_start, origin [P], item_start [P + 1],
// meta, each 256-byte aligned.
long long plan_bytes(int P) {
  return 3 * align_up(4ll * P) + align_up(4ll * (P + 1)) + kAlign;
}

Sizes sizes(const Params& p) {
  Sizes z{};
  z.gb = 4;
  for (int m = 0; m < p.nmom; ++m) z.gb += p.mom[m].wide ? 8 : 4;
  z.small = small_path(p.n, p.G, z.gb);
  long long off = align_up(static_cast<long long>(p.G) * z.gb);
  if (!z.small) {
    int words = 0, bytes = 0;
    for (int c = 0; c < p.ncol; ++c) (p.col[c].bytes == 4 ? words : bytes)++;
    z.Gp = groups_within(kPartBudget, z.gb);
    z.P = (p.G + z.Gp - 1) / z.Gp;
    const long long per_row = 8 + 4ll * words + bytes;
    long long R = kChunkBytes / per_row;
    R = R > kMinChunkRows ? R : kMinChunkRows;
    // copies only up to kCopyParts partitions; of all rows in one chunk
    const bool may_copy = z.P <= kCopyParts;
    const bool one = !may_copy || p.n <= R;
    R = one ? p.n : R;
    // segments: about a chunk's rows over kSegments, and few enough for
    // the [partition][segment] counts
    long long S = (R + kSegments - 1) / kSegments;
    S = S < kSegRowsMin ? kSegRowsMin : S > kSegRowsMax ? kSegRowsMax : S;
    const long long per_count = kMaxCounts / z.P > 1 ? kMaxCounts / z.P : 1;
    const long long S_counts = (p.n + per_count - 1) / per_count;
    S = ((S > S_counts ? S : S_counts) + 31) / 32 * 32;
    z.S = static_cast<int>(S);
    z.NSall = static_cast<int>((p.n + S - 1) / S);
    z.chunk_segs = one ? z.NSall : static_cast<int>(R / S > 1 ? R / S : 1);
    z.chunks = (z.NSall + z.chunk_segs - 1) / z.chunk_segs;
    z.R = z.chunks > 1 ? static_cast<long long>(z.chunk_segs) * S : p.n;
    z.rel = off;
    off += align_up(static_cast<long long>(z.P) * z.NSall * 4);
    z.plans[0] = off;
    off += plan_bytes(z.P);
    z.plans[1] = off;
    off += plan_bytes(z.P);
    z.area = off;
    z.grp = z.area + align_up(z.R * 4);
    z.copies = z.grp + align_up(z.R * 4);
    const long long copy_end =
        may_copy
            ? z.copies + words * align_up(z.R * 4) + bytes * align_up(z.R)
            : 0;
    const long long gather_end = z.area + align_up(4ll * p.n);
    off = copy_end > gather_end ? copy_end : gather_end;
  }
  z.total = off;
  return z;
}

// p's rows [c0, c0 + rows) as a launch of their own: rows, ts, masks and
// columns from c0 on, numbered row_base + c0 + i.
Params chunk_of(const Params& p, long long c0, int rows) {
  Params c = p;
  c.gids += c0;
  c.rmask += c0;
  if (c.ts != nullptr) c.ts += c0;
  c.row_base += c0;
  c.n = rows;
  for (int m = 0; m < c.nmom; ++m) {
    if (c.mom[m].val != nullptr)
      c.mom[m].val = static_cast<const char*>(c.mom[m].val) + 4 * c0;
    if (c.mom[m].cmask != nullptr) c.mom[m].cmask += c0;
  }
  for (int k = 0; k < c.ncol; ++k)
    c.col[k].src = static_cast<const char*>(c.col[k].src) +
                   c.col[k].bytes * c0;
  return c;
}

template <typename Kernel>
cudaError_t set_smem(Kernel* fn, long long bytes) {
  // set on every launch: a launch must not depend on what an earlier one
  // set on this device
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int blocks_for(long long items, int threads) {
  return static_cast<int>((items + threads - 1) / threads);
}

}  // namespace

extern "C" {

int grouped_moments_max_moments() { return kMaxMoments; }

// The most groups the small path takes (every block holds them all).
int grouped_moments_smem_groups(int nmom, const int* ops,
                                const int* is_int) {
  return valid_ops(nmom, ops)
             ? groups_within(kSmallBudget, group_bytes(nmom, ops, is_int))
             : -1;
}

// The most groups a partition takes (one block's shared memory).
int grouped_moments_partition_groups(int nmom, const int* ops,
                                     const int* is_int) {
  return valid_ops(nmom, ops)
             ? groups_within(kPartBudget, group_bytes(nmom, ops, is_int))
             : -1;
}

// Bytes of scratch grouped_moments_launch needs for these arguments (the
// same host arrays; device pointers are compared, not read): the groups'
// state and, above the small path, the counts, two plans and the larger
// of the row list (4 bytes a row) and one chunk's copies (within
// kChunkBytes). -1 for arguments the launch refuses.
long long grouped_moments_scratch_bytes(int n, int G, int nmom,
                                        const int* ops, const int* is_int,
                                        const void* const* vals,
                                        const unsigned char* const* cmasks,
                                        const int* ts) {
  if (n < 0 || G < 0 || !valid_ops(nmom, ops)) return -1;
  Params p{};
  p.n = n;
  p.G = G;
  describe(p, nmom, vals, cmasks, nullptr, ops, is_int, ts);
  return sizes(p).total;
}

// Launches the kernels of one call on `stream` (a cudaStream_t passed
// as a pointer) of the calling thread's current device. Device
// pointers: gids int32 [n], row_mask bool [n], ts int32 [n] (read by
// first/last only), counts int32 [G] or null, each vals[m] float32 or
// int32 [n] (is_int says which), each cmasks[m] bool [n] or null, each
// outs[m] [G] of the moment's output type (int64 for the keys), scratch
// of scratch_bytes (at least grouped_moments_scratch_bytes), 256-byte
// aligned. The pointer arrays and ops / is_int live on the host.
// Returns the CUDA error code (0 on success).
int grouped_moments_launch(const int* gids, int n, int G,
                           const unsigned char* row_mask, const int* ts,
                           long long row_base, int* counts, int nmom,
                           const void* const* vals,
                           const unsigned char* const* cmasks,
                           void* const* outs, const int* ops,
                           const int* is_int, void* scratch,
                           long long scratch_bytes, void* stream) {
  if (n < 0 || G < 0 || !valid_ops(nmom, ops))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.gids = gids;
  p.rmask = row_mask;
  p.ts = ts;
  p.counts = counts;
  p.row_base = row_base;
  p.n = n;
  p.G = G;
  describe(p, nmom, vals, cmasks, outs, ops, is_int, ts);
  const Sizes z = sizes(p);
  if (scratch_bytes < z.total || row_base < 0 ||
      row_base + n > 0xffffffffll ||
      reinterpret_cast<uintptr_t>(scratch) % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const int gb = z.gb;
  char* base = static_cast<char*>(scratch);
  State gl{reinterpret_cast<unsigned long long*>(base),
           reinterpret_cast<unsigned*>(reinterpret_cast<unsigned long long*>(
                                           base) +
                                       static_cast<long long>(p.n8) * G),
           G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms();
  const int g_blocks = blocks_for(G, kThreads);
  cudaError_t err;

  if (z.small) {
    const Part all{};
    init_state<<<g_blocks, kThreads, 0, st>>>(p, gl, all);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (n > 0) {
      const long long smem = static_cast<long long>((G + 31) & ~31) * gb;
      if ((err = set_smem(rows_shared, smem)) != cudaSuccess)
        return err;
      int per_sm = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, rows_shared, kThreads, static_cast<size_t>(smem))) !=
          cudaSuccess)
        return err;
      const long long want = blocks_for(n, kThreads);
      const long long cap = static_cast<long long>(sms) *
                            (per_sm > 0 ? per_sm : 1);
      rows_shared<<<static_cast<int>(want < cap ? want : cap), kThreads,
                    static_cast<size_t>(smem), st>>>(p, gl);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    finalize<<<g_blocks, kThreads, 0, st>>>(p, gl, all);
    return static_cast<int>(cudaGetLastError());
  }

  // the launch's plan (q) over all rows and a chunk's (c)
  Part q{};
  q.Gp = z.Gp;
  q.P = z.P;
  q.S = z.S;
  q.NSall = q.NS = z.NSall;
  q.target = kTargetItems;
  q.mode = z.chunks > 1 ? 0 : 2;
  q.merge_copies = z.chunks > 1;
  q.rel = reinterpret_cast<int*>(base + z.rel);
  q.list = reinterpret_cast<int*>(base + z.area);
  q.grp = reinterpret_cast<int*>(base + z.grp);
  Part c = q;
  Part* plans[2] = {&q, &c};
  for (int k = 0; k < 2; ++k) {
    const long long at = z.plans[k];
    const long long b4 = align_up(4ll * z.P);
    plans[k]->part_len = reinterpret_cast<int*>(base + at);
    plans[k]->part_start = reinterpret_cast<int*>(base + at + b4);
    plans[k]->origin = reinterpret_cast<int*>(base + at + 2 * b4);
    plans[k]->item_start = reinterpret_cast<int*>(base + at + 3 * b4);
    plans[k]->meta = reinterpret_cast<int*>(
        base + at + 3 * b4 + align_up(4ll * (z.P + 1)));
  }
  q.glen = c.glen = q.part_len;
  q.gmeta = c.gmeta = q.meta;
  c.mode = 1;
  int words = 0;
  for (int k = 0; k < p.ncol; ++k) words += p.col[k].bytes == 4;
  for (int k = 0, w = 0, b1 = 0; k < p.ncol; ++k)
    p.col[k].dst = base + z.copies +
                   (p.col[k].bytes == 4
                        ? (w++) * align_up(z.R * 4)
                        : words * align_up(z.R * 4) + (b1++) * align_up(z.R));

  const long long seg_smem = static_cast<long long>(kSegWarps) * 4 *
                             (q.P < kWindow ? q.P : kWindow);
  const long long smem = static_cast<long long>(z.Gp) * gb;
  if ((err = set_smem(segments<false>, seg_smem)) != cudaSuccess ||
      (err = set_smem(segments<true>, seg_smem)) != cudaSuccess ||
      (err = set_smem(aggregate, smem)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, aggregate, kAggThreads, static_cast<size_t>(smem))) !=
      cudaSuccess)
    return err;
  const long long items = static_cast<long long>(q.P) + kTargetItems;
  const long long cap = static_cast<long long>(sms) *
                        (per_sm > 0 ? per_sm : 1);
  const int agg_blocks = static_cast<int>(items < cap ? items : cap);

  // pass 1 and the launch's plan over all rows (it decides whether
  // passes 2-3 gather or copy), the global state's init, pass 2's row
  // list where they gather
  const int seg_blocks = blocks_for(q.NSall, kSegWarps);
  if ((err = cudaMemsetAsync(q.meta, 0, 5 * sizeof(int), st)) !=
      cudaSuccess)
    return err;
  segments<false><<<seg_blocks, kSegWarps * 32,
                    static_cast<size_t>(seg_smem), st>>>(p, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_partitions<<<q.P, kScanThreads, 0, st>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  plan_items<<<1, kScanThreads, 0, st>>>(q, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  init_state<<<g_blocks, kThreads, 0, st>>>(p, gl, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  segments<true><<<seg_blocks, kSegWarps * 32,
                   static_cast<size_t>(seg_smem), st>>>(p, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (z.chunks == 1) {  // copies of all rows, or none
    scatter_copies<<<seg_blocks, kSegWarps * 32, 0, st>>>(p, q);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // pass 3 where the launch gathers (or its copies came in one chunk)
  aggregate<<<agg_blocks, kAggThreads, static_cast<size_t>(smem), st>>>(
      p, q, gl);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // where it copies in chunks: each chunk's plan, copies and pass 3 (all
  // three return at once where the launch gathers)
  for (int k = 0; z.chunks > 1 && k < z.chunks; ++k) {
    c.seg0 = k * z.chunk_segs;
    c.NS = z.NSall - c.seg0 < z.chunk_segs ? z.NSall - c.seg0 : z.chunk_segs;
    const long long c0 = static_cast<long long>(c.seg0) * z.S;
    const long long c1 = c0 + static_cast<long long>(c.NS) * z.S;
    const int rows = static_cast<int>((c1 < n ? c1 : n) - c0);
    const long long t = static_cast<long long>(kTargetItems) * rows / n;
    c.target = static_cast<int>(t > 2ll * agg_blocks ? t : 2ll * agg_blocks);
    const Params pc = chunk_of(p, c0, rows);
    plan_items<<<1, kScanThreads, 0, st>>>(c, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_copies<<<blocks_for(c.NS, kSegWarps), kSegWarps * 32, 0, st>>>(
        pc, c);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    aggregate<<<agg_blocks, kAggThreads, static_cast<size_t>(smem), st>>>(
        pc, c, gl);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  finalize<<<g_blocks, kThreads, 0, st>>>(p, gl, q);
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
