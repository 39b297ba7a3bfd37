// Grouped moments on Hopper (sm_90a): every moment of a group-by over
// UNSORTED group ids, in one pass over the rows.
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
// operations per row and moment is far below the card's rates. Unlike
// the sorted case (segment_moments.cu) nothing says where a group's rows
// lie, so every counted row updates its group's state in memory that
// other rows share.
//
// Design: one pass of atomics, privatised per block when the groups fit.
// - Every accumulator is a 64-bit slot: an unsigned add for counts and
//   int32 sums (the low 32 bits are the sum mod 2^32), a double add for
//   float sums and squares, a signed min / max for min and max (float
//   values as order-preserving integers: b >= 0 ? b : b ^ 0x7fffffff,
//   NaN as a key below every value for min and above for max, so it
//   wins as jnp's NaN-propagating min / max lets it), and a signed min
//   of the packed (ts, row) key for first / last. Every op is one
//   hardware atomic on sm_90, in shared and in global memory.
// - When G * (8 * moments + 4) bytes fit kSmemBudget, each block keeps
//   its own accumulators in shared memory: the block sets them to their
//   identities, strides the rows (grid-stride, one row a thread per trip,
//   coalesced loads) with shared-memory atomics, then adds each group it
//   touched into global memory with one global atomic per slot.
// - Above it, the rows go straight to global atomics: at TSBS's 48 000
//   groups (host x hour) the state is megabytes, far past a block's
//   227 KB, and consecutive rows of a time-ordered scan hit different
//   groups, so the atomics rarely collide.
// - An init kernel sets the global state to the identities, and a
//   finalize kernel turns it into the outputs (doubles rounded to
//   float32, keys decoded, first / last values gathered at the winning
//   row).
// Float sums depend on the order the atomics land in: the same inputs
// may differ in the last bits between runs (the reference's scatter sum
// is order-dependent too). Counts, min, max, first and last are exact.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMoments = 32;
constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;  // privatised state per block
constexpr int kBlocksPerSm = 8;         // grid of the global-atomic path

enum Op : int {
  kCount = 0, kSum = 1, kSumSq = 2, kMin = 3, kMax = 4, kFirst = 5,
  kLast = 6, kFirstKey = 7, kLastKey = 8
};

// NaN's keys: below every int32 key (min) or above (max); the identities
// are LLONG_MAX (min, first, last) and LLONG_MIN (max)
constexpr long long kNanMin = static_cast<long long>(INT_MIN) - 1;
constexpr long long kNanMax = static_cast<long long>(INT_MAX) + 1;

struct Moment {
  const void* val;
  const unsigned char* cmask;  // nullptr: the row mask alone
  void* out;
  int op;
  int is_int;
};

struct Params {
  const int* gids;
  const unsigned char* rmask;
  const int* ts;
  int* counts;                // nullptr: no row counts in this launch
  unsigned long long* acc;    // [nmom][G] 64-bit slots
  unsigned* rows;             // [G] row counts
  long long row_base;
  int n;
  int G;
  int nmom;
  int need_ts;
  Moment mom[kMaxMoments];
};

__device__ __forceinline__ long long identity(int op) {
  return op == kMax ? LLONG_MIN
                    : (op == kMin || op >= kFirst ? LLONG_MAX : 0LL);
}

__device__ __forceinline__ long long order_key(const void* val, int i,
                                               int is_int, int op) {
  if (is_int) return static_cast<const int*>(val)[i];
  float x = static_cast<const float*>(val)[i];
  if (x != x) return op == kMin ? kNanMin : kNanMax;
  int b = __float_as_int(x);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

__device__ __forceinline__ double as_double(const void* val, int i,
                                            int is_int) {
  return is_int ? static_cast<double>(static_cast<const int*>(val)[i])
                : static_cast<double>(static_cast<const float*>(val)[i]);
}

// One row into the state at (acc, rows), in shared or global memory:
// slot m of group g is acc[m * G + g].
__device__ __forceinline__ void add_row(const Params& p, int i, int g,
                                        unsigned long long* acc,
                                        unsigned* rows) {
  atomicAdd(rows + g, 1u);
  const int t = p.need_ts ? p.ts[i] : 0;
  for (int m = 0; m < p.nmom; ++m) {
    const Moment& mo = p.mom[m];
    if (mo.cmask != nullptr && !mo.cmask[i]) continue;
    unsigned long long* slot = acc + static_cast<long long>(m) * p.G + g;
    switch (mo.op) {
      case kCount:
        atomicAdd(slot, 1ull);
        break;
      case kSum:
        if (mo.is_int)
          atomicAdd(slot, static_cast<unsigned long long>(static_cast<
              unsigned>(static_cast<const int*>(mo.val)[i])));
        else
          atomicAdd(reinterpret_cast<double*>(slot),
                    as_double(mo.val, i, 0));
        break;
      case kSumSq: {
        double x = as_double(mo.val, i, mo.is_int);
        atomicAdd(reinterpret_cast<double*>(slot), x * x);
        break;
      }
      case kMin:
        atomicMin(reinterpret_cast<long long*>(slot),
                  order_key(mo.val, i, mo.is_int, kMin));
        break;
      case kMax:
        atomicMax(reinterpret_cast<long long*>(slot),
                  order_key(mo.val, i, mo.is_int, kMax));
        break;
      default: {  // first / last and their keys
        const bool first = mo.op == kFirst || mo.op == kFirstKey;
        const long long hi = first ? t : ~t;
        const long long key = static_cast<long long>(
            (static_cast<unsigned long long>(hi) << 32) |
            (static_cast<unsigned long long>(p.row_base + i) &
             0xffffffffull));
        atomicMin(reinterpret_cast<long long*>(slot), key);
      }
    }
  }
}

__device__ __forceinline__ bool live(const Params& p, int i, int* g) {
  if (!p.rmask[i]) return false;
  *g = p.gids[i];
  return static_cast<unsigned>(*g) < static_cast<unsigned>(p.G);
}

__global__ void init_state(Params p) {
  const long long slots = static_cast<long long>(p.nmom) * p.G;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < slots + p.G; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (j < slots)
      p.acc[j] = static_cast<unsigned long long>(identity(p.mom[j / p.G].op));
    else
      p.rows[j - slots] = 0u;
  }
}

__global__ void rows_global(Params p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += gridDim.x * blockDim.x) {
    int g;
    if (live(p, i, &g)) add_row(p, i, g, p.acc, p.rows);
  }
}

__global__ void rows_shared(Params p) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* acc = smem;                         // [nmom][G]
  unsigned* rows = reinterpret_cast<unsigned*>(acc + p.nmom * p.G);
  const int slots = p.nmom * p.G;
  for (int j = threadIdx.x; j < slots + p.G; j += blockDim.x) {
    if (j < slots)
      acc[j] = static_cast<unsigned long long>(identity(p.mom[j / p.G].op));
    else
      rows[j - slots] = 0u;
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += gridDim.x * blockDim.x) {
    int g;
    if (live(p, i, &g)) add_row(p, i, g, acc, rows);
  }
  __syncthreads();
  // merge the groups this block touched (a group with no row of the
  // block holds only identities)
  for (int g = threadIdx.x; g < p.G; g += blockDim.x) {
    const unsigned r = rows[g];
    if (r == 0u) continue;
    atomicAdd(p.rows + g, r);
    for (int m = 0; m < p.nmom; ++m) {
      const unsigned long long v = acc[m * p.G + g];
      unsigned long long* dst = p.acc + static_cast<long long>(m) * p.G + g;
      const int op = p.mom[m].op;
      if (op == kCount || (op == kSum && p.mom[m].is_int)) {
        if (v != 0ull) atomicAdd(dst, v);
      } else if (op == kSum || op == kSumSq) {
        atomicAdd(reinterpret_cast<double*>(dst), __longlong_as_double(
            static_cast<long long>(v)));
      } else if (op == kMax) {
        atomicMax(reinterpret_cast<long long*>(dst),
                  static_cast<long long>(v));
      } else {
        atomicMin(reinterpret_cast<long long*>(dst),
                  static_cast<long long>(v));
      }
    }
  }
}

__device__ __forceinline__ float key_to_float(long long key) {
  int k = static_cast<int>(key);
  return __int_as_float(k >= 0 ? k : (k ^ 0x7fffffff));
}

__global__ void finalize(Params p) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.G) return;
  if (p.counts != nullptr) p.counts[g] = static_cast<int>(p.rows[g]);
  for (int m = 0; m < p.nmom; ++m) {
    const Moment& mo = p.mom[m];
    const unsigned long long v = p.acc[static_cast<long long>(m) * p.G + g];
    const long long k = static_cast<long long>(v);
    switch (mo.op) {
      case kCount:
        static_cast<int*>(mo.out)[g] = static_cast<int>(v);
        break;
      case kSum:
        if (mo.is_int) {
          static_cast<int*>(mo.out)[g] = static_cast<int>(
              static_cast<unsigned>(v));
          break;
        }
        [[fallthrough]];  // a float sum is a double slot
      case kSumSq:
        static_cast<float*>(mo.out)[g] = static_cast<float>(
            __longlong_as_double(k));
        break;
      case kMin:
      case kMax:
        if (mo.is_int) {
          static_cast<int*>(mo.out)[g] =
              k == LLONG_MAX ? INT_MAX
                             : (k == LLONG_MIN ? INT_MIN
                                               : static_cast<int>(k));
        } else {
          static_cast<float*>(mo.out)[g] =
              k == LLONG_MAX ? __int_as_float(0x7f800000)
              : k == LLONG_MIN ? __int_as_float(0xff800000)
              : (k == kNanMin || k == kNanMax) ? __int_as_float(0x7fc00000)
              : key_to_float(k);
        }
        break;
      case kFirstKey:
      case kLastKey:
        static_cast<long long*>(mo.out)[g] = k;
        break;
      default: {  // first / last: the value at the winning row
        int bits = mo.is_int ? 0 : 0x7fc00000;
        if (k != LLONG_MAX) {
          const long long row = (k & 0xffffffffll) - p.row_base;
          bits = static_cast<const int*>(mo.val)[row];
        }
        static_cast<int*>(mo.out)[g] = bits;
      }
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

long long smem_bytes(int G, int nmom) {
  return static_cast<long long>(G) * (8LL * nmom + 4);
}

}  // namespace

extern "C" {

int grouped_moments_max_moments() { return kMaxMoments; }

// The largest group count whose state a block keeps in shared memory
// for nmom moments (above it the rows go to global atomics).
int grouped_moments_smem_groups(int nmom) {
  return static_cast<int>(kSmemBudget / (8LL * nmom + 4));
}

// Bytes of scratch a launch over G groups with nmom moments needs.
long long grouped_moments_scratch_bytes(int G, int nmom) {
  return static_cast<long long>(G) * nmom * 8 +
         static_cast<long long>(G) * 4;
}

// Launches init, the row pass and finalize on `stream` (a cudaStream_t
// passed as a pointer) of the calling thread's current device. Device
// pointers: gids int32 [n], row_mask bool [n], ts int32 [n] (read by
// first/last only), counts int32 [G] or null, each vals[m] float32 or
// int32 [n] (is_int says which), each cmasks[m] bool [n] or null, each
// outs[m] [G] of the moment's output type (int64 for the keys), scratch
// of grouped_moments_scratch_bytes, 8-byte aligned. The pointer arrays
// and ops / is_int live on the host. Returns the CUDA error code (0 on
// success).
int grouped_moments_launch(const int* gids, int n, int G,
                           const unsigned char* row_mask, const int* ts,
                           long long row_base, int* counts, int nmom,
                           const void* const* vals,
                           const unsigned char* const* cmasks,
                           void* const* outs, const int* ops,
                           const int* is_int, void* scratch, void* stream) {
  if (n < 0 || G < 0 || nmom < 0 || nmom > kMaxMoments || row_base < 0 ||
      row_base + n > 0xffffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  Params p{};
  p.gids = gids;
  p.rmask = row_mask;
  p.ts = ts;
  p.counts = counts;
  p.acc = static_cast<unsigned long long*>(scratch);
  p.rows = reinterpret_cast<unsigned*>(p.acc + static_cast<long long>(nmom) *
                                       G);
  p.row_base = row_base;
  p.n = n;
  p.G = G;
  p.nmom = nmom;
  for (int m = 0; m < nmom; ++m) {
    if (ops[m] < kCount || ops[m] > kLastKey)
      return static_cast<int>(cudaErrorInvalidValue);
    p.mom[m] = Moment{vals[m], cmasks[m], outs[m], ops[m], is_int[m]};
    if (ops[m] >= kFirst) p.need_ts = 1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms();
  const long long total = static_cast<long long>(nmom) * G + G;
  const int init_blocks = static_cast<int>(
      (total + kThreads - 1) / kThreads < sms * 4
          ? (total + kThreads - 1) / kThreads : sms * 4);
  init_state<<<init_blocks, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long want = (static_cast<long long>(n) + kThreads - 1) /
                           kThreads;
    const long long smem = smem_bytes(G, nmom);
    if (smem <= kSmemBudget) {
      // set on every launch: a launch must not depend on what an earlier
      // one set on this device
      err = cudaFuncSetAttribute(rows_shared,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rows_shared, kThreads, static_cast<size_t>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long cap = static_cast<long long>(sms) *
                            (per_sm > 0 ? per_sm : 1);
      rows_shared<<<static_cast<int>(want < cap ? want : cap), kThreads,
                    static_cast<size_t>(smem), st>>>(p);
    } else {
      const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
      rows_global<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                    st>>>(p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finalize<<<(G + kThreads - 1) / kThreads, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
