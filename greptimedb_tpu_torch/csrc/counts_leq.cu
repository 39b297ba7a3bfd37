// PromQL window-bounds counting on Hopper (sm_90a).
//
// Replaces the TPU kernel greptimedb_tpu/ops/pallas_window.py:
// counts_leq_pallas (Pallas `_kernel`), which computes
//
//     out[s, k] = #{ l : b[s, l] <= k }      for 0 <= k < nsteps
//
// over int32 step buckets b[S, L]. Buckets equal to nsteps (the padding)
// or above fall in no step; buckets below 0 count at every step. Row
// order does not matter.
//
// One kernel template, two entry points:
// - counts_leq_launch reads the buckets b (K1's exact counterpart);
// - counts_leq_grid_launch reads int32 rebased timestamps ts (pad
//   INT32_MAX) and buckets each sample in registers as it is loaded, for
//   the step grid t0 + k*step (t0 int64, step > 0):
//       q = (int64)ts - t0
//       b = q <= 0 ? 0 : min(ceil(q / step), nsteps),  b = nsteps for pads
//   This equals the reference's clip(-floor_divide(t0 - ts, step), 0,
//   nsteps) (greptimedb_tpu/ops/window.py:_counts_leq_grid) only because
//   the division runs on q > 0: C's `/` truncates toward zero, so
//   ceil(q / step) is computed as (q - 1) / step + 1 for q >= 1. The
//   bucket matrix then never reaches device memory: the window-bounds
//   pass reads the timestamps once and writes the counts once.
//
// Bound: bytes, the same for both entries. The function must read its
// [S, L] int32 input once and write out once, S*L*4 + S*T*4 bytes, with
// one compare-add per sample and one add per step, far below the card's
// integer rate. At the PromQL main-path shape (4000 series x 16384
// samples, T = 2053) that is 295.0 MB, 0.0881 ms at 3.35 TB/s.
//
// Design (each block owns one series row, histograms its buckets in
// shared memory and scans the bins into counts; O(S*(L+T))):
// 1. Bytes in flight. Each thread issues kVecPerThread 16-byte loads
//    before it uses any (64 bytes; 16 KB per block), and four or more
//    blocks fit on an SM (<= 64 registers, 8 KB of bins at T = 2053), so
//    loads stay in flight while one block scans. A persistent grid of
//    resident blocks walking rows was no faster than one block per row,
//    and was left out. Rows of any length and alignment: a scalar head
//    up to the first 16-byte boundary, int4 loads, a scalar tail.
// 2. Few barriers per row. Each thread scans a run of consecutive bins
//    in registers (an odd run, so its shared reads are free of bank
//    conflicts), one warp-shuffle scan over the thread totals follows,
//    then coalesced stores: four barriers per row, not ~30.
// 3. Shared atomics. A thread's four samples of an int4 are neighbours
//    in the row; equal neighbouring buckets (sorted rows put ~6 samples
//    in a bin) merge in registers into one atomic, and out-of-tile
//    buckets (the pads) issue none.
//
// Any nsteps: bins live in dynamic shared memory, up to kMaxTileBins per
// pass (above 48 KB only after the opt-in attribute, set once per device
// and entry). A wider step grid is cut into tiles; each tile rereads the
// row (from L2) and counts samples below the tile in its first bin.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = 4;  // int4 loads in flight per thread
// 56 Ki bins = 224 KiB of the 227 KiB a block may use on Hopper.
constexpr int kMaxTileBins = 56 * 1024;
constexpr int kMaxDevices = 64;
constexpr long long kLimit62 = 1LL << 62;

// Where the buckets come from: read as they are, or computed from
// timestamps on the grid. kGrid divides in 32 bits by a multiply-shift
// (all quotients it takes fit: see counts_leq_grid_launch); kGridWide
// divides in 64 bits. At the main-path shape on an H100 the
// multiply-shift is about 5 % faster than a plain 32-bit `/` and 11 %
// faster than the 64-bit division (python3 -m
// greptimedb_tpu_torch.tools.k1_division).
enum class Src { kBuckets = 0, kGrid = 1, kGridWide = 2 };

struct Grid {
  long long t0;
  long long step;
  long long lim;  // (nsteps - 1) * step, saturated: q > lim -> nsteps
  unsigned mul;   // n / step == __umulhi(n, mul) >> shr for n < 2^31
  unsigned shr;
};

template <Src kSrc>
__device__ __forceinline__ int bucket(int x, int nsteps, const Grid& g) {
  if constexpr (kSrc == Src::kBuckets) {
    return x;
  } else {
    if (x == INT_MAX) return nsteps;  // the pad sentinel
    const long long q = static_cast<long long>(x) - g.t0;
    if (q <= 0) return 0;
    if (q > g.lim) return nsteps;
    // 0 < q <= lim: ceil(q / step) = (q - 1) / step + 1, q - 1 >= 0
    const long long n = q - 1;
    if constexpr (kSrc == Src::kGrid) {
      const unsigned u = static_cast<unsigned>(n);
      const unsigned d = g.step == 1 ? u : __umulhi(u, g.mul) >> g.shr;
      return static_cast<int>(d) + 1;
    } else {
      return static_cast<int>(n / g.step) + 1;
    }
  }
}

// Bin of bucket b in the tile [k0, k0 + tlen): below the tile counts at
// each of its steps (bin 0); a result >= tlen is outside the tile.
__device__ __forceinline__ int tile_bin(int b, int k0) {
  return b < k0 ? 0 : b - k0;  // b >= k0 >= 0: no overflow
}

// One shared atomic per run of equal neighbouring bins.
__device__ __forceinline__ void add_runs(int* bins, int tlen, int r0, int r1,
                                         int r2, int r3) {
  int n = 1;
  if (r0 != r1) {
    if (r0 < tlen) atomicAdd(&bins[r0], n);
    n = 1;
  } else {
    ++n;
  }
  if (r1 != r2) {
    if (r1 < tlen) atomicAdd(&bins[r1], n);
    n = 1;
  } else {
    ++n;
  }
  if (r2 != r3) {
    if (r2 < tlen) atomicAdd(&bins[r2], n);
    n = 1;
  } else {
    ++n;
  }
  if (r3 < tlen) atomicAdd(&bins[r3], n);
}

template <Src kSrc>
__global__ void __launch_bounds__(kThreads, 4)
counts_leq_kernel(const int* __restrict__ src, int* __restrict__ out, int L,
                  int nsteps, int tile, int run, Grid g) {
  extern __shared__ int bins[];
  __shared__ int warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < tile; i += kThreads) bins[i] = 0;
  __syncthreads();

  const long long row = blockIdx.x;
  const int* srow = src + row * L;
  int* orow = out + row * nsteps;
  // elements before the row's first 16-byte boundary (int32 data is
  // 4-byte aligned, so 0..3 of them)
  const int head = min(
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(srow) & 15)) & 15) /
          4,
      L);
  const int nvec = (L - head) / 4;
  const int4* vrow = reinterpret_cast<const int4*>(srow + head);
  const int tail = head + nvec * 4;

  for (int k0 = 0; k0 < nsteps; k0 += tile) {
    const int tlen = min(tile, nsteps - k0);

    // ---- histogram of the row's buckets in this tile ----
    if (tid < head) {
      const int r = tile_bin(bucket<kSrc>(__ldg(srow + tid), nsteps, g), k0);
      if (r < tlen) atomicAdd(&bins[r], 1);
    }
    if (tail + tid < L) {
      const int r = tile_bin(
          bucket<kSrc>(__ldg(srow + tail + tid), nsteps, g), k0);
      if (r < tlen) atomicAdd(&bins[r], 1);
    }
    for (int base = 0; base < nvec; base += kThreads * kVecPerThread) {
      int4 v[kVecPerThread];
#pragma unroll
      for (int u = 0; u < kVecPerThread; ++u) {
        const int i = base + u * kThreads + tid;
        // INT_MAX is outside every tile as a bucket and a pad as a
        // timestamp: a slot past the row adds nothing
        v[u] = i < nvec ? __ldg(vrow + i)
                        : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      }
#pragma unroll
      for (int u = 0; u < kVecPerThread; ++u) {
        add_runs(bins, tlen,
                 tile_bin(bucket<kSrc>(v[u].x, nsteps, g), k0),
                 tile_bin(bucket<kSrc>(v[u].y, nsteps, g), k0),
                 tile_bin(bucket<kSrc>(v[u].z, nsteps, g), k0),
                 tile_bin(bucket<kSrc>(v[u].w, nsteps, g), k0));
      }
    }
    __syncthreads();

    // ---- scan: thread tid owns bins [tid*run, tid*run + run) ----
    const int b0 = min(tid * run, tlen);
    const int b1 = min(b0 + run, tlen);
    int total = 0;
    for (int i = b0; i < b1; ++i) total += bins[i];
    int x = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int carry = x - total;
    for (int w = 0; w < warp; ++w) carry += warp_sums[w];
    for (int i = b0; i < b1; ++i) {
      carry += bins[i];
      bins[i] = carry;
    }
    __syncthreads();

    // ---- coalesced stores; the bins are cleared for the next pass ----
    for (int i = tid; i < tlen; i += kThreads) {
      orow[k0 + i] = bins[i];
      bins[i] = 0;
    }
    __syncthreads();
  }
}

// Per entry and device: whether the kernel is opted in to kMaxTileBins
// of dynamic shared memory (above the default 48 KB).
std::atomic<bool> g_smem_opt_in[3][kMaxDevices];

template <Src kSrc>
int launch(const int* src, int* out, int S, int L, int nsteps,
           const Grid& g, void* stream) {
  if (S <= 0 || nsteps <= 0) return 0;
  const int tile = nsteps < kMaxTileBins ? nsteps : kMaxTileBins;
  const int smem = tile * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    std::atomic<bool>& opted = g_smem_opt_in[static_cast<int>(kSrc)][device];
    if (!opted.load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(counts_leq_kernel<kSrc>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxTileBins * static_cast<int>(sizeof(int)));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted.store(true, std::memory_order_release);
    }
  }
  // an odd run of bins per thread covering the tile
  const int run = ((tile + kThreads - 1) / kThreads) | 1;
  counts_leq_kernel<kSrc><<<S, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      src, out, L, nsteps, tile, run, g);
  return static_cast<int>(cudaGetLastError());
}

int ceil_log2(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t passed as a pointer) of the
// calling thread's current device, which the caller sets; the input is
// int32 [S, L] and out int32 [S, nsteps], both contiguous, the input at
// any 4-byte alignment. They return the CUDA error code of the launch
// (0 on success).
int counts_leq_launch(const int* b, int* out, int S, int L, int nsteps,
                      void* stream) {
  return launch<Src::kBuckets>(b, out, S, L, nsteps, Grid{}, stream);
}

// ts: int32 rebased timestamps, INT32_MAX the pad; the grid is
// t0 + k*step with |t0| <= 2^62 and 0 < step <= 2^62.
int counts_leq_grid_launch(const int* ts, int* out, int S, int L, int nsteps,
                           long long t0, long long step, void* stream) {
  if (step <= 0 || step > kLimit62 || t0 > kLimit62 || t0 < -kLimit62)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g{};
  g.t0 = t0;
  g.step = step;
  const long long k = nsteps > 1 ? nsteps - 1 : 0;
  g.lim = (k > 0 && step > LLONG_MAX / k) ? LLONG_MAX : k * step;
  // The largest q a sample can give is qmax (ts <= INT32_MAX - 1), and
  // the kernel divides n = q - 1 only for 0 < q <= lim. When every such
  // n is below 2^31 and step is too, a 32-bit multiply-shift divides
  // exactly (Granlund-Montgomery: mul = ceil(2^(31 + l) / step),
  // l = ceil(log2 step), error below 1 / step for n < 2^31).
  const long long qmax = static_cast<long long>(INT_MAX) - 1 - t0;
  const long long top = g.lim < qmax ? g.lim : qmax;
  if (step < (1LL << 31) && top <= (1LL << 31)) {
    if (step > 1) {
      const int l = ceil_log2(step);
      g.mul = static_cast<unsigned>(((1ULL << (31 + l)) + step - 1) /
                                    static_cast<unsigned long long>(step));
      g.shr = static_cast<unsigned>(l - 1);
    }
    return launch<Src::kGrid>(ts, out, S, L, nsteps, g, stream);
  }
  return launch<Src::kGridWide>(ts, out, S, L, nsteps, g, stream);
}

const char* counts_leq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
