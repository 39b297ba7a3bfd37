// PromQL window-bounds counting on Hopper (sm_90a).
//
// Replaces the TPU kernel greptimedb_tpu/ops/pallas_window.py:
// counts_leq_pallas (Pallas `_kernel`), which computes
//
//     out[s, k] = #{ l : b[s, l] <= k }      for 0 <= k < nsteps
//
// over int32 step buckets b[S, L] (ops/window.py:_counts_leq_grid makes
// them). Buckets equal to nsteps (the padding) or above fall in no step;
// buckets below 0 count at every step. Row order does not matter.
//
// The TPU kernel is a dense compare-reduce, O(S*L*T). Here each block
// owns one series row: it builds a histogram of the row's buckets in
// shared memory (one shared atomic per sample), then a block-wide
// inclusive scan of the bins gives the counts, written out coalesced.
// That is O(S*(L+T)) and holds for rows in any order.
//
// Bound: bytes. The function must read b once and write out once,
// S*L*4 + S*T*4 bytes; it does one compare-add per sample and one add
// per step, far below the card's integer rate. At the PromQL main-path
// shape (4000 series x 16384 samples, T = 2053) that is ~295 MB, about
// 88 us at 3.35 TB/s.
//
// Bins live in dynamic shared memory, up to kMaxTileBins per pass (above
// 48 KB only after the opt-in attribute). A wider step grid is cut into
// tiles of kMaxTileBins steps: each tile rereads the row (from L2) and
// carries the count of samples below the tile.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 56 Ki bins = 224 KiB of the 227 KiB a block may use on Hopper.
constexpr int kMaxTileBins = 56 * 1024;
constexpr int kMaxDevices = 64;

// Per device: whether the kernel is opted in to kMaxTileBins of
// dynamic shared memory (above the default 48 KB).
std::atomic<bool> g_smem_opt_in[kMaxDevices];

// Inclusive scan of x across the block; *total receives the block sum.
// Every thread of the block must call it (it synchronises).
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int offset = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return x + offset;
}

__global__ void __launch_bounds__(kThreads)
counts_leq_kernel(const int* __restrict__ b, int* __restrict__ out, int L,
                  int nsteps, int tile) {
  extern __shared__ int bins[];
  __shared__ int warp_sums[kWarps];

  const long long row = blockIdx.x;
  const int* brow = b + row * L;
  int* orow = out + row * nsteps;

  for (int k0 = 0; k0 < nsteps; k0 += tile) {
    const int tlen = min(tile, nsteps - k0);
    for (int i = threadIdx.x; i < tlen; i += kThreads) bins[i] = 0;
    __syncthreads();

    int below = 0;  // samples of this thread before the tile
    for (int l = threadIdx.x; l < L; l += kThreads) {
      const int rel = max(__ldg(brow + l), 0) - k0;
      if (rel < 0) {
        ++below;
      } else if (rel < tlen) {
        atomicAdd(&bins[rel], 1);
      }
    }
    __syncthreads();
    int carry;
    block_inclusive_scan(below, warp_sums, &carry);

    // scan the bins kThreads at a time; each pass writes one coalesced
    // stretch of the output row
    for (int base = 0; base < tlen; base += kThreads) {
      const int i = base + threadIdx.x;
      const int x = i < tlen ? bins[i] : 0;
      int chunk;
      const int incl = block_inclusive_scan(x, warp_sums, &chunk);
      if (i < tlen) orow[k0 + i] = carry + incl;
      carry += chunk;
    }
    __syncthreads();  // bins are cleared for the next tile
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t passed as a pointer) of the
// calling thread's current device, which the caller sets; b is int32
// [S, L] and out int32 [S, nsteps], both contiguous. Returns the CUDA
// error code of the launch (0 on success).
int counts_leq_launch(const int* b, int* out, int S, int L, int nsteps,
                      void* stream) {
  if (S <= 0 || nsteps <= 0) return 0;
  const int tile = nsteps < kMaxTileBins ? nsteps : kMaxTileBins;
  const int smem = tile * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    // opt in once per device, to the largest tile
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!g_smem_opt_in[device].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(counts_leq_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxTileBins * static_cast<int>(sizeof(int)));
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_opt_in[device].store(true, std::memory_order_release);
    }
  }
  counts_leq_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, out, L, nsteps, tile);
  return static_cast<int>(cudaGetLastError());
}

const char* counts_leq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
