// Rows-per-bucket histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperspace_tpu/ops/pallas_kernels.py
// `bucket_histogram` (`_hist_kernel`): int32 counts per bucket over
// [0, num_buckets); ids outside that range (the -1 padding) count
// nowhere.
//
// Bound: memory, 4 bytes read per row.  The TPU kernel builds a one-hot
// block per tile and carries the sum across its sequential grid; blocks
// here run in parallel and in no order, so each block keeps a private
// histogram in shared memory and flushes it with one global atomicAdd
// per non-zero bucket into an output the wrapper zeroed.  The counts are
// integers, so the result is exact whatever order the atomics land in.
// With few buckets (16 on the build path) every thread of a warp hits
// the same handful of shared counters; __match_any_sync groups the lanes
// that hold the same id so each group adds its population count once,
// which keeps shared-memory atomic contention to one add per distinct id
// per warp.  A bucket range wider than one block's shared tile is split
// over gridDim.y, as the TPU grid's bucket-block axis split it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bucket_histogram_kernel(const int* __restrict__ ids,
                                        long long n, int num_buckets,
                                        int tile, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int lo = blockIdx.y * tile;
  const int width = min(tile, num_buckets - lo);
  for (int j = threadIdx.x; j < width; j += blockDim.x) hist[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // Every lane of a warp runs the same number of iterations (the bound
  // is rounded up to whole warps), so the warp-wide match below always
  // sees all 32 lanes; lanes past n carry an id that matches no bucket.
  const long long n_warp = (n + 31) & ~31LL;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_warp; i += stride) {
    int b = -1;
    if (i < n) {
      const int id = __ldg(ids + i);
      if (id >= lo && id < lo + width) b = id - lo;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[b], __popc(peers));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int c = hist[j];
    if (c != 0) atomicAdd(out + lo + j, c);
  }
}

}  // namespace

extern "C" {

// Buckets held in one block's shared tile: 8192 x 4 B = 32 KB, inside
// the 48 KB a block may use without opting in to more.
static const int kTileBuckets = 8192;

// `ids`: (n,) int32 on the device; `out`: (num_buckets,) int32, zeroed
// by the caller.  n must be > 0.  Launches on `stream` and returns the
// launch's cudaError_t (0 = launched).
int hs_bucket_histogram(const void* ids, long long n, int num_buckets,
                        void* out, void* stream) {
  const int threads = 256;  // a multiple of the warp width
  const int tile = num_buckets < kTileBuckets ? num_buckets : kTileBuckets;
  const int tiles = (num_buckets + tile - 1) / tile;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // 8 blocks per SM, then stride
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)tiles);
  bucket_histogram_kernel<<<grid, threads, tile * sizeof(int),
                            (cudaStream_t)stream>>>(
      (const int*)ids, n, num_buckets, tile, (int*)out);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
