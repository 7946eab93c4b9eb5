// Rows-per-bucket histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperspace_tpu/ops/pallas_kernels.py
// `bucket_histogram` (`_hist_kernel`): int32 counts per bucket over
// [0, num_buckets); ids outside that range (the -1 padding) count
// nowhere, and n = 0 gives zeros.
//
// Bound: memory, 4 bytes read per row; the counts themselves are a few
// bytes.  The TPU kernel builds a one-hot block per tile and carries the
// sum across its sequential grid; blocks here run in parallel and in no
// order.  The design:
//   - One block of kThreads per SM, a full wave.  Each thread reads four
//     ids per 16-byte `int4` load with the streaming hint (`__ldcs`: the
//     ids are read once) and issues kUnroll such loads before it counts
//     any, so 64 bytes per thread are in flight.  A view that does not
//     start on a 16-byte boundary has its first ids (at most three) and
//     its last ones counted one by one.
//   - Up to kWarpCopyMax buckets, each of the block's kWarps warps counts
//     into its own copy of the histogram in shared memory with plain
//     shared atomicAdd, so lanes contend only within their warp, and the
//     block sums its copies at the end.  Wider ranges get one histogram
//     per block, in up to kMaxTile buckets of opt-in dynamic shared
//     memory; a range wider than that tiles over gridDim.y, and each tile
//     reads the ids again.
//   - One launch and no zero-fill.  Each block adds its non-zero counts
//     into an accumulator with global atomics, then takes a ticket with
//     an atomic add after a __threadfence().  The block that takes the
//     last ticket moves the accumulator into `out` with atomicExch(.., 0),
//     which also zeroes it, and puts the ticket back to 0: every launch
//     leaves the accumulator and the ticket as it found them, all zero.
//     Both live in one buffer that the caller zeroes once and keeps per
//     device and stream.  The counts are integers, so the result is exact
//     and the same on every run whatever order the atomics land in.  This
//     tail was chosen over the last block summing one scratch row per
//     block (a second kernel would do the same work after a launch gap):
//     on the card the rows cost more, and more with more buckets
//     (PERF.md §6).
// Launches that share an accumulator must not overlap: the caller keeps
// one per stream, and a stream orders its launches.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): 32 registers in both variants,
// no spills, 16 bytes of static shared memory beside the dynamic
// histograms (kWarps x num_buckets x 4 B per-warp, at most 128 KB; one
// tile x 4 B, at most 224 KB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// Per-warp copies while kWarps x num_buckets x 4 B <= 128 KB.
constexpr int kWarpCopyMax = 1024;
// One block histogram of at most 224 KB of dynamic shared memory.
constexpr int kMaxTile = 56 * 1024;
constexpr int kMaxDynamicSmem = kMaxTile * 4;

// `acc`: [ticket, counts[num_buckets]], all zero on entry and on exit.
template <bool kPerWarp>
__global__ void __launch_bounds__(kThreads)
bucket_histogram_kernel(const int* __restrict__ ids, long long n, int head,
                        int num_buckets, int tile, unsigned* acc,
                        int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ bool is_last;
  const unsigned lo = blockIdx.y * tile;
  const int width = min(tile, num_buckets - (int)lo);
  const int copies = kPerWarp ? kWarps : 1;
  for (int j = threadIdx.x; j < copies * width; j += kThreads) smem[j] = 0;
  __syncthreads();

  int* hist = kPerWarp ? smem + (threadIdx.x >> 5) * width : smem;
  auto count = [&](int id) {
    const unsigned b = (unsigned)id - lo;
    if (b < (unsigned)width) atomicAdd(hist + b, 1);
  };
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = (n - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(ids + head);
  for (long long base = t; base < nvec; base += kUnroll * stride) {
    int4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + u * stride;
      a[u] = p < nvec ? __ldcs(vec + p) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count(a[u].x);
      count(a[u].y);
      count(a[u].z);
      count(a[u].w);
    }
  }
  const long long tail = head + 4 * nvec;
  if (t < head) count(__ldcs(ids + t));
  if (t < n - tail) count(__ldcs(ids + tail + t));
  __syncthreads();

  unsigned* ticket = acc;
  int* counts = reinterpret_cast<int*>(acc + 1);
  for (int j = threadIdx.x; j < width; j += kThreads) {
    int c = 0;
    for (int w = 0; w < copies; ++w) c += smem[w * width + j];
    if (c != 0) atomicAdd(counts + lo + j, c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block: every other block's adds are done.
  __threadfence();
  for (int j = threadIdx.x; j < num_buckets; j += kThreads)
    out[j] = atomicExch(counts + j, 0);
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];  // SMs of each device; 0 until first queried

}  // namespace

extern "C" {

// `ids`: (n,) int32 on the device (4-byte aligned; n may be 0).  `acc`:
// 1 + num_buckets 32-bit words, zero before the first launch and left
// zero by every launch.  `out`: (num_buckets,) int32, written whole.
// Launches on `stream` and returns the launch's cudaError_t (0 =
// launched).
int hs_bucket_histogram(const void* ids, long long n, int num_buckets,
                        void* acc, void* out, void* stream) {
  if (num_buckets < 1 || n < 0 || reinterpret_cast<uintptr_t>(ids) % 4)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // Opt in once to the widest histogram; a launch that asks for less
    // shared memory is not held to it.
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bucket_histogram_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxDynamicSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bucket_histogram_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    g_sms[device] = sms;
  }

  const bool per_warp = num_buckets <= kWarpCopyMax;
  const int tiles = per_warp ? 1 : (num_buckets + kMaxTile - 1) / kMaxTile;
  const int tile = (num_buckets + tiles - 1) / tiles;
  const size_t smem = (size_t)(per_warp ? kWarps : 1) * tile * sizeof(int);
  long long blocks = g_sms[device] / tiles;
  const long long need = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;

  const long long misalign = reinterpret_cast<uintptr_t>(ids) % 16;
  long long head = misalign ? (16 - misalign) / 4 : 0;
  if (head > n) head = n;
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  auto kernel = per_warp ? bucket_histogram_kernel<true>
                         : bucket_histogram_kernel<false>;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), n, (int)head, num_buckets, tile,
      static_cast<unsigned*>(acc), static_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
