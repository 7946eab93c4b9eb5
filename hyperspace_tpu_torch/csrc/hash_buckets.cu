// Fused murmur3 row hash / bucket id for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperspace_tpu/ops/pallas_kernels.py
// `hash_buckets` (`_hash_kernel`): h = 0x3C074A61; for each key column
// and each of its words w in (hi, lo): h = fmix32(h * 31 ^ fmix32(w));
// then h % num_buckets when num_buckets > 0.
//
// Bound: memory.  Each row reads 8 bytes per key column and writes 4
// bytes; the mix is ~12 integer operations per word, far below the
// card's integer rate.  Design: one thread per row in a grid-stride
// loop; each key column's (hi, lo) pair is one 8-byte `uint2` load from
// the caller's (n, 2) uint32 layout, so neighbouring threads read
// neighbouring 8-byte words (fully coalesced) and all k columns are read
// in one pass with nothing materialised between the mix steps.  The
// TPU's (256, 128) tiles and padding have no counterpart: the loop
// bound masks the ragged edge.  At 6,000,000 rows and one key column this
// body runs at 70% of the bytes bound on an H100 (PERF.md), over
// half of it, so it was kept as it is when the histogram was redesigned.
//
// The column pointers travel by value, in a `__grid_constant__` struct
// of up to kMaxCols entries: a launch needs no device pointer table, so
// the caller allocates, copies and synchronises nothing.  More columns
// are hashed in chunks of kMaxCols: each later launch reads its running
// h from `out` (`carry`), and only the last one applies the modulo.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): 22 registers, no shared memory,
// no spills (26 registers with the device pointer table it replaced).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 32;

struct Cols {
  const uint2* p[kMaxCols];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash_buckets_kernel(const __grid_constant__ Cols cols,
                                    int n_cols, long long n,
                                    uint32_t num_buckets, int carry,
                                    uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = carry ? out[i] : 0x3C074A61u;
    for (int c = 0; c < n_cols; ++c) {
      const uint2 w = __ldg(cols.p[c] + i);  // w.x = hi, w.y = lo
      h = fmix32(h * 31u ^ fmix32(w.x));
      h = fmix32(h * 31u ^ fmix32(w.y));
    }
    if (num_buckets != 0u) h %= num_buckets;
    out[i] = h;
  }
}

}  // namespace

extern "C" {

// `cols`: a host array of `n_cols` (1..kMaxCols, the wrapper's
// HASH_MAX_COLS) device pointers, each to
// an (n, 2) uint32 column, 8-byte aligned.  `out`: (n,) 32-bit; with
// `carry` it holds the running h of the columns before these and is read
// before it is written.  `num_buckets` 0 keeps the full hash (every chunk
// but the last).  Launches on `stream` and returns the launch's
// cudaError_t (0 = launched).
int hs_hash_buckets(const void* const* cols, int n_cols, long long n,
                    unsigned int num_buckets, int carry, void* out,
                    void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) return (int)cudaErrorInvalidValue;
  Cols c = {};
  for (int i = 0; i < n_cols; ++i) c.p[i] = static_cast<const uint2*>(cols[i]);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  if (blocks < 1) blocks = 1;
  hash_buckets_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      c, n_cols, n, num_buckets, carry, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
