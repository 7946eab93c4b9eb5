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
// bound masks the ragged edge.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash_buckets_kernel(const uint2* const* __restrict__ cols,
                                    int n_cols, long long n,
                                    uint32_t num_buckets,
                                    uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = 0x3C074A61u;
    for (int c = 0; c < n_cols; ++c) {
      const uint2 w = __ldg(cols[c] + i);  // w.x = hi, w.y = lo
      h = fmix32(h * 31u ^ fmix32(w.x));
      h = fmix32(h * 31u ^ fmix32(w.y));
    }
    if (num_buckets != 0u) h %= num_buckets;
    out[i] = h;
  }
}

}  // namespace

extern "C" {

// `cols`: device array of `n_cols` pointers, each to an (n, 2) uint32
// column (8-byte aligned).  `out`: (n,) 32-bit.  Launches on `stream`
// and returns the launch's cudaError_t (0 = launched).
int hs_hash_buckets(const void* cols, int n_cols, long long n,
                    unsigned int num_buckets, void* out, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  if (blocks < 1) blocks = 1;
  hash_buckets_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint2* const*)cols, n_cols, n, num_buckets, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
