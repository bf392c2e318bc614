// JTH-256 row chain on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas kernel juicefs_tpu/tpu/hash_jax.py _pallas_row_chain
// (pl.pallas_call at hash_jax.py:228): words (L, 128, 128) uint32, L = B*M
// lanes of 64 KiB, -> (L, 128) uint32 lane states. Lane l runs with the
// tweak lane = l mod m; `tweak` is xor'ed into every word in registers so
// a timing loop can vary it without an extra copy of the batch.
//
// What bounds it: every input word is read exactly once and takes ~9
// integer operations, so the kernel is bound by device-memory bytes
// (1 GiB of words per 16384 lanes), not by arithmetic.
//
// Design: one CTA of 128 threads per lane, one thread per column. Each
// thread keeps its column state in a register and walks the 128 rows;
// a warp's load of one row is 32 consecutive words (128 bytes), the CTA's
// is the whole 512-byte row, so every load is coalesced. Loads are issued
// 8 rows ahead of the arithmetic that consumes them, which keeps 8 loads
// in flight per thread (64 KiB per SM at full occupancy), enough to cover
// the memory latency. No shared memory, no padding: the TPU kernel padded
// L to a multiple of 16 lanes for its tiling, which changes no output.
// The lane fold (_lane_accs/_combine_accs) stays in torch ops for now.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jth256_step.cuh"

namespace {

constexpr int kUnroll = 8;

__global__ void __launch_bounds__(jth256::kCols)
row_chain_kernel(const uint32_t* __restrict__ words,
                 uint32_t* __restrict__ out, uint32_t m, uint32_t tweak) {
  const long long lane = blockIdx.x;
  const uint32_t col = threadIdx.x;
  const uint32_t* w = words + lane * (jth256::kRows * jth256::kCols) + col;
  uint32_t s = jth256::init_state(col, static_cast<uint32_t>(lane % m));
#pragma unroll 1
  for (int r = 0; r < jth256::kRows; r += kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(w + (r + u) * jth256::kCols);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s = jth256::row_step(s, v[u] ^ tweak);
    }
  }
  out[lane * jth256::kCols + col] = s;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaError_t of the launch (0 on success); the wrapper raises on any
// other value. It does not synchronise.
extern "C" int jth256_row_chain(const void* words, void* out,
                                long long n_lanes, unsigned int m,
                                unsigned int tweak, void* stream) {
  if (n_lanes <= 0 || n_lanes > 0x7FFFFFFFLL || m == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_chain_kernel<<<static_cast<unsigned int>(n_lanes), jth256::kCols, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), m,
      tweak);
  return static_cast<int>(cudaGetLastError());
}
