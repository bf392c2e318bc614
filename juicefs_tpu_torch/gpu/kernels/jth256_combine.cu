// JTH-256 per-block combine on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the rest of the program that juicefs_tpu/tpu/hash_jax.py
// _hash_packed_pallas_impl (hash_jax.py:247) runs after the Pallas row
// chain: _combine_accs (hash_jax.py:103) and _fmix (:57), for a batch whose
// blocks are split over the lane shards of a mesh. Input: the per-lane
// digests (B, M, 8) uint32 that jth256_row_chain.cu's jth256_lane_digests
// writes on each lane shard, gathered in lane order on the data row's lead
// device, int64 lane_counts (B,) and lengths (B,). Output: int64 (B, 8)
// holding the uint32 digest words, the type hash_device returns. A batch
// whose blocks lie whole on one device runs the same combine in the row
// chain's own epilogue (jth256_block_digests) and never launches this one.
//
// Design: one thread per (block b, word k). It runs the combine's
// sequential chain over the block's live lanes, li < min(lane_counts[b],
// M) (a lane at or past the count leaves the state unchanged, so the
// chain stops there), then the length mix and fmix. The 8 threads of a
// block read 32 consecutive bytes per lane.
//
// What bounds it: bytes, and few of them (32 B a live lane, 16 B in and
// 64 B out a block): at the card's memory rate that is well under a
// microsecond for any batch of the main path, below one launch's latency,
// so the kernel's time is its launch and its dependent chain of at most
// 64 steps. It replaces the ~800 small torch launches of the plain fold
// with one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jth256_step.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
combine_kernel(const uint32_t* __restrict__ accs,
               const long long* __restrict__ lane_counts,
               const long long* __restrict__ lengths,
               long long* __restrict__ out, long long n_blocks, uint32_t m) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_blocks * jth256::kDigestWords) return;
  const long long b = t / jth256::kDigestWords;
  const uint32_t k = static_cast<uint32_t>(t % jth256::kDigestWords);
  const long long count = lane_counts[b];
  const uint32_t live =
      count <= 0 ? 0u : (count >= m ? m : static_cast<uint32_t>(count));
  const uint32_t* d = accs + b * m * jth256::kDigestWords;
  out[t] = static_cast<long long>(jth256::finish_word(
      d, jth256::kDigestWords, live, static_cast<uint32_t>(lengths[b]), k));
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaError_t of the launch (0 on success); the wrapper raises on any
// other value. It does not synchronise.
extern "C" int jth256_combine(const void* accs, const void* lane_counts,
                              const void* lengths, void* out,
                              long long n_blocks, unsigned int m,
                              void* stream) {
  if (n_blocks <= 0 || m == 0 ||
      n_blocks > 0x7FFFFFFFLL / jth256::kDigestWords * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = n_blocks * jth256::kDigestWords;
  const unsigned int grid = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(accs),
      static_cast<const long long*>(lane_counts),
      static_cast<const long long*>(lengths), static_cast<long long*>(out),
      n_blocks, m);
  return static_cast<int>(cudaGetLastError());
}
