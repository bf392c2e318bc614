// JTH-256 row chain on Hopper (sm_90a), hand-written CUDA C++, with two
// epilogues: the lane states, or the lane fold.
//
// Replaces the Pallas kernel juicefs_tpu/tpu/hash_jax.py _pallas_row_chain
// (pl.pallas_call at hash_jax.py:228) and, under the second entry, the
// per-lane half of the fold that the TPU program runs after it in the same
// compiled program (_lane_accs, hash_jax.py:88):
//   jth256_row_chain:   words (L, 128, 128) uint32 -> (L, 128) lane states
//   jth256_lane_digests: words (L, 128, 128) uint32 -> (L, 8) lane digests
// L = B*M lanes of 64 KiB. Lane l runs with the lane index lane_offset +
// l mod m (uint32 arithmetic), as _lane_states(words, lane_offset) and
// _lane_accs(s, lane_offset) do: a device that holds lanes [lane_offset,
// lane_offset + m) of each block passes its offset so that its lanes hash
// with their global indices. `tweak` is xor'ed into every word as it is
// read, so a timing loop can vary it without an extra copy of the batch.
// The per-block combine is jth256_combine.cu.
//
// What bounds it: every input word is read once and takes ~9 integer
// operations, so both entries are bound by device-memory bytes: the input
// plus 512 B of states a lane, or plus 32 B of digests a lane, at the
// card's memory rate (1 GiB of words per 16384 lanes).
//
// What held the first design back: one CTA per lane, each thread loading
// its column 8 rows ahead with __ldg, kept 4 KiB a CTA in flight. A
// one-block batch (64 lanes, 64 CTAs on 132 SMs) then moves its 4 MiB in
// many round trips, and the 512 B of states a lane were read back by some
// 130 small torch launches of the fold.
//
// Design: still one CTA of 128 threads per lane, one thread per column
// (the chain is sequential in the rows, parallel in the columns). The
// lane streams through shared memory in chunks of 16 rows (8 KiB): one
// thread issues TMA's 1-D bulk copies (cp.async.bulk global -> shared)
// into a ring of kStages chunks, each completing on its own mbarrier, and
// refills a slot once every thread has consumed it. A warp reads a row of
// a chunk as 32 consecutive words, so the reads are free of bank
// conflicts. The ring is 4 stages (32 KiB): half the lane is in flight at
// once (2 MiB of a one-block batch) and 6 CTAs stay resident per SM on a
// large batch, about 192 KiB in flight per SM against 64 KiB for the
// first design. Builds with 2 stages (16 KiB, 13 CTAs) and 8 (the whole
// lane, 3 CTAs), timed beside this one on an H100 80GB HBM3 (PERF.md
// section 6), came within 7% of it at 1, 27, 32 and 256 blocks; 4 was
// the fastest at 1, 32 and 256 blocks and at most 4% from the fastest
// elsewhere, where 8 ran 11% slower at 8 blocks. 4 keeps twice as many
// CTAs resident as 8 for the same bytes in flight. A build with
// -DJTH256_STAGES=n (1-8) sets another ring for such a sweep
// (chip_smoke.py --compare-row-chain . --compare-define JTH256_STAGES=n).
//
// The digests epilogue writes the 128 column states to shared memory;
// after one __syncthreads, 8 threads each run the 16 fold steps of their
// k (column gi*8 + k) and write the lane's 8 digest words: 32 B a lane
// leave the kernel instead of 512.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jth256_step.cuh"

namespace {

constexpr int kStageRows = 16;
constexpr int kStageBytes = kStageRows * jth256::kCols * 4;  // 8 KiB
constexpr int kChunks = jth256::kRows / kStageRows;          // 8 a lane
constexpr long long kLaneBytes = jth256::kRows * jth256::kCols * 4;
#ifndef JTH256_STAGES
#define JTH256_STAGES 4
#endif
constexpr int kStages = JTH256_STAGES;
static_assert(kStages >= 1 && kStages <= kChunks, "ring of 1-8 chunks");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also sets the bytes the barrier's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kDigests>
__global__ void __launch_bounds__(jth256::kCols)
row_chain_kernel(const uint32_t* __restrict__ words,
                 uint32_t* __restrict__ out, uint32_t m,
                 uint32_t lane_offset, uint32_t tweak) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ uint32_t states[jth256::kCols];
  const long long lane = blockIdx.x;
  const uint32_t col = threadIdx.x;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(words) + lane * kLaneBytes;

  if (col == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (col == 0) {
    for (int c = 0; c < kStages; ++c) {
      mbar_expect_tx(&full[c], kStageBytes);
      bulk_load(ring + c * kStageBytes, src + c * kStageBytes, kStageBytes, &full[c]);
    }
  }

  const uint32_t lane_idx = lane_offset + static_cast<uint32_t>(lane % m);
  uint32_t s = jth256::init_state(col, lane_idx);
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    const int slot = c % kStages;
    mbar_wait(&full[slot], static_cast<uint32_t>(c / kStages) & 1u);
    const uint32_t* tile =
        reinterpret_cast<const uint32_t*>(ring + slot * kStageBytes) + col;
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      s = jth256::row_step(s, tile[r * jth256::kCols] ^ tweak);
    }
    if (c + kStages < kChunks) {
      __syncthreads();  // every thread is done with the slot: refill it
      if (col == 0) {
        mbar_expect_tx(&full[slot], kStageBytes);
        bulk_load(ring + slot * kStageBytes, src + (c + kStages) * kStageBytes,
                  kStageBytes, &full[slot]);
      }
    }
  }

  if constexpr (kDigests) {
    states[col] = s;
    __syncthreads();
    if (col < jth256::kDigestWords) {
      uint32_t acc = jth256::fold_seed(lane_idx, col);
#pragma unroll
      for (uint32_t gi = 0; gi < jth256::kGroups; ++gi) {
        acc = jth256::fold_step(acc, states[gi * jth256::kDigestWords + col], gi);
      }
      out[lane * jth256::kDigestWords + col] = acc;
    }
  } else {
    out[lane * jth256::kCols + col] = s;
  }
}

template <bool kDigests>
int launch(const void* words, void* out, long long n_lanes, unsigned int m,
           unsigned int lane_offset, unsigned int tweak, void* stream) {
  if (n_lanes <= 0 || n_lanes > 0x7FFFFFFFLL || m == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  }
  auto kernel = row_chain_kernel<kDigests>;
  constexpr int smem = kStages * kStageBytes;
  if (smem > 48 * 1024) {
    // above 48 KiB a CTA's dynamic shared memory must be allowed per
    // function on the current device; setting it on each such launch
    // keeps that true on whichever card the caller's stream belongs to
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(n_lanes), jth256::kCols, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), m,
      lane_offset, tweak);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` (a cudaStream_t passed as a pointer) and
// return the cudaError_t of the launch (0 on success); the wrapper raises
// on any other value. They do not synchronise.

// (L, 128) uint32 lane states.
extern "C" int jth256_row_chain(const void* words, void* out,
                                long long n_lanes, unsigned int m,
                                unsigned int lane_offset, unsigned int tweak,
                                void* stream) {
  return launch<false>(words, out, n_lanes, m, lane_offset, tweak, stream);
}

// (L, 8) uint32 per-lane digests (the lane fold of the states).
extern "C" int jth256_lane_digests(const void* words, void* out,
                                   long long n_lanes, unsigned int m,
                                   unsigned int lane_offset,
                                   unsigned int tweak, void* stream) {
  return launch<true>(words, out, n_lanes, m, lane_offset, tweak, stream);
}
