// The compress plane's compressibility estimate of a batch split over a
// mesh, on Hopper (sm_90a), hand-written CUDA C++: the sampled byte
// histogram of each lane shard, and the entropy of the summed histograms.
//
// Replaces no Pallas kernel: the reference computes the estimate with an
// XLA program (juicefs_tpu/tpu/compress_batch.py), and the
// port first ran it as plain torch ops (compress_batch.py
// byte_histogram_ref and entropy_ratio_ref): a strided copy, a widening,
// the lane mask, a scatter-add and a dozen elementwise and reduction ops
// for the entropy, some 20 launches a batch. A batch on one card is
// estimated inside its hash launch (jth256_row_chain.cu,
// jth256_block_digests_estimate); this file holds the mesh's two entries.
// compress_estimate.cuh holds their arithmetic, which the CPU twin and the
// row chain share. Entries:
//   compress_histogram: words (B, M, 128, 128) -> (B, 256) float32 counts,
//                       lanes [lane_offset, lane_offset + M) of each block
//                       (a lane shard of a mesh)
//   compress_entropy:   (B, 256) float32 counts -> (B,) advisories
//                       min(entropy / 8, 1) (a data row's summed shard
//                       histograms)
// The entropy entry runs the row chain's order of the sum on the same
// integer counts, so a mesh's advisories equal one card's bit for bit.
//
// What bounds the histogram: bytes, and few of them. Each sampled word
// lies 64 B from the next, so every one costs a 32-byte sector: 4096
// sectors (128 KiB) a 4 MiB block, 1.7 MB for a 13-block batch, about
// 0.5 us at 3.35 TB/s. The kernel's time is therefore a launch and a chain
// of latencies: one round trip to device memory, the shared-memory
// binning, and the handoff to the last CTA of each block.
//
// Design: B x G CTAs of 256 threads, G = ceil(M / 4): each CTA takes 4
// lanes of one block, one sampled word a thread (a 13-block batch of 64
// lanes is 208 CTAs on 132 SMs). It bins the word's 4 bytes into a
// 256-bin shared histogram; a warp whose 32 words give one byte value
// (found with two warp reductions) adds 32 once, so a run of equal bytes
// (an all-zero block) does not serialise 32 atomics on one bin. The CTA adds
// its non-zero bins to the block's 256 int32 counters in device memory
// (L2 atomics), fences (release) and takes a ticket from the block's
// arrival counter, as the row chain's last-CTA combine does
// (jth256_row_chain.cu). The CTA that draws the last ticket fences
// (acquire), takes the block's counts with atomicExch(0), which also
// leaves the counters zero, and writes them out. It sets the arrival
// counter back to 0, so the workspace is zero for the next launch on the
// stream: the wrapper keeps one zeroed workspace per stream, and no memset
// or fill launch precedes the kernel.
//
// Designs timed beside this binning on the same H100, with the entropy in
// the same launch, at 1-32 blocks of random words: grouping equal bytes
// with __match_any_sync instead of the two warp reductions, 5.7-9.5 us
// against 4.9-6.1 us (it takes a step for each distinct value in a warp,
// so random words cost most); one 1024-thread CTA a block, which needs no
// handoff, 19.3 us with __match_any_sync and 6.0-6.5 us with the
// reductions (one SM bins all 16384 sampled bytes of a block). On all-zero
// and text words all four came within ~1 us of this one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "compress_estimate.cuh"

namespace {

constexpr int kThreads = cest::kBins;                        // one bin a thread
constexpr int kLanesPerCta = kThreads / cest::kLaneSample;   // 4
constexpr int kWork = 1 + cest::kBins;  // a block's workspace: arrivals, counts
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Sum over the CTA's 256 threads, each holding one value; the result is
// valid in thread 0. `parts` holds the 8 warp sums.
__device__ __forceinline__ uint32_t cta_sum(uint32_t v, uint32_t* parts) {
  const int lane = threadIdx.x % cest::kGroup, warp = threadIdx.x / cest::kGroup;
  for (int off = cest::kGroup / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) parts[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < cest::kGroups ? parts[lane] : 0u;
    for (int off = cest::kGroups / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// The entropy terms of the 256 bins summed in cest::reduce256's order;
// valid in thread 0. `parts` holds the 8 group sums.
__device__ __forceinline__ float cta_term_sum(float v, float* parts) {
  const int lane = threadIdx.x % cest::kGroup, warp = threadIdx.x / cest::kGroup;
  for (int off = cest::kGroup / 2; off > 0; off /= 2) {
    v = cest::add_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  if (lane == 0) parts[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < cest::kGroups ? parts[lane] : 0.0f;
    for (int off = cest::kGroups / 2; off > 0; off /= 2) {
      v = cest::add_rn(v, __shfl_xor_sync(kFull, v, off));
    }
  }
  return v;
}

// The advisory of a block whose bin threadIdx.x holds `count`; valid in
// thread 0. Every thread of the CTA calls it.
__device__ __forceinline__ float block_advisory(uint32_t count) {
  __shared__ uint32_t total_parts[cest::kGroups];
  __shared__ float term_parts[cest::kGroups];
  __shared__ uint32_t total;
  const uint32_t t = cta_sum(count, total_parts);
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  return cest::advisory(cta_term_sum(cest::entropy_term(count, total), term_parts));
}

struct Args {
  const uint32_t* words;         // (B, m, 128, 128)
  const long long* lane_counts;  // (B,)
  uint32_t* work;                // (>= B, 257): arrivals, then 256 counts; zero
  float* out;                    // (B, 256) counts
  uint32_t m;                    // lanes a block in `words`
  uint32_t groups;               // CTAs a block
  uint32_t lane_offset;          // index of the first lane within its block
};

__global__ void __launch_bounds__(kThreads) compress_histogram_kernel(Args a) {
  __shared__ uint32_t hist[cest::kBins];
  __shared__ uint32_t is_last;
  const uint32_t t = threadIdx.x;
  const long long b = blockIdx.x / a.groups;
  const uint32_t g = blockIdx.x % a.groups;
  uint32_t* work = a.work + b * kWork;
  hist[t] = 0;

  // one sampled word a thread: lane `local` of the block, word t % 64
  const uint32_t local = g * kLanesPerCta + t / cest::kLaneSample;
  const bool live = local < cest::counted_lanes(a.lane_counts[b], a.lane_offset, a.m);
  uint32_t word = 0;
  if (live) {
    word = __ldg(a.words + (b * a.m + local) * cest::kLaneWords +
                 cest::sample_offset(t % cest::kLaneSample));
  }
  __syncthreads();  // the shared histogram is zero
  // a warp's 32 words lie in one lane, so `live` is the same in the warp
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t bin = cest::byte_of(word, i);
      if (__reduce_min_sync(kFull, bin) == __reduce_max_sync(kFull, bin)) {
        if (t % cest::kGroup == 0) atomicAdd(&hist[bin], static_cast<uint32_t>(cest::kGroup));
      } else {
        atomicAdd(&hist[bin], 1u);
      }
    }
  }
  __syncthreads();
  if (hist[t] != 0) atomicAdd(&work[1 + t], hist[t]);
  __syncthreads();  // every count of the CTA is added (CTA scope)
  if (t == 0) {
    // release: cumulative over the adds the barrier ordered before it
    fence_acq_rel_gpu();
    is_last = atomicAdd(&work[0], 1u) == a.groups - 1;
    if (is_last) fence_acq_rel_gpu();  // acquire: every CTA's adds
  }
  __syncthreads();
  if (!is_last) return;
  // the block's counts out, each counter zero again
  a.out[b * cest::kBins + t] = static_cast<float>(atomicExch(&work[1 + t], 0u));
  if (t == 0) work[0] = 0;  // zero again for the next launch
}

__global__ void __launch_bounds__(kThreads)
compress_entropy_kernel(const float* __restrict__ hist, float* __restrict__ out) {
  const long long b = blockIdx.x;
  const float adv = block_advisory(static_cast<uint32_t>(hist[b * cest::kBins + threadIdx.x]));
  if (threadIdx.x == 0) out[b] = adv;
}

}  // namespace

// Every entry launches on `stream` (a cudaStream_t passed as a pointer)
// and returns the cudaError_t of the launch (0 on success); the wrapper
// raises on any other value. None synchronises. `work` holds n_blocks x
// 257 uint32 that are zero at the launch and zero again after it.

// (B, 256) float32 histograms of lanes [lane_offset, lane_offset + m) of
// n_blocks blocks.
extern "C" int compress_histogram(const void* words, const void* lane_counts, void* work,
                                  void* out, long long n_blocks, unsigned int m,
                                  unsigned int lane_offset, void* stream) {
  if (n_blocks <= 0 || m == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (static_cast<long long>(m) + kLanesPerCta - 1) / kLanesPerCta;
  if (n_blocks > 0x7FFFFFFFLL / groups) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(words), static_cast<const long long*>(lane_counts),
               static_cast<uint32_t*>(work), static_cast<float*>(out), m,
               static_cast<uint32_t>(groups), lane_offset};
  compress_histogram_kernel<<<static_cast<unsigned int>(n_blocks * groups), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (B,) float32 advisories of n_blocks (B, 256) float32 histograms.
extern "C" int compress_entropy(const void* hist, void* out, long long n_blocks,
                                void* stream) {
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  compress_entropy_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
