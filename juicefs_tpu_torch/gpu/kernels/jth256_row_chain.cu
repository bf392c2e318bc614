// JTH-256 row chain on Hopper (sm_90a), hand-written CUDA C++, with three
// epilogues: the lane fold alone; the lane fold and the per-block combine
// in one launch; or those and the compress plane's estimate of each block
// (bit for bit what compress_estimate.cu's histogram and entropy entries
// give) in one launch.
//
// Replaces the Pallas kernel juicefs_tpu/tpu/hash_jax.py _pallas_row_chain
// (pl.pallas_call at hash_jax.py:228) and the fold the TPU program runs
// after it in the same compiled program: _lane_accs (hash_jax.py:88) under
// both entries, and _combine_accs (:103) with _fmix (:57) under the second:
//   jth256_lane_digests:  words (L, 128, 128) uint32 -> (L, 8) lane digests
//   jth256_block_digests: words (B*M, 128, 128) uint32 -> (B, 8) digests
//   jth256_block_digests_estimate: the same digests, and (B,) float32
//                         advisories min(entropy / 8, 1) of the blocks'
//                         sampled bytes (the ingest path's hash batch)
//   jth256_block_cta_digests, jth256_block_cta_digests_estimate: the two
//                         block entries' results for blocks of M <= 8
//                         lanes, a block in one CTA (see "Short blocks")
// L = B*M lanes of 64 KiB, M lanes a block. Lane l runs with the lane index
// lane_offset + l mod m (uint32 arithmetic), as _lane_states(words,
// lane_offset) and _lane_accs(s, lane_offset) do: a device that holds lanes
// [lane_offset, lane_offset + m) of each block passes its offset so that its
// lanes hash with their global indices, and a lane-split mesh combines the
// gathered lane digests with jth256_combine.cu. A batch whose blocks lie
// whole on one device takes jth256_block_digests: one launch a hash batch.
// `tweak` is xor'ed into every word as it is read, so a timing loop can vary
// it without an extra copy of the batch.
//
// What bounds it: every input word is read once and takes ~9 integer
// operations, so both entries are bound by device-memory bytes: the input
// plus 32 B of digests a lane written (and, for the block entry, read back
// once) plus 64 B a block out, at the card's memory rate (1 GiB of words
// per 16384 lanes).
//
// What held the first design back: one CTA per lane, each thread loading
// its column 8 rows ahead with __ldg, kept 4 KiB a CTA in flight. A
// one-block batch (64 lanes, 64 CTAs on 132 SMs) then moves its 4 MiB in
// many round trips, and the 512 B of states a lane were read back by some
// 130 small torch launches of the fold.
//
// Design: one CTA of 128 threads per lane, one thread per column (the
// chain is sequential in the rows, parallel in the columns). The lane
// streams through shared memory in chunks of 8 rows (4 KiB): one thread
// issues TMA's 1-D bulk copies (cp.async.bulk global -> shared) into a
// ring of `depth` chunks, each completing on its own mbarrier, and refills
// a slot once every thread has consumed it. A warp reads a row of a chunk
// as 32 consecutive words, so the reads are free of bank conflicts.
//
// The ring's depth is a launch argument, 1-16 chunks (4-64 KiB), chosen
// for each launch from its lane count by kernels.ring_depth (in a block
// entry never below a block's lane digests, see the combine): the
// shallowest ring that keeps ~8 MiB in flight across the launch, or the
// deepest below it at which every lane is resident at once, so that the
// batch runs as one wave; a batch that no depth holds at once (more than
// 16 CTAs an SM, 2112 lanes on an H100's 132 SMs) takes 8 chunks, the
// 32 KiB a lane every launch had before the depth followed the batch
// (entry jth256_row_chain_occupancy reads each depth's resident CTAs,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor). Why: with a fixed
// 32 KiB ring an SM held 6 CTAs, 792 lanes (12.4 blocks), and the ingest
// cells' batches of 13-16 and 25-32 blocks ran in two and three waves,
// the last lanes starting only as a wave drained. Every lane resident is
// not enough: with all of them resident, a deeper ring only queues more
// bytes ahead of the chains, which then finish later; each size was
// fastest at the shallowest ring that still kept the memory busy.
// Measured on an H100 80GB HBM3 (700 W, PERF.md section 6), every depth
// at 1-32 blocks and 1 GiB, beside the fixed ring: the rule's depth within
// ~1 % of each size's fastest; against the fixed ring, 0.92x at 13-14
// blocks, 0.96-0.97x at 12 and 16-20, 0.98-1.00x at 8 and 24-28, 0.99-1.02x
// at 32 and 1.00x at 1 GiB, but 1.03 / 1.06 / 1.08-1.09x at 4 / 2 / 1 blocks, where
// a lone CTA's chain is the critical path and pays at each of its 16
// chunk boundaries (the 16-row chunks it replaced had 8). 64 threads a
// lane, two columns a thread, came out slower than 128 at every size; 8
// KiB chunks matched 4 KiB ones from 6 blocks up and beat them at 1-2, but
// hold 16 MiB in flight at 32 blocks, 1.02-1.03x. 128 threads use 28 / 26
// / 18 registers (estimating / block / lane-digests instance), no spill,
// so 16 CTAs fit an SM: threads, not registers, are the limit. chip_smoke.py
// --compare-row-chain DIR times the three entries beside another
// checkout's and sweeps the depth at 13 and 25 blocks.
//
// The lane fold: the 128 column states go to shared memory; after one
// __syncthreads, 8 threads each run the 16 fold steps of their k (column
// gi*8 + k) and write the lane's 8 digest words: 32 B a lane leave the
// chain instead of 512.
//
// The combine, in the block entry: the combine is a sequential chain over
// a block's lanes, so it needs every lane digest of the block, and a block
// is M = 64 CTAs (4 MiB). On a TPU the program's next stage reads them; on
// Hopper no CTA can wait for the others (they need not all be resident,
// and nothing orders them), and a thread-block cluster holds at most 16
// CTAs (8 portable), so distributed shared memory cannot hold a block's
// lanes. The handoff goes through L2 instead: each lane CTA writes its
// digests, fences them (release, one thread after a CTA barrier) and takes
// a ticket from the block's arrival counter; the CTA that draws the last
// ticket (M - 1) fences (acquire), reads the block's live lane digests
// from L2 (__ldcg, not through L1) into the ring it no longer needs (m x
// 32 B, which the launch's depth has to hold: kernels.ring_depth never
// picks a ring below it, and the entries refuse one), in one coalesced
// pass, and 8 threads run the combine chain (jth256::finish_word,
// min(lane_counts[b], M) lanes), the length mix and fmix. It then sets the
// counter back to 0, so the counters are zero for the next launch on the
// stream (the wrapper keeps one zeroed counter buffer per stream). Every
// lane of a block arrives, dead padding lanes too: the combine masks by
// count, not by arrivals. The extra work falls on one CTA a block, the
// ticket's round trip, 2 KiB from L2 and a 64-step dependent chain (at
// 4 MiB blocks). That replaces a second launch (jth256_combine, ~4 us
// queued) and its host call. Measured
// on an H100 (PERF.md section 6) the tail costs ~3 us on a one-block
// batch, all of it serial on the last CTA; unrolling the chain,
// acquire-release instead of sequentially consistent fences and loading
// each block's count and length while the chain runs each took a few
// percent off it.
//
// The estimate, in the third entry (row_chain_kernel<true, true>; the
// other two instances compile without it). The estimator samples every
// 16th row and every 16th column of each lane (compress_estimate.cuh), and
// the chain streams a lane through the ring in chunks of 8 rows, one
// thread a column: each sampled word is row 0 of an even chunk
// (cest::chunk_sampled), read from the ring by a thread whose column is a
// multiple of 16 (2 threads a warp). That thread bins the word's 4 bytes,
// as read and before the tweak, into a 256-bin shared histogram as the
// chunk arrives (cest::bin_word). After the chain the lane's non-zero bins go to the
// block's 256 counts in device memory as L2 reductions, unless the lane is
// at or past its block's lane count (it is still hashed and still takes
// its ticket): the combine's release fence and ticket publish them with
// the lane digests. The block's last CTA takes the counts with
// atomicExch(0), which leaves them zero for the next launch (one zeroed
// workspace per stream, as the arrival counters), and computes the
// advisory on warps 1-3 while threads 0-7 of warp 0 run the combine's chain,
// so the two serial tails overlap: the same integer counts and
// cest::reduce256's order of the sum as compress_estimate.cu's entropy
// entry, so the same bits. A second launch would read again words the
// hash held in a register moments before, and cost a launch's worth of
// card time (~5-6 us at 1-32 blocks, PERF.md section 6). The histogram and
// the entropy's scratch (~1 KiB) lie after the ring in this instance's
// dynamic shared memory. Measured on an H100 80GB HBM3 with the fixed
// 32 KiB ring of 16-row chunks, at 1 / 8 / 13 / 25 / 32 blocks of random
// words, this entry took 1.07-1.08 / 1.04 / 1.04-1.05 / 1.02-1.03 /
// 1.02-1.03x the block entry's time, against 1.50 / 1.30 / 1.22 / 1.18 /
// 1.15x for the block entry followed by the standalone estimator; taken
// out one at a time, the binning in the chain cost 1.6-6.8 points of that
// and the flush of the bins 0.9-3.7.
//
// Short blocks (row_chain_kernel_cta_block, the jth256_block_cta_* entries):
// the handoff above is forced where a block's lanes cannot share a CTA, a
// 4 MiB block's 64 of them. A block of m <= 8 lanes fits one CTA of m x 128
// threads (a close(2) of a small file is a batch of one 2-lane block). These
// entries run a block in one CTA, lane li on threads [128 li, 128 li + 128),
// one thread a column: each lane streams through its own ring of TMA bulk
// copies (its own mbarriers, and a named barrier over its 128 threads to
// refill a slot); each lane's 8 fold threads write its digests to shared
// memory; after a barrier over the lanes' threads warp 0 combines the live
// lanes. No arrival counter, count workspace, fence, ticket, L2 atomic or
// lane-digest scratch. A lane at or past its block's count only drains its
// copies (the spec never combines it, nor counts its bytes).
// The estimate, in the estimating instance, runs on a warp of its own
// after the lanes' threads (row_chain_kernel_cta_block<true, true>, m x
// 128 + 32 threads): it leaves the lanes at the CTA's start, gathers the
// block's m x 64 sampled words straight from `words` with its own loads,
// 14 a thread (cest::gather_sample: 256 B a lane, as read, before the
// tweak; in flight with the first chunk), bins the counted lanes' bytes
// into a shared histogram it zeroes itself (cest::bin_sample) and
// computes the advisory alone (warp_advisory: cest::reduce256's order),
// all while the lanes chain. The lanes run the plain instance's chain and
// take named barriers over their own threads, so the warp never holds
// them back. Where a CTA has no room for the warp (8 lanes, 1024 threads;
// never dispatched) the launch takes <true, false>: the lanes' threads
// gather and bin the sample, a word a thread, before their first chunk's
// wait, and warps 1-3 run the entropy beside the combine, as the last CTA
// does above. Before, the lanes binned each sampled word as its
// row arrived (4 shared atomics on 2 threads a warp, the other 30
// waiting, inside a 128-step dependent chain) and the entropy began only
// after the chains: 1.0-1.2 us of every launch. Two things kept the warp
// from being free: the entropy's __fdiv_rn brought its slow path, a
// subroutine call, into the kernel, after which ptxas re-read the thread
// index and recomputed the ring's addresses at every chunk of the chain
// (cest::div_rn leaves the call out, bit for bit); and the 8-lane
// fallback's code, dead at m <= 7, cost ~0.3 us more in the same
// instance, hence an instance of its own. Measured on an H100 80GB HBM3
// (700 W, PERF.md section 6, parent / change, in turns), the estimating
// entry at 1 block x 1 / 2 / 4 lanes and 8 / 32 blocks x 2 lanes: 7.49 /
// 7.84 / 9.14 / 8.35 / 8.93 us against 6.53 / 6.86 / 8.22 / 7.40 / 8.00,
// the plain entry beside them 6.40 / 6.66 / 7.89 / 7.28 / 7.91.
// The chunks are 16 rows (8 KiB): a lane's chain waits at each chunk
// boundary on the launch's critical path. The ring holds 1-8 chunks a lane
// (kernels.ring_depth over this entry's own occupancy table, entry codes 3
// and 4 of jth256_row_chain_occupancy): the whole lane up to 3 lanes, fewer
// chunks from 4 lanes, within the card's 227 KiB a CTA.
// Measured on an H100 80GB HBM3 (700 W, PERF.md section 6), the estimating
// entry at one block of 2 lanes: 9.42 us cross-CTA, 7.72 us here (with
// the estimate still in the chain). The two
// changes need each other: the cross-CTA entry with 8 KiB chunks took 8.63,
// one CTA with 4 KiB chunks ~9.7 (two lanes' copies through one SM). 16,
// 32 and 64 KiB chunks took 1.4-3.4 us more than 8 KiB, and so did issuing
// a lane's copies from 8 threads at once. From 5 lanes on the one SM
// streams 320-512 KiB and the design loses (1.02-1.34x the cross-CTA entry
// at 1 and 8 blocks), so the wrappers send it blocks of at most
// kernels.CTA_BLOCK_LANES = 4 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "compress_estimate.cuh"
#include "jth256_step.cuh"

namespace {

constexpr int kThreads = jth256::kCols;  // a column a thread
constexpr int kChunkRows = cest::kChunkRows;  // the estimate samples row 0 of even chunks
constexpr int kChunkBytes = kChunkRows * jth256::kCols * 4;  // 4 KiB
constexpr int kChunks = jth256::kRows / kChunkRows;          // 16 a lane
constexpr int kMinDepth = 1;                                 // ring of 1-16 chunks
constexpr int kMaxDepth = kChunks;
constexpr long long kLaneBytes = jth256::kRows * jth256::kCols * 4;
static_assert(jth256::kCols == cest::kCols && jth256::kRows == cest::kRows,
              "the chain's lanes are the estimate's");
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the last CTA's entropy runs on warps 1-3 while warp 0 combines
constexpr int kEntropyWarps = kThreads / kWarp - 1;                                    // 3
constexpr int kEntropyThreads = kEntropyWarps * kWarp;                                 // 96
constexpr int kBinsPerThread = (cest::kBins + kEntropyThreads - 1) / kEntropyThreads;  // 3
// the one-CTA block entries: a block of at most 8 lanes (512 KiB) a CTA
constexpr int kCtaMaxLanes = 8;
constexpr int kCtaThreads = kCtaMaxLanes * kThreads;              // 1024, a CTA's most
constexpr int kCtaChunkRows = 16;
constexpr int kCtaChunkBytes = kCtaChunkRows * jth256::kCols * 4;  // 8 KiB
constexpr int kCtaChunks = jth256::kRows / kCtaChunkRows;         // 8 a lane
constexpr int kCtaMaxDepth = kCtaChunks;                          // the whole lane
static_assert(kCtaMaxDepth <= kMaxDepth, "the occupancy entry's depths cover both designs");

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

// A gpu-scope acquire-release fence: lighter than __threadfence() (a
// sequentially consistent fence), and all the arrival handoff needs.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// The block entry's extra arguments (unused by the lane-digests entry).
struct BlockArgs {
  const long long* lane_counts;  // (B,) live lanes of each block
  const long long* lengths;      // (B,) byte length of each block
  unsigned int* arrivals;        // (>= B,) zero at launch, zero at exit
  long long* out;                // (B, 8) digest words
};

// The estimating entry's extra arguments; the other instances take an
// empty struct in their place.
struct EstimateArgs {
  uint32_t* counts;  // (>= B, 256) sampled byte counts, zero at launch and exit
  float* out;        // (B,) advisories
};
struct NoEstimate {};
template <bool kEstimate>
using EstimateArg = typename std::conditional<kEstimate, EstimateArgs, NoEstimate>::type;

// The estimating instance's shared memory, after the ring in its dynamic
// shared memory (the other instances have none of it).
struct EstimateSmem {
  uint32_t hist[cest::kBins];            // the lane's sampled bytes
  uint32_t total_parts[kEntropyWarps];   // the last CTA's count sums, a warp each
  float group_sums[cest::kGroups];       // the last CTA's 8 group sums of terms
  uint32_t counted;                      // the lane is below its block's lane count
};

template <bool kEstimate>
constexpr int smem_bytes(int depth) {
  return depth * kChunkBytes + (kEstimate ? static_cast<int>(sizeof(EstimateSmem)) : 0);
}

// Named barrier 1 over warps 1-3, the last CTA's entropy, which warp 0
// (the combine) never waits on.
__device__ __forceinline__ void entropy_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEntropyThreads) : "memory");
}

// The advisory of a block, run by warps 1-3 of its last CTA, thread
// kWarp + i holding the counts of bins i + 96k (k < 3, bins < 256); valid
// in thread kWarp. Bin i + 96k lies in group w + 3k (w = i / 32) at lane
// i % 32, so each warp sums its groups with the butterflies of
// cest::reduce256, and warp 1 sums the 8 group sums as compress_estimate.cu's
// cta_term_sum does: the same bits as its entropy entry's.
__device__ __forceinline__ float entropy_advisory(const uint32_t (&bins)[kBinsPerThread],
                                                  EstimateSmem* es) {
  const uint32_t lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp - 1;
  uint32_t t = 0;
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) t += bins[k];
  for (int off = kWarp / 2; off > 0; off /= 2) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) es->total_parts[w] = t;
  entropy_barrier();
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < kEntropyWarps; ++i) total += es->total_parts[i];
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const uint32_t g = w + k * kEntropyWarps;
    if (g < cest::kGroups) {  // the same in the warp
      float v = cest::entropy_term(bins[k], total);
      for (int off = cest::kGroup / 2; off > 0; off /= 2) {
        v = cest::add_rn(v, __shfl_xor_sync(kFull, v, off));
      }
      if (lane == 0) es->group_sums[g] = v;
    }
  }
  entropy_barrier();
  float v = 0.0f;
  if (w == 0) {
    v = lane < cest::kGroups ? es->group_sums[lane] : 0.0f;
    for (int off = cest::kGroups / 2; off > 0; off /= 2) {
      v = cest::add_rn(v, __shfl_xor_sync(kFull, v, off));
    }
  }
  return cest::advisory(v);
}

template <bool kBlocks, bool kEstimate>
__global__ void __launch_bounds__(kThreads)
row_chain_kernel(const uint32_t* __restrict__ words,
                 uint32_t* __restrict__ lane_out, uint32_t m,
                 uint32_t lane_offset, uint32_t tweak, uint32_t depth, BlockArgs blk,
                 EstimateArg<kEstimate> est) {
  static_assert(kBlocks || !kEstimate, "the estimate is a block entry's");
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  __shared__ uint32_t states[jth256::kCols];
  __shared__ uint32_t is_last, block_live, block_len;
  const long long lane = blockIdx.x;
  const uint32_t col = threadIdx.x;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(words) + lane * kLaneBytes;

  if (col == 0) {
    for (uint32_t i = 0; i < depth; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  EstimateSmem* es = nullptr;
  if constexpr (kEstimate) {
    es = reinterpret_cast<EstimateSmem*>(ring + depth * kChunkBytes);
    for (uint32_t i = col; i < cest::kBins; i += kThreads) es->hist[i] = 0;
  }
  __syncthreads();
  if (col == 0) {
    for (uint32_t c = 0; c < depth; ++c) {
      mbar_expect_tx(&full[c], kChunkBytes);
      bulk_load(ring + c * kChunkBytes, src + c * kChunkBytes, kChunkBytes, &full[c]);
    }
  }

  // the block's count and length, loaded while the chain runs, so that the
  // last lane to arrive does not wait on device memory for them
  long long count = 0, length = 0;
  if (kBlocks && col == 0) {
    count = blk.lane_counts[lane / m];
    length = blk.lengths[lane / m];
  }

  const uint32_t lane_idx = lane_offset + static_cast<uint32_t>(lane % m);
  uint32_t s = jth256::init_state(col, lane_idx);
  uint32_t slot = 0, parity = 0;
#pragma unroll 1
  for (uint32_t c = 0; c < kChunks; ++c) {
    mbar_wait(&full[slot], parity);
    const uint32_t* tile = reinterpret_cast<const uint32_t*>(ring + slot * kChunkBytes) + col;
    if constexpr (kEstimate) {
      // row 0 of an even chunk, as read: a sampled word in every 16th column
      if (cest::chunk_sampled(c, col)) cest::bin_word(es->hist, tile[0]);
    }
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) s = jth256::row_step(s, tile[r * kThreads] ^ tweak);
    if (c + depth < kChunks) {
      __syncthreads();  // every thread is done with the slot: refill it
      if (col == 0) {
        mbar_expect_tx(&full[slot], kChunkBytes);
        bulk_load(ring + slot * kChunkBytes, src + (c + depth) * kChunkBytes, kChunkBytes,
                  &full[slot]);
      }
    }
    if (++slot == depth) {
      slot = 0;
      parity ^= 1u;
    }
  }

  // the lane fold; the barrier also retires the ring (every chunk consumed)
  // and completes the lane's histogram
  states[col] = s;
  if constexpr (kEstimate) {
    if (col == 0) {
      es->counted = static_cast<uint32_t>(lane % m) < cest::counted_lanes(count, 0, m);
    }
  }
  __syncthreads();
  if (col < jth256::kDigestWords) {
    uint32_t acc = jth256::fold_seed(lane_idx, col);
#pragma unroll
    for (uint32_t gi = 0; gi < jth256::kGroups; ++gi) {
      acc = jth256::fold_step(acc, states[gi * jth256::kDigestWords + col], gi);
    }
    lane_out[lane * jth256::kDigestWords + col] = acc;
  }
  if constexpr (kBlocks) {
    const long long b = lane / m;
    if constexpr (kEstimate) {
      // a counted lane's bins into its block's counts: L2 reductions, which
      // the barrier and the release fence below order before the ticket
      if (es->counted) {
        for (uint32_t i = col; i < cest::kBins; i += kThreads) {
          const uint32_t v = es->hist[i];
          if (v != 0) atomicAdd(&est.counts[b * cest::kBins + i], v);
        }
      }
    }
    __syncthreads();  // the lane's words (and counts) are written (CTA scope)
    if (col == 0) {
      // release: the fence is cumulative over the writes the barrier
      // ordered before it, so the ticket publishes the lane's words
      fence_acq_rel_gpu();
      is_last = atomicAdd(&blk.arrivals[b], 1u) == m - 1;
      if (is_last) fence_acq_rel_gpu();  // acquire: every lane's words
      block_live = count <= 0 ? 0u : (count >= m ? m : static_cast<uint32_t>(count));
      block_len = static_cast<uint32_t>(length);
    }
    __syncthreads();
    if (!is_last) return;
    uint32_t bins[kBinsPerThread] = {};
    if constexpr (kEstimate) {
      // warps 1-3 take the block's counts, which also zeroes them for the
      // next launch; the exchanges are in flight while the ring is staged
      if (col >= kWarp) {
        uint32_t* block_counts = est.counts + b * cest::kBins;
#pragma unroll
        for (int k = 0; k < kBinsPerThread; ++k) {
          const uint32_t bin = col - kWarp + k * kEntropyThreads;
          if (bin < cest::kBins) bins[k] = atomicExch(&block_counts[bin], 0u);
        }
      }
    }
    const uint32_t live = block_live;
    const uint32_t* block_src = lane_out + b * m * jth256::kDigestWords;
    uint32_t* stage = reinterpret_cast<uint32_t*>(ring);
    for (uint32_t i = col; i < live * jth256::kDigestWords; i += kThreads) {
      stage[i] = __ldcg(block_src + i);
    }
    __syncthreads();
    if (col < jth256::kDigestWords) {
      blk.out[b * jth256::kDigestWords + col] = static_cast<long long>(
          jth256::finish_word(stage, jth256::kDigestWords, live, block_len, col));
    }
    if constexpr (kEstimate) {
      // beside the combine's chain on warp 0, not after it
      if (col >= kWarp) {
        const float adv = entropy_advisory(bins, es);
        if (col == kWarp) est.out[b] = adv;
      }
    }
    if (col == 0) blk.arrivals[b] = 0;  // zero again for the next launch
  }
}

// Above 48 KiB a CTA's dynamic shared memory must be allowed per function
// on each device: allowed once a device, up to the deepest ring's size.
template <bool kBlocks, bool kEstimate>
cudaError_t allow_deepest_ring() {
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (allowed.load(std::memory_order_relaxed) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(row_chain_kernel<kBlocks, kEstimate>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<kEstimate>(kMaxDepth));
  if (err == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool kBlocks, bool kEstimate>
int launch(const void* words, void* lane_out, long long n_lanes, unsigned int m,
           unsigned int lane_offset, unsigned int tweak, unsigned int depth, BlockArgs blk,
           EstimateArg<kEstimate> est, void* stream) {
  if (n_lanes <= 0 || n_lanes > 0x7FFFFFFFLL || m == 0 ||
      depth < static_cast<unsigned int>(kMinDepth) ||
      depth > static_cast<unsigned int>(kMaxDepth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the block entry stages a block's lane digests in the ring
  if (kBlocks && (n_lanes % m != 0 || static_cast<long long>(m) * jth256::kDigestWords * 4 >
                                          static_cast<long long>(depth) * kChunkBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  }
  cudaError_t err = allow_deepest_ring<kBlocks, kEstimate>();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_chain_kernel<kBlocks, kEstimate>
      <<<static_cast<unsigned int>(n_lanes), kThreads, smem_bytes<kEstimate>(depth),
         static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(words),
                                              static_cast<uint32_t*>(lane_out), m,
                                              lane_offset, tweak, depth, blk, est);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlocks, bool kEstimate>
int occupancy(int depth, int* ctas) {
  cudaError_t err = allow_deepest_ring<kBlocks, kEstimate>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, row_chain_kernel<kBlocks, kEstimate>, kThreads, smem_bytes<kEstimate>(depth)));
}

// A named barrier over the 128 threads of lane `li` of a one-CTA block
// (ids 2-9; 0 is __syncthreads, 1 the entropy's).
__device__ __forceinline__ void lane_barrier(uint32_t li) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + li), "n"(kThreads) : "memory");
}

template <bool kEstimate>
constexpr int cta_smem_bytes(int m, int depth) {
  return m * depth * kCtaChunkBytes + (kEstimate ? static_cast<int>(sizeof(EstimateSmem)) : 0);
}

// The estimating instance takes its estimate warp, after the lanes'
// threads, where a CTA has room for it (m <= 7 lanes; the wrappers send at
// most 4): row_chain_kernel_cta_block<true, true>, else <true, false>.
constexpr int kCtaGatherWords = (kCtaMaxLanes - 1) * cest::kLaneSample / kWarp;  // 14 a thread
__host__ __device__ constexpr bool cta_estimate_warp(uint32_t m) {
  return m * kThreads + kWarp <= static_cast<uint32_t>(kCtaThreads);
}
__host__ __device__ constexpr uint32_t cta_threads(bool own_warp, uint32_t m) {
  return m * kThreads + (own_warp ? kWarp : 0);
}

// Named barrier 10 over the m x 128 threads of a one-CTA block's lanes,
// which the estimate warp never waits on.
__device__ __forceinline__ void lanes_barrier(uint32_t m) {
  asm volatile("bar.sync 10, %0;\n" ::"r"(m * kThreads) : "memory");
}

// The advisory of a 256-bin histogram by one warp, lane i holding bins
// i + 32 g (g < 8): bin i + 32 g is lane i of group g, so each group is one
// butterfly of cest::reduce256 (which leaves its sum in every lane), lane g
// keeps group g's sum, and lanes 0-7 sum the 8 with reduce256's last
// butterfly: the same bits as compress_estimate.cu's entropy entry. Valid
// in lane 0.
__device__ __forceinline__ float warp_advisory(const uint32_t* hist) {
  const uint32_t lane = threadIdx.x % kWarp;
  uint32_t bins[cest::kGroups], total = 0;
#pragma unroll
  for (int g = 0; g < cest::kGroups; ++g) {
    bins[g] = hist[lane + g * cest::kGroup];
    total += bins[g];
  }
  for (int off = kWarp / 2; off > 0; off /= 2) total += __shfl_xor_sync(kFull, total, off);
  float mine = 0.0f;
#pragma unroll
  for (int g = 0; g < cest::kGroups; ++g) {
    float v = cest::entropy_term(bins[g], total);
    for (int off = cest::kGroup / 2; off > 0; off /= 2) {
      v = cest::add_rn(v, __shfl_xor_sync(kFull, v, off));
    }
    if (lane == static_cast<uint32_t>(g)) mine = v;
  }
  for (int off = cest::kGroups / 2; off > 0; off /= 2) {
    mine = cest::add_rn(mine, __shfl_xor_sync(kFull, mine, off));
  }
  return cest::advisory(mine);
}

// The estimate warp's work: the block's m x 64 sampled words gathered
// with its own loads (14 a thread, in flight while it zeroes the
// histogram), the counted lanes' bytes binned, and the advisory into *out.
__device__ __forceinline__ void estimate_block(uint32_t* hist, const uint32_t* block_words,
                                               uint32_t m, const long long* count, float* out) {
  const uint32_t lane = threadIdx.x % kWarp;
  uint32_t sample[kCtaGatherWords];
  cest::gather_sample(sample, block_words, m * cest::kLaneSample, lane, kWarp);
  const uint32_t live = cest::counted_lanes(*count, 0, m);
  for (uint32_t i = lane; i < cest::kBins; i += kWarp) hist[i] = 0;
  __syncwarp();
  cest::bin_sample(hist, sample, live * cest::kLaneSample, lane, kWarp);
  __syncwarp();
  const float adv = warp_advisory(hist);
  if (lane == 0) *out = adv;
}

// One CTA a block of m <= kCtaMaxLanes lanes: lane li on threads [128 li,
// 128 li + 128), a column a thread, through its own ring of `depth` chunks
// of kCtaChunkBytes; then the fold, the combine and (kEstimate) the
// estimate with no handoff out of the CTA (the design note at the head of
// the file). kOwnWarp: the estimate on a warp of its own, threads
// [128 m, 128 m + 32), beside the lanes; else on the lanes' threads.
template <bool kEstimate, bool kOwnWarp = false>
__global__ void __launch_bounds__(kCtaThreads)
row_chain_kernel_cta_block(const uint32_t* __restrict__ words, uint32_t m, uint32_t tweak,
                           uint32_t depth, BlockArgs blk, EstimateArg<kEstimate> est) {
  static_assert(kEstimate || !kOwnWarp, "the estimate warp is the estimating instance's");
  constexpr bool kLanesEstimate = kEstimate && !kOwnWarp;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kCtaMaxLanes][kCtaMaxDepth];
  __shared__ uint32_t states[kCtaMaxLanes][jth256::kCols];
  __shared__ uint32_t digests[kCtaMaxLanes * jth256::kDigestWords];
  const long long b = blockIdx.x;
  const uint32_t tid = threadIdx.x, li = tid / kThreads, col = tid % kThreads;
  const uint8_t* src =
      reinterpret_cast<const uint8_t*>(words) + (b * m + li) * kLaneBytes;
  uint8_t* lane_ring = ring + li * depth * kCtaChunkBytes;
  EstimateSmem* es = nullptr;
  if constexpr (kEstimate) es = reinterpret_cast<EstimateSmem*>(ring + m * depth * kCtaChunkBytes);
  if constexpr (kOwnWarp) {
    if (li == m) {  // the estimate warp
      estimate_block(es->hist, words + b * m * cest::kLaneWords, m, blk.lane_counts + b,
                     est.out + b);
      return;
    }
  }

  // the block's count and length, in flight while the first chunk is
  const long long count = blk.lane_counts[b];
  const long long length = blk.lengths[b];
  if (col == 0) {
    for (uint32_t i = 0; i < depth; ++i) mbar_init(&full[li][i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (uint32_t c = 0; c < depth; ++c) {
      mbar_expect_tx(&full[li][c], kCtaChunkBytes);
      bulk_load(lane_ring + c * kCtaChunkBytes, src + c * kCtaChunkBytes, kCtaChunkBytes,
                &full[li][c]);
    }
  }
  // with the estimate on the lanes' threads, they gather the block's
  // sample, a word a thread of the first m x 64
  uint32_t sample[1];
  if constexpr (kLanesEstimate) {
    for (uint32_t i = tid; i < cest::kBins; i += blockDim.x) es->hist[i] = 0;
    cest::gather_sample(sample, words + b * m * cest::kLaneWords, m * cest::kLaneSample, tid,
                        m * kThreads);
  }
  // the barriers are initialised (and the histogram zero)
  if constexpr (kOwnWarp) {
    lanes_barrier(m);
  } else {
    __syncthreads();
  }

  // a lane at or past the count is never combined (nor counted): it only
  // drains its copies
  const uint32_t live = cest::counted_lanes(count, 0, m);
  if constexpr (kLanesEstimate) {  // binned before the first chunk's wait
    cest::bin_sample(es->hist, sample, live * cest::kLaneSample, tid, m * kThreads);
  }
  const bool chained = li < live;
  uint32_t s = jth256::init_state(col, li);
  uint32_t slot = 0, parity = 0;
#pragma unroll 1
  for (uint32_t c = 0; c < kCtaChunks; ++c) {
    mbar_wait(&full[li][slot], parity);
    const uint32_t* tile =
        reinterpret_cast<const uint32_t*>(lane_ring + slot * kCtaChunkBytes) + col;
    if (chained) {
#pragma unroll
      for (int r = 0; r < kCtaChunkRows; ++r) s = jth256::row_step(s, tile[r * kThreads] ^ tweak);
    }
    if (c + depth < kCtaChunks) {
      lane_barrier(li);  // the lane's threads are done with the slot: refill it
      if (col == 0) {
        mbar_expect_tx(&full[li][slot], kCtaChunkBytes);
        bulk_load(lane_ring + slot * kCtaChunkBytes, src + (c + depth) * kCtaChunkBytes,
                  kCtaChunkBytes, &full[li][slot]);
      }
    }
    if (++slot == depth) {
      slot = 0;
      parity ^= 1u;
    }
  }

  // the lane fold, on the lane's own barrier
  states[li][col] = s;
  lane_barrier(li);
  if (chained && col < jth256::kDigestWords) {
    uint32_t acc = jth256::fold_seed(li, col);
#pragma unroll
    for (uint32_t gi = 0; gi < jth256::kGroups; ++gi) {
      acc = jth256::fold_step(acc, states[li][gi * jth256::kDigestWords + col], gi);
    }
    digests[li * jth256::kDigestWords + col] = acc;
  }
  // every live lane's digests (and every sampled byte the lanes binned) are in
  if constexpr (kOwnWarp) {
    lanes_barrier(m);
  } else {
    __syncthreads();
  }
  if (tid < jth256::kDigestWords) {
    blk.out[b * jth256::kDigestWords + tid] = static_cast<long long>(jth256::finish_word(
        digests, jth256::kDigestWords, live, static_cast<uint32_t>(length), tid));
  }
  if constexpr (kLanesEstimate) {
    // beside the combine's chain on warp 0, as the cross-CTA entry's last CTA
    if (tid >= kWarp && tid < kThreads) {
      uint32_t bins[kBinsPerThread];
#pragma unroll
      for (int k = 0; k < kBinsPerThread; ++k) {
        const uint32_t bin = tid - kWarp + k * kEntropyThreads;
        bins[k] = bin < cest::kBins ? es->hist[bin] : 0u;
      }
      const float adv = entropy_advisory(bins, es);
      if (tid == kWarp) est.out[b] = adv;
    }
  }
}

// The one-CTA instance's largest dynamic shared memory on the current
// device (the card's opt-in limit a block less its static shared memory),
// into *limit; allowed once a device.
template <bool kEstimate, bool kOwnWarp>
cudaError_t allow_cta_smem(int* limit) {
  static std::atomic<int> allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*limit = allowed[dev].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, row_chain_kernel_cta_block<kEstimate, kOwnWarp>);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *limit = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(row_chain_kernel_cta_block<kEstimate, kOwnWarp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err == cudaSuccess && dev < 64) allowed[dev].store(*limit, std::memory_order_relaxed);
  return err;
}

// The estimating instance runs blocks of m lanes with its estimate warp
// where the CTA has room for it (cta_estimate_warp), else on the lanes.
template <bool kEstimate, bool kOwnWarp = false>
int launch_cta(const void* words, BlockArgs blk, EstimateArg<kEstimate> est,
               long long n_blocks, unsigned int m, unsigned int tweak, unsigned int depth,
               void* stream) {
  if constexpr (kEstimate && !kOwnWarp) {
    if (cta_estimate_warp(m)) {
      return launch_cta<true, true>(words, blk, est, n_blocks, m, tweak, depth, stream);
    }
  }
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL || m == 0 ||
      m > static_cast<unsigned int>(kCtaMaxLanes) || depth == 0 ||
      depth > static_cast<unsigned int>(kCtaMaxDepth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  }
  int limit = 0;
  cudaError_t err = allow_cta_smem<kEstimate, kOwnWarp>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = cta_smem_bytes<kEstimate>(static_cast<int>(m), static_cast<int>(depth));
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);  // a ring the CTA cannot hold
  row_chain_kernel_cta_block<kEstimate, kOwnWarp>
      <<<static_cast<unsigned int>(n_blocks), cta_threads(kOwnWarp, m), smem,
         static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(words), m, tweak,
                                              depth, blk, est);
  return static_cast<int>(cudaGetLastError());
}

template <bool kEstimate, bool kOwnWarp = false>
int occupancy_cta(int m, int depth, int* ctas) {
  if constexpr (kEstimate && !kOwnWarp) {
    if (m >= 1 && cta_estimate_warp(static_cast<uint32_t>(m))) {
      return occupancy_cta<true, true>(m, depth, ctas);
    }
  }
  if (m < 1 || m > kCtaMaxLanes || depth > kCtaMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int limit = 0;
  cudaError_t err = allow_cta_smem<kEstimate, kOwnWarp>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = cta_smem_bytes<kEstimate>(m, depth);
  if (smem > limit) {
    *ctas = 0;  // a ring this CTA cannot hold
    return 0;
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, row_chain_kernel_cta_block<kEstimate, kOwnWarp>,
      static_cast<int>(cta_threads(kOwnWarp, static_cast<uint32_t>(m))), smem));
}

BlockArgs block_args(const void* lane_counts, const void* lengths, void* arrivals,
                     void* out) {
  return BlockArgs{static_cast<const long long*>(lane_counts),
                   static_cast<const long long*>(lengths),
                   static_cast<unsigned int*>(arrivals), static_cast<long long*>(out)};
}

bool bad_blocks(long long n_blocks, unsigned int m) {
  return n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL / (m ? m : 1);
}

}  // namespace

// Every entry launches on `stream` (a cudaStream_t passed as a pointer)
// with a ring of `depth` chunks of 4 KiB (1-16; a block entry's ring has
// to hold a block's lane digests, m x 32 B <= depth x 4 KiB) and returns the
// cudaError_t of the launch (0 on success); the wrapper raises on any
// other value. They do not synchronise.

// (L, 8) uint32 per-lane digests (the lane fold of the states).
extern "C" int jth256_lane_digests(const void* words, void* out,
                                   long long n_lanes, unsigned int m,
                                   unsigned int lane_offset,
                                   unsigned int tweak, unsigned int depth, void* stream) {
  return launch<false, false>(words, out, n_lanes, m, lane_offset, tweak, depth, BlockArgs{},
                              NoEstimate{}, stream);
}

// (B, 8) int64 block digests of n_blocks whole blocks of m lanes: the lane
// fold into `lane_digests` (int32 (B*m, 8) scratch), then the combine by
// the last lane of each block to arrive. `arrivals` holds >= n_blocks
// uint32 counters that are zero at the launch and zero again after it.
extern "C" int jth256_block_digests(const void* words, void* lane_digests,
                                    const void* lane_counts, const void* lengths,
                                    void* arrivals, void* out, long long n_blocks,
                                    unsigned int m, unsigned int tweak, unsigned int depth,
                                    void* stream) {
  if (bad_blocks(n_blocks, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, false>(words, lane_digests, n_blocks * m, m, 0u, tweak, depth,
                             block_args(lane_counts, lengths, arrivals, out),
                             NoEstimate{}, stream);
}

// jth256_block_digests and the compress estimate in one launch: the (B, 8)
// digests into `out` as that entry writes them, and the (B,) float32
// advisories of the same words (compress_estimate.cu's, bit for bit) into
// `advisories`. `counts` holds >= n_blocks x 256 uint32 that are zero at
// the launch and zero again after it.
extern "C" int jth256_block_digests_estimate(const void* words, void* lane_digests,
                                             const void* lane_counts, const void* lengths,
                                             void* arrivals, void* out, void* counts,
                                             void* advisories, long long n_blocks,
                                             unsigned int m, unsigned int tweak,
                                             unsigned int depth, void* stream) {
  if (bad_blocks(n_blocks, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, true>(words, lane_digests, n_blocks * m, m, 0u, tweak, depth,
                            block_args(lane_counts, lengths, arrivals, out),
                            EstimateArgs{static_cast<uint32_t*>(counts),
                                         static_cast<float*>(advisories)},
                            stream);
}

// jth256_block_digests' (B, 8) digests of n_blocks blocks of m <= 8 lanes
// (4 MiB - 512 KiB), one CTA a block, with a ring of `depth` chunks of
// 8 KiB a lane (1-8; m x depth x 8 KiB within what a CTA holds): no lane
// digests scratch, no arrival counters.
extern "C" int jth256_block_cta_digests(const void* words, const void* lane_counts,
                                        const void* lengths, void* out, long long n_blocks,
                                        unsigned int m, unsigned int tweak, unsigned int depth,
                                        void* stream) {
  return launch_cta<false>(words, block_args(lane_counts, lengths, nullptr, out), NoEstimate{},
                           n_blocks, m, tweak, depth, stream);
}

// jth256_block_digests_estimate's digests and advisories of blocks of
// m <= 8 lanes, one CTA a block as jth256_block_cta_digests: no count
// workspace.
extern "C" int jth256_block_cta_digests_estimate(const void* words, const void* lane_counts,
                                                 const void* lengths, void* out,
                                                 void* advisories, long long n_blocks,
                                                 unsigned int m, unsigned int tweak,
                                                 unsigned int depth, void* stream) {
  return launch_cta<true>(words, block_args(lane_counts, lengths, nullptr, out),
                          EstimateArgs{nullptr, static_cast<float*>(advisories)}, n_blocks, m,
                          tweak, depth, stream);
}

// The resident CTAs per SM, on the current device, of the lane-digests
// entry (entry 0), the block entry (1) or the estimating entry (2), a lane
// a CTA (`lanes` 1), or of the one-CTA block entry (3) or its estimating
// entry (4) over blocks of `lanes` lanes, with a ring of `depth` chunks,
// into *ctas (0 for a ring the CTA cannot hold); returns the cudaError_t
// of the query.
extern "C" int jth256_row_chain_occupancy(int entry, int lanes, int depth, int* ctas) {
  if (depth < kMinDepth || depth > kMaxDepth || (entry < 3 && lanes != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (entry) {
    case 0: return occupancy<false, false>(depth, ctas);
    case 1: return occupancy<true, false>(depth, ctas);
    case 2: return occupancy<true, true>(depth, ctas);
    case 3: return occupancy_cta<false>(lanes, depth, ctas);
    case 4: return occupancy_cta<true>(lanes, depth, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
