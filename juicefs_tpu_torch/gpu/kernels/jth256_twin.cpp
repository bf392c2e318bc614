// CPU twin of jth256_row_chain.cu (all its entries), jth256_combine.cu
// and compress_estimate.cu: the same per-lane chain, lane fold and
// combine, and the same estimator sample, mask, binning and entropy, built
// with g++ from the same jth256_step.cuh and compress_estimate.cuh, so the
// CPU tests can hold the arithmetic the card runs against the JAX package
// (no nvcc is needed to build it). row_chain returns the chain's states,
// which no entry writes out: it checks the row steps alone.
#include <torch/extension.h>

#include <algorithm>
#include <tuple>
#include <vector>

#include "compress_estimate.cuh"
#include "jth256_step.cuh"

namespace {

void check_words(const torch::Tensor& words, int64_t m) {
  TORCH_CHECK(words.device().is_cpu(), "words must lie on the CPU");
  TORCH_CHECK(words.scalar_type() == torch::kInt32, "words must be int32");
  TORCH_CHECK(words.dim() == 3 && words.size(1) == jth256::kRows &&
                  words.size(2) == jth256::kCols,
              "words must be (L, 128, 128)");
  TORCH_CHECK(words.is_contiguous(), "words must be contiguous");
  TORCH_CHECK(m >= 1, "m must be >= 1");
}

// Final states of lane `lane` (its index in the batch) into s[128], the
// lane streamed in chunks of cest::kChunkRows rows as the kernel streams
// it. With `hist`, the words the estimate samples (row 0 of a chunk that
// cest::chunk_sampled names) are binned into it as the chain reads them,
// before the tweak, as the estimating entry's threads do.
void chain_lane(const uint32_t* w, int64_t lane, int64_t m, uint32_t tw,
                uint32_t loff, uint32_t* s, uint32_t* hist = nullptr) {
  const uint32_t* lw = w + lane * jth256::kRows * jth256::kCols;
  const uint32_t idx = loff + static_cast<uint32_t>(lane % m);
  constexpr uint32_t kCols = jth256::kCols;
  for (uint32_t col = 0; col < kCols; ++col) s[col] = jth256::init_state(col, idx);
  for (uint32_t c = 0; c < static_cast<uint32_t>(jth256::kRows / cest::kChunkRows); ++c) {
    const uint32_t* chunk = lw + c * cest::kChunkRows * kCols;
    for (uint32_t col = 0; hist != nullptr && col < kCols; ++col) {
      if (cest::chunk_sampled(c, col)) cest::bin_word(hist, chunk[col]);
    }
    for (int r = 0; r < cest::kChunkRows; ++r) {
      for (uint32_t col = 0; col < kCols; ++col) {
        s[col] = jth256::row_step(s[col], chunk[r * kCols + col] ^ tw);
      }
    }
  }
}

// Final states of lane `lane` (its index in the batch), lane index `li`
// of its block, into s[128], as the one-CTA block entries chain it (the
// bare chain: the estimate gathers its sample apart from it).
void chain_lane_cta(const uint32_t* w, int64_t lane, uint32_t li, uint32_t tw, uint32_t* s) {
  const uint32_t* lw = w + lane * jth256::kRows * jth256::kCols;
  constexpr uint32_t kCols = jth256::kCols;
  for (uint32_t col = 0; col < kCols; ++col) s[col] = jth256::init_state(col, li);
  for (uint32_t row = 0; row < static_cast<uint32_t>(jth256::kRows); ++row) {
    for (uint32_t col = 0; col < kCols; ++col) {
      s[col] = jth256::row_step(s[col], lw[row * kCols + col] ^ tw);
    }
  }
}

// The lane fold of lane index `idx`'s states s[128] into o[8].
void fold_lane(const uint32_t* s, uint32_t idx, uint32_t* o) {
  for (uint32_t k = 0; k < static_cast<uint32_t>(jth256::kDigestWords); ++k) {
    uint32_t acc = jth256::fold_seed(idx, k);
    for (uint32_t gi = 0; gi < static_cast<uint32_t>(jth256::kGroups); ++gi) {
      acc = jth256::fold_step(acc, s[gi * jth256::kDigestWords + k], gi);
    }
    o[k] = acc;
  }
}

const uint32_t* words_u32(const torch::Tensor& words) {
  return reinterpret_cast<const uint32_t*>(words.data_ptr<int32_t>());
}

}  // namespace

torch::Tensor row_chain(torch::Tensor words, int64_t m, int64_t tweak,
                        int64_t lane_offset) {
  check_words(words, m);
  const int64_t n_lanes = words.size(0);
  auto out = torch::empty({n_lanes, jth256::kCols}, words.options());
  uint32_t* o = reinterpret_cast<uint32_t*>(out.data_ptr<int32_t>());
  for (int64_t lane = 0; lane < n_lanes; ++lane) {
    chain_lane(words_u32(words), lane, m, static_cast<uint32_t>(tweak),
               static_cast<uint32_t>(lane_offset), o + lane * jth256::kCols);
  }
  return out;
}

torch::Tensor lane_digests(torch::Tensor words, int64_t m, int64_t tweak,
                           int64_t lane_offset) {
  check_words(words, m);
  const int64_t n_lanes = words.size(0);
  auto out = torch::empty({n_lanes, jth256::kDigestWords}, words.options());
  uint32_t* o = reinterpret_cast<uint32_t*>(out.data_ptr<int32_t>());
  uint32_t s[jth256::kCols];
  const uint32_t loff = static_cast<uint32_t>(lane_offset);
  for (int64_t lane = 0; lane < n_lanes; ++lane) {
    chain_lane(words_u32(words), lane, m, static_cast<uint32_t>(tweak), loff, s);
    fold_lane(s, loff + static_cast<uint32_t>(lane % m), o + lane * jth256::kDigestWords);
  }
  return out;
}

torch::Tensor combine(torch::Tensor accs, torch::Tensor lane_counts,
                      torch::Tensor lengths) {
  TORCH_CHECK(accs.device().is_cpu(), "accs must lie on the CPU");
  TORCH_CHECK(accs.scalar_type() == torch::kInt32, "accs must be int32");
  TORCH_CHECK(accs.dim() == 3 && accs.size(1) >= 1 &&
                  accs.size(2) == jth256::kDigestWords,
              "accs must be (B, M, 8)");
  TORCH_CHECK(accs.is_contiguous(), "accs must be contiguous");
  const int64_t b = accs.size(0), m = accs.size(1);
  TORCH_CHECK(lane_counts.scalar_type() == torch::kInt64 && lane_counts.numel() == b &&
                  lane_counts.is_contiguous(),
              "lane_counts must be int64 (B,)");
  TORCH_CHECK(lengths.scalar_type() == torch::kInt64 && lengths.numel() == b &&
                  lengths.is_contiguous(),
              "lengths must be int64 (B,)");
  auto out = torch::empty({b, jth256::kDigestWords}, lane_counts.options());
  const uint32_t* d = reinterpret_cast<const uint32_t*>(accs.data_ptr<int32_t>());
  const int64_t* counts = lane_counts.data_ptr<int64_t>();
  const int64_t* lens = lengths.data_ptr<int64_t>();
  int64_t* o = out.data_ptr<int64_t>();
  for (int64_t i = 0; i < b; ++i) {
    const int64_t c = counts[i];
    const uint32_t live = c <= 0 ? 0u : (c >= m ? static_cast<uint32_t>(m)
                                                : static_cast<uint32_t>(c));
    for (uint32_t k = 0; k < static_cast<uint32_t>(jth256::kDigestWords); ++k) {
      o[i * jth256::kDigestWords + k] = jth256::finish_word(
          d + i * m * jth256::kDigestWords, jth256::kDigestWords, live,
          static_cast<uint32_t>(lens[i]), k);
    }
  }
  return out;
}

// jth256_block_digests: the lane digests of B whole blocks of m lanes, then
// each block's combine over its live lanes (finish_word), in that order.
torch::Tensor block_digests(torch::Tensor words, int64_t m, torch::Tensor lane_counts,
                            torch::Tensor lengths, int64_t tweak) {
  check_words(words, m);
  TORCH_CHECK(words.size(0) % m == 0, "words must hold whole blocks of m lanes");
  auto accs = lane_digests(words, m, tweak, 0);
  return combine(accs.view({words.size(0) / m, m, jth256::kDigestWords}), lane_counts,
                 lengths);
}

// compress_histogram: the sampled byte histograms of packed words (B, M,
// 128, 128), lanes [lane_offset, lane_offset + M) of each block, as int32
// (B, 256) counts.
torch::Tensor estimate_histogram(torch::Tensor words, torch::Tensor lane_counts,
                                 int64_t lane_offset) {
  TORCH_CHECK(words.device().is_cpu(), "words must lie on the CPU");
  TORCH_CHECK(words.scalar_type() == torch::kInt32, "words must be int32");
  TORCH_CHECK(words.dim() == 4 && words.size(1) >= 1 && words.size(2) == cest::kRows &&
                  words.size(3) == cest::kCols,
              "words must be (B, M, 128, 128)");
  TORCH_CHECK(words.is_contiguous(), "words must be contiguous");
  const int64_t b = words.size(0), m = words.size(1);
  TORCH_CHECK(lane_counts.scalar_type() == torch::kInt64 && lane_counts.numel() == b &&
                  lane_counts.is_contiguous(),
              "lane_counts must be int64 (B,)");
  auto out = torch::zeros({b, cest::kBins}, words.options());
  const uint32_t* w = words_u32(words);
  const int64_t* counts = lane_counts.data_ptr<int64_t>();
  int32_t* h = out.data_ptr<int32_t>();
  for (int64_t i = 0; i < b; ++i) {
    const uint32_t live = cest::counted_lanes(counts[i], lane_offset, static_cast<uint32_t>(m));
    for (int64_t l = 0; l < live; ++l) {
      const uint32_t* lane = w + (i * m + l) * cest::kLaneWords;
      for (int j = 0; j < cest::kLaneSample; ++j) {
        const uint32_t word = lane[cest::sample_offset(j)];
        for (int k = 0; k < 4; ++k) ++h[i * cest::kBins + cest::byte_of(word, k)];
      }
    }
  }
  return out;
}

// compress_entropy: int32 (B, 256) counts -> float32 (B,) advisories, the
// terms summed in the kernel's order.
torch::Tensor estimate_entropy(torch::Tensor hist) {
  TORCH_CHECK(hist.device().is_cpu(), "hist must lie on the CPU");
  TORCH_CHECK(hist.scalar_type() == torch::kInt32 && hist.dim() == 2 &&
                  hist.size(1) == cest::kBins && hist.is_contiguous(),
              "hist must be contiguous int32 (B, 256)");
  const int64_t b = hist.size(0);
  auto out = torch::empty({b}, hist.options().dtype(torch::kFloat32));
  const uint32_t* h = reinterpret_cast<const uint32_t*>(hist.data_ptr<int32_t>());
  float* o = out.data_ptr<float>();
  std::vector<float> terms(cest::kBins);
  for (int64_t i = 0; i < b; ++i) {
    const uint32_t* c = h + i * cest::kBins;
    uint32_t total = 0;
    for (int k = 0; k < cest::kBins; ++k) total += c[k];
    for (int k = 0; k < cest::kBins; ++k) terms[k] = cest::entropy_term(c[k], total);
    o[i] = cest::advisory(cest::reduce256(terms.data()));
  }
  return out;
}

// jth256_block_digests_estimate: block_digests' digests, and the advisories
// of the same words from the sample the chain bins as it reads it (a lane
// at or past its block's lane count adds nothing), in the kernel's order.
std::tuple<torch::Tensor, torch::Tensor> block_digests_estimate(
    torch::Tensor words, int64_t m, torch::Tensor lane_counts, torch::Tensor lengths,
    int64_t tweak) {
  check_words(words, m);
  TORCH_CHECK(words.size(0) % m == 0, "words must hold whole blocks of m lanes");
  const int64_t n_lanes = words.size(0), b = n_lanes / m;
  TORCH_CHECK(lane_counts.scalar_type() == torch::kInt64 && lane_counts.numel() == b &&
                  lane_counts.is_contiguous(),
              "lane_counts must be int64 (B,)");
  auto accs = torch::empty({n_lanes, jth256::kDigestWords}, words.options());
  auto hist = torch::zeros({b, cest::kBins}, words.options());
  uint32_t* o = reinterpret_cast<uint32_t*>(accs.data_ptr<int32_t>());
  uint32_t* h = reinterpret_cast<uint32_t*>(hist.data_ptr<int32_t>());
  const int64_t* counts = lane_counts.data_ptr<int64_t>();
  uint32_t s[jth256::kCols], lane_hist[cest::kBins];
  for (int64_t lane = 0; lane < n_lanes; ++lane) {
    std::fill(lane_hist, lane_hist + cest::kBins, 0u);
    chain_lane(words_u32(words), lane, m, static_cast<uint32_t>(tweak), 0u, s, lane_hist);
    fold_lane(s, static_cast<uint32_t>(lane % m), o + lane * jth256::kDigestWords);
    const int64_t i = lane / m;
    if (static_cast<uint32_t>(lane % m) <
        cest::counted_lanes(counts[i], 0, static_cast<uint32_t>(m))) {
      for (int k = 0; k < cest::kBins; ++k) h[i * cest::kBins + k] += lane_hist[k];
    }
  }
  auto digests = combine(accs.view({b, m, jth256::kDigestWords}), lane_counts, lengths);
  return {digests, estimate_entropy(hist)};
}

// jth256_block_cta_digests_estimate (and, in its digests,
// jth256_block_cta_digests): a block of m <= 8 lanes at a time, as one CTA
// runs it. The block's sample is gathered apart from the chain, all m
// lanes' words as read (cest::gather_sample), and the live lanes' (below
// the block's lane count, clamped to [0, m]) binned into the block's one
// histogram (cest::bin_sample); only the live lanes are chained; their
// fold digests, then the combine over them and the entropy of the
// histogram.
std::tuple<torch::Tensor, torch::Tensor> block_cta_digests_estimate(
    torch::Tensor words, int64_t m, torch::Tensor lane_counts, torch::Tensor lengths,
    int64_t tweak) {
  constexpr int kMaxLanes = 8;
  check_words(words, m);
  TORCH_CHECK(m <= kMaxLanes, "a one-CTA block holds at most 8 lanes");
  TORCH_CHECK(words.size(0) % m == 0, "words must hold whole blocks of m lanes");
  const int64_t b = words.size(0) / m;
  TORCH_CHECK(lane_counts.scalar_type() == torch::kInt64 && lane_counts.numel() == b &&
                  lane_counts.is_contiguous(),
              "lane_counts must be int64 (B,)");
  TORCH_CHECK(lengths.scalar_type() == torch::kInt64 && lengths.numel() == b &&
                  lengths.is_contiguous(),
              "lengths must be int64 (B,)");
  auto digests = torch::empty({b, jth256::kDigestWords}, lane_counts.options());
  auto hist = torch::zeros({b, cest::kBins}, words.options());
  int64_t* o = digests.data_ptr<int64_t>();
  uint32_t* h = reinterpret_cast<uint32_t*>(hist.data_ptr<int32_t>());
  const int64_t* counts = lane_counts.data_ptr<int64_t>();
  const int64_t* lens = lengths.data_ptr<int64_t>();
  std::vector<uint32_t> lane_digests(m * jth256::kDigestWords);
  uint32_t s[jth256::kCols], sample[kMaxLanes * cest::kLaneSample];
  const uint32_t lanes = static_cast<uint32_t>(m);
  for (int64_t i = 0; i < b; ++i) {
    const uint32_t live = cest::counted_lanes(counts[i], 0, lanes);
    cest::gather_sample(sample, words_u32(words) + i * m * cest::kLaneWords,
                        lanes * cest::kLaneSample, 0, 1);
    cest::bin_sample(h + i * cest::kBins, sample, live * cest::kLaneSample, 0, 1);
    for (uint32_t li = 0; li < live; ++li) {
      chain_lane_cta(words_u32(words), i * m + li, li, static_cast<uint32_t>(tweak), s);
      fold_lane(s, li, lane_digests.data() + li * jth256::kDigestWords);
    }
    for (uint32_t k = 0; k < static_cast<uint32_t>(jth256::kDigestWords); ++k) {
      o[i * jth256::kDigestWords + k] = jth256::finish_word(
          lane_digests.data(), jth256::kDigestWords, live, static_cast<uint32_t>(lens[i]), k);
    }
  }
  return {digests, estimate_entropy(hist)};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("row_chain", &row_chain, "JTH-256 row chain on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("tweak"),
          pybind11::arg("lane_offset") = 0);
  mod.def("lane_digests", &lane_digests,
          "JTH-256 row chain and lane fold on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("tweak"),
          pybind11::arg("lane_offset") = 0);
  mod.def("combine", &combine, "JTH-256 per-block combine on the CPU (twin)",
          pybind11::arg("accs"), pybind11::arg("lane_counts"),
          pybind11::arg("lengths"));
  mod.def("block_digests", &block_digests,
          "JTH-256 row chain, lane fold and combine of whole blocks on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("lane_counts"),
          pybind11::arg("lengths"), pybind11::arg("tweak") = 0);
  mod.def("estimate_histogram", &estimate_histogram,
          "Sampled byte histograms of packed words on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("lane_counts"),
          pybind11::arg("lane_offset") = 0);
  mod.def("estimate_entropy", &estimate_entropy,
          "Entropy advisories of byte histograms on the CPU (twin)", pybind11::arg("hist"));
  mod.def("block_digests_estimate", &block_digests_estimate,
          "Block digests and compressibility advisories in one pass on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("lane_counts"),
          pybind11::arg("lengths"), pybind11::arg("tweak") = 0);
  mod.def("block_cta_digests_estimate", &block_cta_digests_estimate,
          "Block digests and advisories of short blocks, a block at a time as one CTA "
          "runs it, on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("lane_counts"),
          pybind11::arg("lengths"), pybind11::arg("tweak") = 0);
}
