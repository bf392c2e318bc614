// CPU twin of jth256_row_chain.cu: the same per-lane chain, built with g++
// from the same jth256_step.cuh, so the CPU tests can hold the arithmetic
// the card runs against the JAX package (no nvcc is needed to build it).
#include <torch/extension.h>

#include "jth256_step.cuh"

torch::Tensor row_chain(torch::Tensor words, int64_t m, int64_t tweak,
                        int64_t lane_offset) {
  TORCH_CHECK(words.device().is_cpu(), "words must lie on the CPU");
  TORCH_CHECK(words.scalar_type() == torch::kInt32, "words must be int32");
  TORCH_CHECK(words.dim() == 3 && words.size(1) == jth256::kRows &&
                  words.size(2) == jth256::kCols,
              "words must be (L, 128, 128)");
  TORCH_CHECK(words.is_contiguous(), "words must be contiguous");
  TORCH_CHECK(m >= 1, "m must be >= 1");
  const int64_t n_lanes = words.size(0);
  auto out = torch::empty({n_lanes, jth256::kCols}, words.options());
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words.data_ptr<int32_t>());
  uint32_t* o = reinterpret_cast<uint32_t*>(out.data_ptr<int32_t>());
  const uint32_t tw = static_cast<uint32_t>(tweak);
  const uint32_t loff = static_cast<uint32_t>(lane_offset);
  for (int64_t lane = 0; lane < n_lanes; ++lane) {
    const uint32_t* lw = w + lane * jth256::kRows * jth256::kCols;
    for (uint32_t col = 0; col < static_cast<uint32_t>(jth256::kCols); ++col) {
      uint32_t s =
          jth256::init_state(col, loff + static_cast<uint32_t>(lane % m));
      for (int r = 0; r < jth256::kRows; ++r) {
        s = jth256::row_step(s, lw[r * jth256::kCols + col] ^ tw);
      }
      o[lane * jth256::kCols + col] = s;
    }
  }
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("row_chain", &row_chain, "JTH-256 row chain on the CPU (twin)",
          pybind11::arg("words"), pybind11::arg("m"), pybind11::arg("tweak"),
          pybind11::arg("lane_offset") = 0);
}
