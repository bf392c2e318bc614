// JTH-256 arithmetic, shared by the CUDA kernels (jth256_row_chain.cu,
// jth256_combine.cu) and their CPU twin (jth256_twin.cpp), so that the
// twin, which the CPU tests build with g++, checks the very source that
// nvcc compiles for the card.
//
// Spec: juicefs_tpu_torch/gpu/jth256.py (jth256, hash_packed_np).
// Reference: juicefs_tpu/tpu/hash_jax.py:57-128.
//
// Row chain, per lane: column j starts at s = P5 ^ j*P1 ^ lane*P3 (lane:
// the lane's index within its block, offset by the lanes held on other
// devices), then 128 row steps
//   s = (s ^ w) * P1;  s = rotl(s, 13) * P2;  s ^= s >> 15
// Lane fold: the 128 states are 16 groups of 8; accumulator k starts at
// P4 ^ lane*P2 ^ k*P1 and takes, for gi = 0..15, the state of column
// gi*8 + k:  acc = rotl((acc ^ s[gi*8 + k]) * P3, 11) + gi*P5.
// Combine, per block: h[k] starts at IV[k]; for each live lane li in
// order, h = rotl((h ^ acc_li[k]) * P2, 17) + li*P1; then
// h ^= len + k*P4 and the murmur3 finalizer.
// All arithmetic is on uint32_t: it wraps mod 2^32 as the spec requires
// (signed overflow would be undefined behaviour).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

namespace jth256 {

constexpr int kRows = 128;
constexpr int kCols = 128;
constexpr uint32_t kP1 = 0x9E3779B1u;
constexpr uint32_t kP2 = 0x85EBCA77u;
constexpr uint32_t kP3 = 0xC2B2AE3Du;
constexpr uint32_t kP4 = 0x27D4EB2Fu;
constexpr uint32_t kP5 = 0x165667B1u;
constexpr uint32_t kFM1 = 0x85EBCA6Bu;
constexpr uint32_t kFM2 = 0xC2B2AE35u;
constexpr int kDigestWords = 8;                  // k = col mod 8
constexpr int kGroups = kCols / kDigestWords;    // gi = col / 8

__host__ __device__ inline uint32_t rotl32(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

// Initial state of column `col` of lane `lane` (lane = lane_offset +
// local lane mod m, wrapping mod 2^32).
__host__ __device__ inline uint32_t init_state(uint32_t col, uint32_t lane) {
  return kP5 ^ (col * kP1) ^ (lane * kP3);
}

// One row step; `w` already carries the tweak (w = W[r][col] ^ tweak).
__host__ __device__ inline uint32_t row_step(uint32_t s, uint32_t w) {
  s = (s ^ w) * kP1;
  s = rotl32(s, 13) * kP2;
  return s ^ (s >> 15);
}

// Seed of accumulator k of lane `lane` (the same lane index as
// init_state's).
__host__ __device__ inline uint32_t fold_seed(uint32_t lane, uint32_t k) {
  return kP4 ^ (lane * kP2) ^ (k * kP1);
}

// One fold step; `g` is the final state of column gi*8 + k.
__host__ __device__ inline uint32_t fold_step(uint32_t acc, uint32_t g,
                                              uint32_t gi) {
  return rotl32((acc ^ g) * kP3, 11) + gi * kP5;
}

// Word k of the combine's initial value (the SHA-256 IV).
__host__ __device__ inline uint32_t iv(uint32_t k) {
  switch (k) {
    case 0: return 0x6A09E667u;
    case 1: return 0xBB67AE85u;
    case 2: return 0x3C6EF372u;
    case 3: return 0xA54FF53Au;
    case 4: return 0x510E527Fu;
    case 5: return 0x9B05688Cu;
    case 6: return 0x1F83D9ABu;
    default: return 0x5BE0CD19u;
  }
}

// One combine step over the digest word `d` of live lane `li`.
__host__ __device__ inline uint32_t combine_step(uint32_t h, uint32_t d,
                                                 uint32_t li) {
  return rotl32((h ^ d) * kP2, 17) + li * kP1;
}

// The block's byte length (mod 2^32) mixed into word k.
__host__ __device__ inline uint32_t length_mix(uint32_t h, uint32_t len,
                                               uint32_t k) {
  return h ^ (len + k * kP4);
}

// murmur3 finalizer.
__host__ __device__ inline uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= kFM1;
  x ^= x >> 13;
  x *= kFM2;
  return x ^ (x >> 16);
}

// Digest word k of a block whose m per-lane digests lie at d[li*stride + k]:
// the combine over its first `live` lanes, the length mix and fmix.
__host__ __device__ inline uint32_t finish_word(const uint32_t* d,
                                                long long stride,
                                                uint32_t live, uint32_t len,
                                                uint32_t k) {
  uint32_t h = iv(k);
#ifdef __CUDA_ARCH__
#pragma unroll 8  // loads of the next lanes issue ahead of the dependent chain
#endif
  for (uint32_t li = 0; li < live; ++li) {
    h = combine_step(h, d[li * stride + k], li);
  }
  return fmix(length_mix(h, len, k));
}

}  // namespace jth256
