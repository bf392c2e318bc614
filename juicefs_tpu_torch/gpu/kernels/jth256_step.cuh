// JTH-256 row-chain arithmetic, shared by the CUDA kernel
// (jth256_row_chain.cu) and its CPU twin (jth256_twin.cpp), so that the
// twin, which the CPU tests build with g++, checks the very source that
// nvcc compiles for the card.
//
// Spec: juicefs_tpu_torch/gpu/jth256.py (lane_compress). Per lane, column
// j starts at s = P5 ^ j*P1 ^ lane*P3 (lane: the lane's index within its
// block, offset by the lanes held on other devices), then 128 row steps
//   s = (s ^ w) * P1;  s = rotl(s, 13) * P2;  s ^= s >> 15
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
constexpr uint32_t kP5 = 0x165667B1u;

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

}  // namespace jth256
