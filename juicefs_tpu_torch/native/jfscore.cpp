// jfscore: native data-plane primitives for juicefs_tpu_torch (a copy of
// juicefs_tpu/native/jfscore.cpp).
//
// The reference implements its block data plane's hot paths natively via
// cgo (C zstd/lz4, pkg/compress/compress.go:71-120; CRC32C via Go's
// hardware-accelerated hash/crc32). This library is the rebuild's
// equivalent: hardware CRC32C and the JTH-256 content hash in C++,
// exposed through a plain C ABI consumed with ctypes (and reusable from
// any language, like the reference's libjfs C ABI in sdk/java).
//
// JTH-256 here MUST stay byte-identical to the normative numpy spec in
// juicefs_tpu_torch/gpu/jth256.py; the test suite cross-checks all
// implementations. Little-endian hosts assumed (x86-64,
// aarch64) — the word view and digest serialization are uint32-LE.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread jfscore.cpp -o libjfscore.so
// (native/__init__.py does this into build/native/ at first use)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

extern "C" {
uint32_t jfs_crc32c(const uint8_t *data, size_t n, uint32_t crc);
void jfs_jth256(const uint8_t *data, size_t n, uint8_t out[32]);
void jfs_jth256_batch(const uint8_t *const *blocks, const size_t *lens,
                      size_t count, uint8_t *outs, int threads);
int jfs_abi_version();
}

int jfs_abi_version() { return 1; }

// ---------------------------------------------------------------- CRC32C --

static uint32_t crc32c_table[8][256];
static std::atomic<bool> table_ready{false};

static void init_table() {
  if (table_ready.load(std::memory_order_acquire)) return;
  const uint32_t poly = 0x82F63B78u;  // Castagnoli, reflected
  for (int n = 0; n < 256; n++) {
    uint32_t c = (uint32_t)n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    crc32c_table[0][n] = c;
  }
  for (int n = 0; n < 256; n++) {
    uint32_t c = crc32c_table[0][n];
    for (int k = 1; k < 8; k++) {
      c = crc32c_table[0][c & 0xFF] ^ (c >> 8);
      crc32c_table[k][n] = c;
    }
  }
  table_ready.store(true, std::memory_order_release);
}

static uint32_t crc32c_sw(const uint8_t *p, size_t n, uint32_t c) {
  init_table();
  // slicing-by-8
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, p, 8);
    word ^= c;
    c = crc32c_table[7][word & 0xFF] ^ crc32c_table[6][(word >> 8) & 0xFF] ^
        crc32c_table[5][(word >> 16) & 0xFF] ^
        crc32c_table[4][(word >> 24) & 0xFF] ^
        crc32c_table[3][(word >> 32) & 0xFF] ^
        crc32c_table[2][(word >> 40) & 0xFF] ^
        crc32c_table[1][(word >> 48) & 0xFF] ^
        crc32c_table[0][(word >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) c = crc32c_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) static uint32_t crc32c_hw(const uint8_t *p,
                                                            size_t n,
                                                            uint32_t c) {
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, p, 8);
    c64 = _mm_crc32_u64(c64, word);
    p += 8;
    n -= 8;
  }
  c = (uint32_t)c64;
  while (n--) c = _mm_crc32_u8(c, *p++);
  return c;
}

static bool have_sse42() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return (c & bit_SSE4_2) != 0;
}
#endif

uint32_t jfs_crc32c(const uint8_t *data, size_t n, uint32_t crc) {
  uint32_t c = crc ^ 0xFFFFFFFFu;
#if defined(__x86_64__)
  static const bool hw = have_sse42();
  c = hw ? crc32c_hw(data, n, c) : crc32c_sw(data, n, c);
#else
  c = crc32c_sw(data, n, c);
#endif
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- JTH-256 --

static const uint32_t P1 = 0x9E3779B1u, P2 = 0x85EBCA77u, P3 = 0xC2B2AE3Du,
                      P4 = 0x27D4EB2Fu, P5 = 0x165667B1u;
static const uint32_t FM1 = 0x85EBCA6Bu, FM2 = 0xC2B2AE35u;
static const uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                               0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                               0x1F83D9ABu, 0x5BE0CD19u};

static inline uint32_t rotl32(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

// One 64 KiB lane (16384 LE words as 128x128) -> 8-word lane digest.
static void lane_compress(const uint32_t *W, uint32_t lane, uint32_t out[8]) {
  uint32_t s[128];
  const uint32_t lp3 = lane * P3;
  for (uint32_t j = 0; j < 128; j++) s[j] = P5 ^ (j * P1) ^ lp3;
  for (int r = 0; r < 128; r++) {
    const uint32_t *row = W + (size_t)r * 128;
    for (int j = 0; j < 128; j++) {  // auto-vectorizes (no cross-lane deps)
      uint32_t v = (s[j] ^ row[j]) * P1;
      v = rotl32(v, 13) * P2;
      s[j] = v ^ (v >> 15);
    }
  }
  uint32_t acc[8];
  const uint32_t lp2 = lane * P2;
  for (uint32_t k = 0; k < 8; k++) acc[k] = P4 ^ lp2 ^ (k * P1);
  for (uint32_t g = 0; g < 16; g++) {
    const uint32_t gp5 = g * P5;
    for (int k = 0; k < 8; k++) {
      uint32_t v = (acc[k] ^ s[g * 8 + k]) * P3;
      acc[k] = rotl32(v, 11) + gp5;
    }
  }
  memcpy(out, acc, 32);
}

void jfs_jth256(const uint8_t *data, size_t n, uint8_t out[32]) {
  const size_t m = n ? (n + 65535) / 65536 : 1;
  uint32_t h[8];
  memcpy(h, IV, 32);
  alignas(64) uint32_t lane_buf[16384];
  for (size_t i = 0; i < m; i++) {
    const size_t off = i * 65536;
    const size_t take = n > off ? (n - off < 65536 ? n - off : 65536) : 0;
    const uint32_t *W;
    if (take == 65536 && ((uintptr_t)(data + off) % 4 == 0)) {
      W = (const uint32_t *)(data + off);  // full aligned lane: zero-copy
    } else {
      memcpy(lane_buf, data + off, take);
      memset((uint8_t *)lane_buf + take, 0, 65536 - take);
      W = lane_buf;
    }
    uint32_t acc[8];
    lane_compress(W, (uint32_t)i, acc);
    const uint32_t ip1 = (uint32_t)i * P1;
    for (int k = 0; k < 8; k++) {
      uint32_t v = (h[k] ^ acc[k]) * P2;
      h[k] = rotl32(v, 17) + ip1;
    }
  }
  for (uint32_t k = 0; k < 8; k++) {
    uint32_t v = h[k] ^ ((uint32_t)n + k * P4);
    v ^= v >> 16;
    v *= FM1;
    v ^= v >> 13;
    v *= FM2;
    v ^= v >> 16;
    h[k] = v;
  }
  memcpy(out, h, 32);  // LE host: matches uint32-LE serialization
}

void jfs_jth256_batch(const uint8_t *const *blocks, const size_t *lens,
                      size_t count, uint8_t *outs, int threads) {
  if (threads <= 1 || count <= 1) {
    for (size_t i = 0; i < count; i++)
      jfs_jth256(blocks[i], lens[i], outs + i * 32);
    return;
  }
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= count) return;
      jfs_jth256(blocks[i], lens[i], outs + i * 32);
    }
  };
  unsigned nt = std::min<size_t>(threads, count);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto &t : pool) t.join();
}
