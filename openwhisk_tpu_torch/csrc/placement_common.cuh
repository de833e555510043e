// Shared device helpers of the placement kernels (placement_scan.cu,
// placement_repair.cu). Integer arithmetic only: every result is exact and
// bit-identical to the plain PyTorch version in ops/placement.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Fields of the packed request matrix int32[9, B] (row r at reqs + r * B),
// the layout of the balancer's packed step buffer.
enum ReqRow {
  R_OFFSET = 0, R_SIZE, R_HOME, R_STEP_INV, R_NEED, R_SLOT, R_MAX_CONC,
  R_RAND, R_VALID, R_ROWS
};

// Floor modulo (jnp.mod / torch.remainder): non-negative for m > 0.
__device__ __forceinline__ int floormod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Floor division by a positive constant (jnp `//`).
__device__ __forceinline__ int floordiv(int a, int d) {
  int q = a / d;
  return (q * d > a) ? q - 1 : q;
}

// Wrapping int32 product and sum, as the JAX/torch int32 arithmetic wraps.
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// The books are read with ld.global.cg (cached in L2, not in the SM's L1):
// they are written during the launch, by plain stores (scan) or by
// atomics (repair), and every read must see those writes.
__device__ __forceinline__ int load_book(const int* p) { return __ldcg(p); }

// (a % m) * b % m with the JAX package's split b = hi*512 + lo, which keeps
// every intermediate under 2^26 for b < m <= 2^17 (ops/placement.py _mulmod).
__device__ __forceinline__ int mulmod(int a, int b, int m) {
  a = floormod(a, m);
  int hi = floordiv(b, 512);
  int lo = b - hi * 512;
  int t = floormod(wmul(a, hi), m);
  t = floormod(wmul(t, 512), m);
  return floormod(t + wmul(a, lo), m);
}

// Packed argmin key: a signed int32 key in the high word (offset so that
// unsigned order is signed order), the invoker index in the low word, so
// one unsigned min gives the smallest key and, among ties, the lowest
// index — the Pallas kernels' `min(where(key == kmin, idx, big))`.
__device__ __forceinline__ uint64_t pack_key(int key, int idx) {
  return ((uint64_t)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)idx;
}
__device__ __forceinline__ int key_of(uint64_t p) {
  return (int)((unsigned)(p >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int idx_of(uint64_t p) {
  return (int)(unsigned)(p & 0xffffffffu);
}

__device__ __forceinline__ uint64_t warp_min_u64(uint64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    uint64_t w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}
