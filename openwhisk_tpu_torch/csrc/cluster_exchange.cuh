// The cluster-wide minimum of two packed (key << 32 | idx) values a thread,
// with no cluster barrier: the exchange that csrc/placement_scan.cu runs
// once a request, and that csrc/cluster_barrier.cu times alone.
//
// Each warp reduces with redux.sync, each block over its warps through
// shared memory (one __syncthreads); warp 0 of each block then writes the
// block's two minima into every block's inbox with st.async, whose
// completion counts bytes on the receiving block's mbarrier; every thread
// waits on its own block's mbarrier and each warp reduces the C minima
// itself. Two inboxes and mbarriers, by the parity of the count of
// exchanges, suffice: a block writes an exchange's values only once every
// block has sent the one before, which each sends only after the
// __syncthreads that all its threads pass once they have read the one
// before that. Unsigned min is order-free, so the result is deterministic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int MAX_CLUSTER = 16;

// the packed minimum over the warp: the key word by one redux.sync, then
// the index word among the lanes that hold that key
__device__ __forceinline__ uint64_t warp_min_packed(uint64_t v) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned mh = __reduce_min_sync(0xffffffffu, hi);
  const unsigned ml =
      __reduce_min_sync(0xffffffffu, hi == mh ? (unsigned)v : 0xffffffffu);
  return ((uint64_t)mh << 32) | ml;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of shared variable `p` in block `rank` of the cluster
__device__ __forceinline__ uint32_t remote_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// this block's arrival for the phase: it completes once `bytes` more have
// landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "  selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void send16(uint32_t dst, uint64_t x, uint64_t y,
                                       uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u64 [%0], "
      "{%1, %2}, [%3];"
      :: "r"(dst), "l"(x), "l"(y), "r"(bar) : "memory");
}

// The exchange's shared memory, in each block.
struct ExchangeSmem {
  uint64_t wpart[32][2];                          // warp minima
  alignas(16) uint64_t inbox[2][MAX_CLUSTER][2];  // every block's minima
  alignas(8) uint64_t mbar[2];                    // counts the inbox bytes
};

// Thread 0 of each block, before the first exchange; the caller then syncs
// the cluster before any block exchanges.
__device__ __forceinline__ void exchange_init(ExchangeSmem& x) {
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&x.mbar[q])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Every thread of the cluster calls this with the same `count` (the
// exchanges before this one); on return every thread holds the cluster's
// minima of best and fbest.
__device__ __forceinline__ void cluster_min(ExchangeSmem& x, uint64_t& best,
                                            uint64_t& fbest, int count,
                                            int rank, int nblocks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int q = count & 1;
  if (__any_sync(0xffffffffu, (best & fbest) != ~0ull)) {
    best = warp_min_packed(best);
    fbest = warp_min_packed(fbest);
  }
  if (lane == 0) {
    x.wpart[warp][0] = best;
    x.wpart[warp][1] = fbest;
  }
  // also: every warp of this block has read the inbox of this parity
  __syncthreads();
  if (warp == 0) {
    best = warp_min_packed(lane < nwarps ? x.wpart[lane][0] : ~0ull);
    fbest = warp_min_packed(lane < nwarps ? x.wpart[lane][1] : ~0ull);
    if (lane == 0) mbar_expect(&x.mbar[q], 16 * nblocks);
    if (lane < nblocks)
      send16(remote_addr(&x.inbox[q][rank][0], lane), best, fbest,
             remote_addr(&x.mbar[q], lane));
  }
  mbar_wait(&x.mbar[q], (count >> 1) & 1);
  uint64_t rb = ~0ull, rf = ~0ull;
  if (lane < nblocks) {
    rb = x.inbox[q][lane][0];
    rf = x.inbox[q][lane][1];
  }
  best = warp_min_packed(rb);
  fbest = warp_min_packed(rf);
}
