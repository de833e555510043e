// The fixed cost the scan pays once a request, at the launch shape of
// placement_scan.cu: one thread-block cluster of 1,024-thread blocks (the
// caller passes the scan's cluster size) that runs `count` times one of
//   mode 0  a cooperative_groups cluster barrier;
//   mode 1  the scan's exchange of two packed minima a thread
//           (cluster_exchange.cuh: block reduce, st.async, mbarrier);
//   mode 2  the scan's first design of that exchange: warp shuffles, a
//           shared-memory atomicMin, a cluster barrier and a read of every
//           block's minima through distributed shared memory;
// and nothing else. chip_smoke.py times each at two counts; the
// difference over the count is the cost of one. No path of the port
// launches it.
#include <cooperative_groups.h>

#include "cluster_exchange.cuh"
#include "placement_common.cuh"

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024, 1)
cluster_barrier_kernel(int count, int mode, int* sink) {
  __shared__ ExchangeSmem xs;
  __shared__ unsigned long long part[3][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int rank = (int)cluster.block_rank();
  const int nblocks = (int)cluster.num_blocks();
  const unsigned g = rank * blockDim.x + threadIdx.x;
  exchange_init(xs);
  if (threadIdx.x < 6) part[threadIdx.x >> 1][threadIdx.x & 1] = ~0ull;
  cluster.sync();
  uint64_t acc = 0;
  for (int k = 0; k < count; ++k) {
    // minima that change every round, so no round can be skipped
    uint64_t best = ((uint64_t)((g * 2654435761u) ^ k) << 32) | g;
    uint64_t fbest = ((uint64_t)(g ^ (k * 40503u)) << 32) | g;
    if (mode == 0) {
      cluster.sync();
    } else if (mode == 1) {
      cluster_min(xs, best, fbest, k, rank, nblocks);
    } else {
      const int q = k % 3;
      best = warp_min_u64(best);
      fbest = warp_min_u64(fbest);
      if (lane == 0) {
        atomicMin(&part[q][0], (unsigned long long)best);
        atomicMin(&part[q][1], (unsigned long long)fbest);
      }
      cluster.sync();
      if (threadIdx.x == 0)
        part[(q + 2) % 3][0] = part[(q + 2) % 3][1] = ~0ull;
      uint64_t rb = ~0ull, rf = ~0ull;
      if (lane < nblocks) {
        const unsigned long long* rp =
            cluster.map_shared_rank(&part[q][0], lane);
        rb = rp[0];
        rf = rp[1];
      }
      best = warp_min_u64(rb);
      fbest = warp_min_u64(rf);
    }
    acc += best ^ fbest;
  }
  cluster.sync();
  if (acc == 1) *sink = 1;  // keeps the rounds' results live
}

extern "C" int cluster_barrier_launch(int count, int blocks, int mode,
                                      int* sink, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(1024);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, count, mode,
                                 sink);
}
