// The cost of one grid-wide barrier on this card, at the launch shape of
// placement_repair.cu: a cooperative launch of 1,024-thread blocks (the
// caller passes the repair kernel's block count) that runs `syncs`
// cooperative_groups grid barriers and nothing else. chip_smoke.py times
// it at two counts; the difference over the count is one barrier, the
// fixed cost the repair kernel pays twice a round. No path of the port
// launches it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024, 1) grid_barrier_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < syncs; ++k) grid.sync();
}

extern "C" int grid_barrier_launch(int syncs, int blocks, void* stream) {
  void* args[] = {&syncs};
  return (int)cudaLaunchCooperativeKernel((const void*)grid_barrier_kernel,
                                          dim3(blocks), dim3(1024), args, 0,
                                          (cudaStream_t)stream);
}
