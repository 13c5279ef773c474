// Host shim of cooperative_groups: the grid barrier of a cooperative launch
// (cudaLaunchCooperativeKernel in cuda_runtime.h here).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { g_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
