// Runs the cost-table kernels of both routes on host threads for the CPU
// tests (tests/test_torch_dpm_cost_kernel.py), through the .cu's own launch
// functions; compiled with -DDPM_COST_SOURCE="...".
#include "cuda_runtime.h"
#include DPM_COST_SOURCE  // the .cu with its shared arrays as pointers

thread_local dim3 threadIdx, blockIdx, blockDim;
namespace emu {
thread_local Cluster* cl;
thread_local int rank;
thread_local std::barrier<>* block_bar;
thread_local Warp* warp;
}

// Each launches route ``block`` (0: warp, 1: block) and returns whether the
// warp route streams rows as 16-byte loads.
extern "C" int emu_cost_table(const int* mask, const int* sxy, int* costs,
                              int* reps, int P, int n, int m, int wrap,
                              int leg, int block) {
  emu::run_launches = true;
  if (dpm_cost_table_launch(mask, sxy, costs, reps, P, n, m, wrap, leg, block,
                            nullptr))
    return -1;
  return rows_aligned(mask, n * m);
}

extern "C" int emu_cost_table_weighted(const int* mask, const int* sxy,
                                       const float* dist, const float* weight,
                                       float* costs, int* reps, int P, int n,
                                       int m, int wrap, int leg,
                                       float overhead, int block) {
  emu::run_launches = true;
  if (dpm_cost_table_weighted_launch(mask, sxy, dist, weight, costs, reps, P,
                                     n, m, wrap, leg, overhead, block, nullptr))
    return -1;
  return rows_aligned(mask, n * m);
}
