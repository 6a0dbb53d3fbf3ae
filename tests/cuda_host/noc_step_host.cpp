// Runs the segmented-min routes on host threads for the CPU tests
// (tests/test_torch_noc_step_kernel.py); compiled with
// -DNOC_STEP_SOURCE="..." and called through the .cu's own launch functions
// after emu_enable_launches().
#include "cuda_runtime.h"
#include "cooperative_groups.h"
#include NOC_STEP_SOURCE  // the .cu with its shared array as a pointer

thread_local dim3 threadIdx, blockIdx, blockDim;
namespace emu {
thread_local Cluster* cl;
thread_local int rank;
thread_local std::barrier<>* block_bar;
thread_local Warp* warp;
}

extern "C" void emu_enable_launches() { emu::run_launches = true; }
