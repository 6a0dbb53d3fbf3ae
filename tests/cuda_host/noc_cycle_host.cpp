// Runs the cluster cycle kernel on host threads for the CPU tests
// (tests/test_torch_noc_cycle.py); compiled with -DNOC_CYCLE_SOURCE="...".
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "cooperative_groups.h"
int smem[1];  // the block kernel's extern shared array (never run here)
#include NOC_CYCLE_SOURCE  // the .cu with its shared-memory array as a pointer

thread_local dim3 threadIdx, blockIdx, blockDim;
namespace emu {
thread_local Cluster* cl;
thread_local int rank;
thread_local std::barrier<>* block_bar;
thread_local Warp* warp;
}

// Run the cluster kernel over every instance, one cluster after another,
// each CTA's threads as host threads; returns the shared bytes per CTA.
extern "C" long emu_cluster_run(const ClArgs* args, int threads) {
  const ClArgs a = *args;
  const size_t bytes = cl_smem_carve(nullptr, a.NR, a.D, 2 * a.V, a.CC, nullptr);
  for (int b = 0; b < a.B; ++b) {
    std::vector<unsigned char*> bufs(a.K);
    for (auto& p : bufs) p = (unsigned char*)std::aligned_alloc(16, (bytes + 15) / 16 * 16);
    std::barrier<> cbar(a.K * threads);
    std::vector<std::unique_ptr<std::barrier<>>> bbar;
    for (int r = 0; r < a.K; ++r) bbar.emplace_back(new std::barrier<>(threads));
    std::vector<std::unique_ptr<emu::Warp>> warps;
    for (int w = 0; w < a.K * threads / 32; ++w) warps.emplace_back(new emu::Warp);
    emu::Cluster c{bufs.data(), &cbar};
    std::vector<std::thread> pool;
    for (int r = 0; r < a.K; ++r)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, r, t] {
          threadIdx = dim3(t); blockIdx = dim3(b * a.K + r); blockDim = dim3(threads);
          emu::cl = &c; emu::rank = r; emu::block_bar = bbar[r].get();
          emu::warp = warps[(r * threads + t) / 32].get();
          noc_cycle_cluster_kernel(a);
        });
    for (auto& th : pool) th.join();
    for (auto p : bufs) std::free(p);
  }
  return (long)bytes;
}
