// Host stand-in for the cluster part of cooperative_groups (see
// cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::rank; }
  void sync() const { emu::cl->bar->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    const std::ptrdiff_t off = (unsigned char*)p - emu::cl->smem[emu::rank];
    return (T*)(emu::cl->smem[r] + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
