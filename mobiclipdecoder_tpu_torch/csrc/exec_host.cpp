// Host build of the executor's per-op logic (exec_ops.cuh), for the CPU
// tests only: the loop over thread indices in MOBI_PAR runs the kernel's
// code on the host, so its arithmetic, its plane accessor and its copies
// ahead are checked against the plain PyTorch executor before they reach a
// GPU.  Either plane form can be forced at any geometry.
//   g++ -O3 -std=c++17 -shared -fPIC -o libexec_host.so exec_host.cpp
#include <stdlib.h>

#include "exec_ops.cuh"

extern "C" int mobi_gop_executor_host_smem_bytes(int H, int S, int smem_plane) {
  return mobi_smem_bytes(H, S, smem_plane);
}

extern "C" int mobi_gop_executor_host(const int32_t* ops, const int32_t* resid,
                                      uint8_t* ring, uint8_t* frames,
                                      const uint8_t* tabs, int B, int nct, int F,
                                      int H, int S, int smem_plane) {
  MobiArgs a;
  a.ops = ops;
  a.resid = resid;
  a.ring = ring;
  a.frames = frames;
  a.tabs = tabs;
  a.B = B;
  a.nct = nct;
  a.F = F;
  a.H = H;
  a.S = S;
  const size_t bytes = ((size_t)mobi_smem_bytes(H, S, smem_plane) + 15) / 16 * 16;
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, bytes));
  if (smem == nullptr) return 1;
  for (int b = 0; b < B; ++b) {
    if (smem_plane)
      mobi_run_stream<true>(a, b, smem);
    else
      mobi_run_stream<false>(a, b, smem);
  }
  free(smem);
  return 0;
}
