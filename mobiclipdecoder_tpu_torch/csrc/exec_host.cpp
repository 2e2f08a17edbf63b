// Host build of the executor's per-op logic (exec_ops.cuh), for the CPU
// tests only: the loop over thread indices in MOBI_PAR runs the kernel's
// code on the host, so its arithmetic is checked against the plain PyTorch
// executor before it reaches a GPU.
//   g++ -O2 -std=c++17 -shared -fPIC -o libexec_host.so exec_host.cpp
#include "exec_ops.cuh"

extern "C" int mobi_gop_executor_host(const int32_t* ops, const int32_t* resid,
                                      uint8_t* ring, uint8_t* frames,
                                      const uint8_t* tabs, int B, int nct, int F,
                                      int H, int S) {
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
  MobiShared sh;
  for (int b = 0; b < B; ++b) mobi_run_stream(a, b, &sh);
  return 0;
}
