// Host build of the wavefront engine's frame round (wavefront_ops.cuh), for
// the CPU tests only: K6's per-stream function run stream by stream, so
// that the code the kernel runs is checked against the JAX package on a
// machine without a GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libwavefront_host.so wavefront_host.cpp
#include <memory>

#include "wavefront_ops.cuh"

// K6's operands (see wavefront.cu) -> out (B, HH, S).  Returns 0, or 1
// (nothing written) for sizes the kernel refuses.
extern "C" int mobi_wavefront_frame_host(const int32_t* ring, const int32_t* mc,
                                         const int32_t* resid, const int32_t* rcoef,
                                         const int32_t* iops, const int32_t* icoef,
                                         const int32_t* seqmap, const int32_t* n_levels,
                                         const uint8_t* tables, int32_t* out, int32_t* stage,
                                         long long B, int H, int S, int M, int N, int L, int K,
                                         int SR) {
  if (!mobi_wf_sizes_ok(B, H, S, M, N, L, K, SR)) return 1;
  const MobiWfArgs a{ring, mc, resid, rcoef, iops, icoef, seqmap, n_levels, tables, out, stage,
                     H, S, M, N, L, K, SR};
  std::unique_ptr<MobiWfShared> sh(new MobiWfShared());
  for (long long b = 0; b < B; ++b) mobi_wf_stream<1>(a, b, 0, *sh);
  return 0;
}
