// Host build of the wavefront engine's GOP decode (wavefront_ops.cuh), for
// the CPU tests only: K6's phases run stream by stream, round by round,
// and in each phase the cluster's C blocks one after another (the card's
// cluster barrier falls between phases), so that the code the kernel runs
// is checked against the JAX package on a machine without a GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libwavefront_host.so wavefront_host.cpp
#include <memory>

#include "wavefront_ops.cuh"

// K6's operands (see wavefront.cu; desc holds host addresses).  Returns
// 0, or 1 (nothing written) for sizes the kernel refuses.
extern "C" int mobi_wavefront_gop_host(int32_t* ring, const long long* desc,
                                       const uint8_t* tables, int32_t* fa, int32_t* fb,
                                       int32_t* ires, long long ires_stride, int32_t* klev,
                                       int lmax, int32_t* ovf, long long ovf_stride,
                                       uint8_t* out8, int32_t* out32, long long B, int H, int S,
                                       int F, int head, int commit, int C) {
  if (!mobi_wf_gop_ok(desc, B, H, S, F, head, commit, C, lmax, ires_stride, ovf_stride))
    return 1;
  const MobiWfArgs a{ring, desc, tables, fa, fb, ires, klev, ovf, out8, out32, B,
                     ires_stride, ovf_stride, lmax, H, S, F, head, commit, C};
  std::unique_ptr<MobiWfShared> sh(new MobiWfShared());
  for (long long b = 0; b < B; ++b) {
    for (int r = 0; r < C; ++r) mobi_wf_init<1>(a, b, r, 0, *sh);
    for (int f = 0; f < F; ++f) {
      const MobiWfRound rd = mobi_wf_round(desc, f);
      const int hd = mobi_wf_head(head, f);
      for (int r = 0; r < C; ++r) mobi_wf_phase_mc<1>(a, rd, b, hd, r, 0, *sh);
      for (int r = 0; r < C; ++r) mobi_wf_phase_resid<1>(a, rd, b, r, 0, *sh);
      mobi_wf_phase_levels<1>(a, rd, b, 0, *sh);
      for (int r = 0; r < C; ++r) mobi_wf_phase_commit<1>(a, f, b, hd, r, 0);
    }
  }
  return 0;
}
