// Host build of the SAD volume's code (sad_ops.cuh), for the CPU tests only:
// K7's block run block by block, its stage and then each of its threads, so
// that the code the kernel runs is checked against the JAX package on a
// machine without a GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libsad_host.so sad_host.cpp
#include <vector>

#include "sad_ops.cuh"

// K7's operands (see sad.cu).  Returns 0, or 1 (nothing written) for sizes
// the kernel refuses.
extern "C" int mobi_sad8_volume_host(const int32_t* cur, const int32_t* refs, int32_t* vol,
                                     long long H, long long W, long long R, long long r) {
  if (!mobi_sad_sizes_ok(H, W, R, r)) return 1;
  const MobiSadArgs a{cur, refs, vol, (int)H, (int)W, (int)R, (int)r};
  std::vector<int32_t> row(mobi_sad_smem_bytes((int)W, (int)r) / sizeof(int32_t));
  const int nt = mobi_sad_groups((int)W) * (int)(W / 8);
  for (int ri = 0; ri < R; ++ri)
    for (int dy = 0; dy <= 2 * r; ++dy)
      for (int by = 0; by < H / 8; ++by) {
        mobi_sad_stage(a, by, dy, ri, 0, 1, row.data());
        for (int t = 0; t < nt; ++t) mobi_sad_thread(a, by, dy, ri, t, row.data());
      }
  return 0;
}
