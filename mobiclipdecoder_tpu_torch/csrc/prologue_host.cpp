// Host build of the device prologue's code (prologue_ops.cuh), for the CPU
// tests only: K5's per-block function run block by block (the tile on the
// stack) and K4's row transform over every row, so that the code the
// kernels run is checked against the JAX package on a machine without a
// GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libprologue_host.so prologue_host.cpp
#include "prologue_ops.cuh"

// K5's sizes and sections: ops3 (nrows, 3), size-bit words, idx (B, nnzb),
// v32 (B, nnzb / 2) -> ops (nrows, 4) and resid (nrows, 64).  Returns 0, or
// 1 (nothing written) for sizes the kernel refuses.
extern "C" int mobi_prologue_sblob_host(const int32_t* ops3, const int32_t* sbits,
                                        const int32_t* idx, const int32_t* v32, long long B,
                                        long long nnzb, long long nrows, int32_t* ops,
                                        int32_t* resid) {
  if (!mobi_sblob_sizes_ok(B, nnzb, nrows)) return 1;
  int32_t tile[MOBI_ROWS * MOBI_PITCH];
  int range[2];
  for (long long blk = 0; blk * MOBI_ROWS < nrows; ++blk)
    mobi_sblob_block<1>(blk, 0, ops3, sbits, idx, v32, ops, resid, nrows, nrows / B, (int)nnzb,
                        tile, range);
  return 0;
}

// K4, dense form: coefs (n, 64) and sizes (n,) -> resid (n, 64).
extern "C" void mobi_residual_rows_host(const int32_t* coefs, const int32_t* sizes,
                                        int32_t* resid, long long n) {
  for (int64_t r = 0; r < n; ++r) mobi_residual_row(coefs + r * 64, sizes[r], resid + r * 64);
}
