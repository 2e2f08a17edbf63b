// Host build of the device prologue's per-row code (prologue_ops.cuh), for
// the CPU tests only: the same loops as the kernels of prologue.cu (the
// scatter over every nonzero, then the row transform in place, the size bits
// and the op widening over every row), so that the functions the kernels
// run are checked against the JAX package on a machine without a GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libprologue_host.so prologue_host.cpp
#include <string.h>

#include "prologue_ops.cuh"

// Sparse-blob form: the blob's sections (ops3 (nrows, 3), size-bit words,
// idx (B, nnzb), v32 (B, nnzb / 2)) -> ops (nrows, 4) and resid (nrows, 64).
extern "C" void mobi_prologue_sblob_host(const int32_t* ops3, const int32_t* sbits,
                                         const int32_t* idx, const int32_t* v32,
                                         long long B, long long nnzb, long long nrows,
                                         int32_t* ops, int32_t* resid) {
  memset(resid, 0, (size_t)nrows * 64 * sizeof(int32_t));
  const int64_t rows64 = nrows / B * 64;
  for (int64_t i = 0; i < (int64_t)B * nnzb; ++i)
    mobi_scatter_one(resid, idx, v32, i, nnzb, rows64);
  for (int64_t r = 0; r < nrows; ++r) {
    mobi_residual_row(resid + r * 64, mobi_row_size(sbits, r), resid + r * 64);
    mobi_unpack_op3(ops3 + r * 3, ops + r * 4);
  }
}

// Dense form: coefs (n, 64) and sizes (n,) -> resid (n, 64).
extern "C" void mobi_residual_rows_host(const int32_t* coefs, const int32_t* sizes,
                                        int32_t* resid, long long n) {
  for (int64_t r = 0; r < n; ++r) mobi_residual_row(coefs + r * 64, sizes[r], resid + r * 64);
}
