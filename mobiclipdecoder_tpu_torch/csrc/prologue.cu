// Device prologue of the whole-GOP decode for Hopper (sm_90a), bound with
// ctypes: the kernels that turn an uploaded blob (or dense coefficient rows)
// into the executor's inputs, ops (B, nct, CHUNK, 4) and resid (B, nct,
// CHUNK, 64) int32.  The per-block code, what it replaces in the JAX
// package (XLA code, no pallas_call) and why the stage is bound by bytes
// are in prologue_ops.cuh.
//
//   K5 mobi_prologue_sblob  blob -> (ops, resid) in one launch, one block
//        of 128 threads per 128 rows (never two streams in one block): the
//        block finds its nonzeros in the stream's sorted index list with a
//        warp-cooperative 32-ary search, gathers them into a zeroed tile in
//        shared memory (a row's 64 words at a pitch of 65, so that a warp's
//        32 rows fall in 32 banks), each thread transforms its row there
//        with the size from the blob's size bits and widens its op row, and
//        the block writes the rows out with coalesced stores.  No fill of
//        resid beforehand and no second pass over it.
//   K4 mobi_residual_rows   the dense form of the IDCT pre-pass: coefs (N,
//        64) and sizes (N,) -> resid (N, 64), one thread per row, 128 rows
//        per block staged in shared memory the same way.
#include <cuda_runtime.h>

#include "prologue_ops.cuh"

__global__ void __launch_bounds__(MOBI_ROWS)
    mobi_prologue_sblob_kernel(const int32_t* ops3, const int32_t* sbits, const int32_t* idx,
                               const int32_t* v32, int32_t* ops, int32_t* resid,
                               long long nrows, long long rows_ps, int nnzb) {
  __shared__ int32_t tile[MOBI_ROWS * MOBI_PITCH];
  __shared__ int range[2];
  mobi_sblob_block<MOBI_ROWS>(blockIdx.x, (int)threadIdx.x, ops3, sbits, idx, v32, ops, resid,
                              nrows, rows_ps, nnzb, tile, range);
}

__global__ void __launch_bounds__(MOBI_ROWS)
    mobi_residual_rows_kernel(const int32_t* coefs, const int32_t* sizes, int32_t* resid,
                              int64_t nrows) {
  __shared__ int32_t tile[MOBI_ROWS * MOBI_PITCH];
  const int t = (int)threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * MOBI_ROWS;
  const int nr = nrows - row0 < MOBI_ROWS ? (int)(nrows - row0) : MOBI_ROWS;
  const int32_t* src = coefs + row0 * 64;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const int w = k * MOBI_ROWS + t;
    if ((w >> 6) < nr) tile[(w >> 6) * MOBI_PITCH + (w & 63)] = src[w];
  }
  __syncthreads();
  if (t < nr) mobi_residual_row(tile + t * MOBI_PITCH, sizes[row0 + t], tile + t * MOBI_PITCH);
  __syncthreads();
  int32_t* dst = resid + row0 * 64;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const int w = k * MOBI_ROWS + t;
    if ((w >> 6) < nr) dst[w] = tile[(w >> 6) * MOBI_PITCH + (w & 63)];
  }
}

// Each launcher enqueues one kernel on `stream`, allocates nothing and
// returns a CUDA error code (0 on success).  `device` is the card the
// tensors and the stream belong to: this library's runtime launches on the
// device current on the calling thread, so a launch from any other device
// is refused instead of reaching across cards.
static int mobi_check_device(int device) {
  int current = -1;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  return current == device ? 0 : (int)cudaErrorInvalidDevice;
}

static unsigned mobi_blocks(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

// K5: the blob's sections ops3 (nrows, 3), size-bit words sbits, idx (B,
// nnzb), v32 (B, nnzb / 2) -> ops (nrows, 4) and resid (nrows, 64).
extern "C" int mobi_prologue_sblob_launch(const int32_t* ops3, const int32_t* sbits,
                                          const int32_t* idx, const int32_t* v32, int32_t* ops,
                                          int32_t* resid, long long B, long long nnzb,
                                          long long nrows, int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (!mobi_sblob_sizes_ok(B, nnzb, nrows)) return (int)cudaErrorInvalidValue;
  mobi_prologue_sblob_kernel<<<mobi_blocks(nrows, MOBI_ROWS), MOBI_ROWS, 0,
                               (cudaStream_t)stream>>>(ops3, sbits, idx, v32, ops, resid, nrows,
                                                       nrows / B, (int)nnzb);
  return (int)cudaGetLastError();
}

// K4, dense form: coefs (nrows, 64) and sizes (nrows,) -> resid (nrows, 64).
extern "C" int mobi_residual_rows_launch(const int32_t* coefs, const int32_t* sizes,
                                         int32_t* resid, long long nrows, int device,
                                         void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (nrows <= 0) return (int)cudaErrorInvalidValue;
  mobi_residual_rows_kernel<<<mobi_blocks(nrows, MOBI_ROWS), MOBI_ROWS, 0,
                              (cudaStream_t)stream>>>(coefs, sizes, resid, nrows);
  return (int)cudaGetLastError();
}
