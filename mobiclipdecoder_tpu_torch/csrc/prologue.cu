// Device prologue of the whole-GOP decode for Hopper (sm_90a), bound with
// ctypes: the kernels that turn an uploaded blob (or dense coefficient rows)
// into the executor's inputs, ops (B, nct, CHUNK, 4) and resid (B, nct,
// CHUNK, 64) int32.  The per-row code, what it replaces in the JAX package
// (XLA code, no pallas_call) and why the stage is bound by bytes are in
// prologue_ops.cuh.
//
//   K3 mobi_scatter_coefs  one thread per nonzero (b, k): its int16 value
//        into a dense (B, rows * 64) int32 buffer zeroed beforehand (the
//        sparse blob path passes resid itself).  Order-free: right for any
//        order of the indices.
//   K4 mobi_residual_rows  one thread per row, 128 rows per block: the
//        block copies its rows into shared memory with coalesced loads (a
//        row's 64 words at a pitch of 65, so that a warp's 32 rows fall in
//        32 banks), each thread transforms its row there, and the block
//        writes the rows back with coalesced stores.  Its sparse-blob form
//        runs in place on the scattered resid, takes each row's size from
//        the blob's size bits and widens the row's packed op words into
//        ops; its dense form reads coefs and sizes (N,) and writes resid.
#include <cuda_runtime.h>

#include "prologue_ops.cuh"

#define MOBI_SCATTER_NT 256   // threads per block of K3
#define MOBI_ROWS 128         // rows per block of K4, one per thread
#define MOBI_PITCH 65         // words per staged row

__global__ void __launch_bounds__(MOBI_SCATTER_NT)
    mobi_scatter_coefs_kernel(const int32_t* idx, const int32_t* v32, int32_t* dense, int64_t n,
                              int64_t nnzb, int64_t rows64) {
  const int64_t i = (int64_t)blockIdx.x * MOBI_SCATTER_NT + threadIdx.x;
  if (i < n) mobi_scatter_one(dense, idx, v32, i, nnzb, rows64);
}

// `coefs` and `resid` are the same buffer in the sparse-blob form: every
// read of a block's rows comes before its barrier, every write after.
template <bool SBLOB>
__global__ void __launch_bounds__(MOBI_ROWS)
    mobi_residual_rows_kernel(const int32_t* coefs, int32_t* resid, const int32_t* sizes,
                              const int32_t* ops3, const int32_t* sbits, int32_t* ops,
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
  if (t < nr) {
    const int64_t r = row0 + t;
    const int size = SBLOB ? mobi_row_size(sbits, r) : sizes[r];
    mobi_residual_row(tile + t * MOBI_PITCH, size, tile + t * MOBI_PITCH);
    if (SBLOB) mobi_unpack_op3(ops3 + r * 3, ops + r * 4);
  }
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

// K3: the B * nnzb nonzeros of idx (B, nnzb) and v32 (B, nnzb / 2) into
// dense (B, rows64).
extern "C" int mobi_scatter_coefs_launch(const int32_t* idx, const int32_t* v32, int32_t* dense,
                                         long long B, long long nnzb, long long rows64,
                                         int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  const int64_t n = (int64_t)B * nnzb;
  if (n <= 0 || (nnzb & 1)) return (int)cudaErrorInvalidValue;
  mobi_scatter_coefs_kernel<<<mobi_blocks(n, MOBI_SCATTER_NT), MOBI_SCATTER_NT, 0,
                              (cudaStream_t)stream>>>(idx, v32, dense, n, nnzb, rows64);
  return (int)cudaGetLastError();
}

// K4, dense form: coefs (nrows, 64) and sizes (nrows,) -> resid (nrows, 64).
extern "C" int mobi_residual_rows_launch(const int32_t* coefs, const int32_t* sizes,
                                         int32_t* resid, long long nrows, int device,
                                         void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (nrows <= 0) return (int)cudaErrorInvalidValue;
  mobi_residual_rows_kernel<false><<<mobi_blocks(nrows, MOBI_ROWS), MOBI_ROWS, 0,
                                     (cudaStream_t)stream>>>(coefs, resid, sizes, nullptr,
                                                             nullptr, nullptr, nrows);
  return (int)cudaGetLastError();
}

// K4, sparse-blob form: resid (nrows, 64) scattered coefficients -> spatial
// rows in place, sizes from the size-bit words sbits, and the packed op rows
// ops3 (nrows, 3) -> ops (nrows, 4).
extern "C" int mobi_residual_rows_sblob_launch(int32_t* resid, const int32_t* ops3,
                                               const int32_t* sbits, int32_t* ops,
                                               long long nrows, int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (nrows <= 0) return (int)cudaErrorInvalidValue;
  mobi_residual_rows_kernel<true><<<mobi_blocks(nrows, MOBI_ROWS), MOBI_ROWS, 0,
                                    (cudaStream_t)stream>>>(resid, resid, nullptr, ops3, sbits,
                                                            ops, nrows);
  return (int)cudaGetLastError();
}
