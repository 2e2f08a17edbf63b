// The wavefront engine's frame round for Hopper (sm_90a), bound with
// ctypes: K6 mobi_wavefront_frame decodes one frame round of B streams in
// one launch, one block of MOBI_WF_NT threads per stream, with the intra
// levels looped inside the block (the JAX engine's fori_loop).  The
// per-stream code, what it replaces in the JAX package (XLA code, no
// pallas_call), how it keeps the functional engine's read-before-write
// order and what bounds it are in wavefront_ops.cuh.
#include <cuda_runtime.h>

#include "wavefront_ops.cuh"

__global__ void __launch_bounds__(MOBI_WF_NT) mobi_wavefront_frame_kernel(MobiWfArgs a) {
  __shared__ MobiWfShared sh;
  mobi_wf_stream<MOBI_WF_NT>(a, blockIdx.x, (int)threadIdx.x, sh);
}

// The launcher enqueues one kernel on `stream`, allocates nothing and
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

// K6: ring (B, 6, HH, S), mc (B, M, 7), resid (B, N, 4), rcoef (B, N, 64),
// iops (B, L, K, 11), icoef (B, L, K, 64), seqmap (B, SR, S / 4),
// n_levels (B,), the intra tables (20,480 bytes), the stage (B, max(N, K)
// * 256) -> out (B, HH, S).
extern "C" int mobi_wavefront_frame_launch(const int32_t* ring, const int32_t* mc,
                                           const int32_t* resid, const int32_t* rcoef,
                                           const int32_t* iops, const int32_t* icoef,
                                           const int32_t* seqmap, const int32_t* n_levels,
                                           const uint8_t* tables, int32_t* out, int32_t* stage,
                                           long long B, int H, int S, int M, int N, int L, int K,
                                           int SR, int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (!mobi_wf_sizes_ok(B, H, S, M, N, L, K, SR) || B > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const MobiWfArgs a{ring, mc, resid, rcoef, iops, icoef, seqmap, n_levels, tables, out, stage,
                     H, S, M, N, L, K, SR};
  mobi_wavefront_frame_kernel<<<(unsigned)B, MOBI_WF_NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
