// The encoder's full-search SAD volume for Hopper (sm_90a), bound with
// ctypes: K7 mobi_sad8_volume computes the whole (side^2, R, H/8, W/8)
// volume in one launch, one block per (tile row, vertical offset,
// reference).  What it replaces in the JAX package (XLA code, no
// pallas_call), what bounds it and the block's layout are in sad_ops.cuh.
#include <cuda_runtime.h>

#include "sad_ops.cuh"

__global__ void __launch_bounds__(MOBI_SAD_NT) mobi_sad8_volume_kernel(MobiSadArgs a) {
  extern __shared__ int32_t row[];
  const int by = blockIdx.x, dy = blockIdx.y, ri = blockIdx.z;
  mobi_sad_stage(a, by, dy, ri, (int)threadIdx.x, (int)blockDim.x, row);
  __syncthreads();
  mobi_sad_thread(a, by, dy, ri, (int)threadIdx.x, row);
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

// K7: cur (H, W), refs (R, H, W) -> vol ((2r + 1)^2, R, H / 8, W / 8).
extern "C" int mobi_sad8_volume_launch(const int32_t* cur, const int32_t* refs, int32_t* vol,
                                       long long H, long long W, long long R, long long r,
                                       int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (!mobi_sad_sizes_ok(H, W, R, r)) return (int)cudaErrorInvalidValue;
  const int smem = (int)mobi_sad_smem_bytes((int)W, (int)r);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mobi_sad8_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const MobiSadArgs a{cur, refs, vol, (int)H, (int)W, (int)R, (int)r};
  const dim3 grid((unsigned)(H / 8), (unsigned)(2 * r + 1), (unsigned)R);
  const int nt = mobi_sad_groups((int)W) * (int)(W / 8);
  mobi_sad8_volume_kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
