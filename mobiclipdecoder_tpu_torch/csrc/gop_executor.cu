// Whole-GOP executor kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernels K1, _make_kernel(..., fused=(B, nct,
// stage)) launched by _build_gop_executor, and K2, the same body launched
// per frame by _build_executor (mobiclipdecoder_tpu/ops/vmem_engine.py);
// K2 is this kernel with F = 1.  The per-op logic lives in exec_ops.cuh.
//
// What bounds it: each stream is a strictly serial chain of small ops (a
// 16x16 block at most; about 11,000 per DS stream per 24-frame GOP), so
// the time is the op count times the latency of one op, far above what its
// bytes (tens of MB per GOP) or its arithmetic need.  The latency of an op
// is its block barrier plus the longest chain of dependent instructions a
// thread runs before it.  The design shortens that chain:
//   * the working plane lives in shared memory where the block fits the
//     card (256x192 and 400x240; 640x480's plane stays in global memory),
//     so intra taps and residual read-modify-writes are shared-memory
//     accesses, and the frame is zeroed and written out with 16-byte stores;
//   * each op's inputs that do not depend on the frame being decoded (its
//     coefficient rows and MC reference-window segments) and the next
//     chunk's op rows are copied into shared memory with cp.async,
//     MOBI_K - 1 ops ahead, by 96 copy threads beside the 256 compute
//     threads, so the compute threads never wait on global memory for them
//     and never run the copies' index arithmetic;
//   * one barrier per op: intra ops read their taps straight from the
//     plane while they write their block, so single blocks and the chroma
//     pair take one phase (two before) and a luma quad batch one per
//     present sub-block (eight before);
//   * no integer division or modulo by a runtime value on the per-op path.
// One block per stream keeps the serial order; filling the card needs more
// streams per launch (two blocks share an SM at 256x192 and 640x480).
#include <cuda_runtime.h>

#include "exec_ops.cuh"

// Two blocks per SM: they fit its shared memory at 256x192 and 640x480
// (one block at 400x240), and the register cap that lets them fit its
// registers too costs a stream little (a few spilled registers in the
// global-plane form) against twice the streams per wave.
template <bool SM>
__global__ void __launch_bounds__(MOBI_NB, 2) mobi_gop_executor_kernel(MobiArgs a) {
  extern __shared__ __align__(16) uint8_t mobi_smem[];
  mobi_run_stream<SM>(a, (int)blockIdx.x, mobi_smem);
}

template <bool SM>
static int mobi_launch(const MobiArgs& a, int bytes, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(mobi_gop_executor_kernel<SM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  mobi_gop_executor_kernel<SM><<<a.B, MOBI_NB, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches one block per stream on `stream`, with the working plane in
// shared memory when `smem_plane` is set; allocates nothing and returns a
// CUDA error code (0 on success).  A block that needs more shared memory
// than the card grants is refused here, never run in the other form.
// `device` is the card the tensors and the stream belong to: this
// library's runtime launches on (and sets the kernel's shared-memory
// attribute for) the device current on the calling thread, so a launch
// from any other device is refused instead of reaching across cards.
extern "C" int mobi_gop_executor_launch(const int32_t* ops, const int32_t* resid,
                                        uint8_t* ring, uint8_t* frames,
                                        const uint8_t* tabs, int B, int nct, int F,
                                        int H, int S, int smem_plane, int device,
                                        void* stream) {
  int current = -1;
  const cudaError_t de = cudaGetDevice(&current);
  if (de != cudaSuccess) return (int)de;
  if (current != device) return (int)cudaErrorInvalidDevice;
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
  const int bytes = mobi_smem_bytes(H, S, smem_plane);
  if (bytes > MOBI_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return smem_plane ? mobi_launch<true>(a, bytes, st) : mobi_launch<false>(a, bytes, st);
}
