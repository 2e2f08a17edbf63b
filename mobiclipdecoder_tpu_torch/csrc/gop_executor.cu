// Whole-GOP executor kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel K1: _make_kernel(..., fused=(B, nct, stage))
// launched by _build_gop_executor (mobiclipdecoder_tpu/ops/vmem_engine.py).
// The per-op logic lives in exec_ops.cuh.
//
// What bounds it: each stream is a strictly serial chain of small ops (a
// 16x16 block at most), so the time is the per-op latency (L2 reads of the
// reference window, one or more block barriers) times the op count, not
// bytes or arithmetic.  At B=8 only 8 of the 132 SMs hold a block.  The
// design keeps the serial order inside one block per stream (256 threads,
// one pixel each), keeps every plane in uint8 so a stream's ring and frames
// stay resident in the 50 MB L2, and loads intra taps into shared memory
// before a barrier instead of re-reading them per pixel.  Filling the card
// needs more streams per launch or several streams per SM; that is later
// work.
#include <cuda_runtime.h>

#include "exec_ops.cuh"

__global__ void __launch_bounds__(MOBI_NT) mobi_gop_executor_kernel(MobiArgs a) {
  __shared__ MobiShared sh;
  mobi_run_stream(a, (int)blockIdx.x, &sh);
}

// Launches one block per stream on `stream`; allocates nothing and returns
// cudaGetLastError() (0 on success).
extern "C" int mobi_gop_executor_launch(const int32_t* ops, const int32_t* resid,
                                        uint8_t* ring, uint8_t* frames,
                                        const uint8_t* tabs, int B, int nct, int F,
                                        int H, int S, void* stream) {
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
  mobi_gop_executor_kernel<<<B, MOBI_NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
