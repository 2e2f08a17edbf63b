// The wavefront engine's GOP decode for Hopper (sm_90a), bound with
// ctypes: K6 mobi_wavefront_gop decodes F frame rounds of B streams in one
// launch (the JAX package's decode_gop_jit; F=1 is one round).  Each
// stream gets a thread-block cluster of C blocks of MOBI_WF_NT threads;
// the phases of a round run in order with a cluster barrier between them,
// and the intra levels loop inside the cluster's first block (the JAX
// engine's fori_loop).  The per-stream phases, what they replace in the
// JAX package (XLA code, no pallas_call), how they keep the functional
// engine's read-before-write order and what bounds them are in
// wavefront_ops.cuh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "wavefront_ops.cuh"

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(MOBI_WF_NT, 1) mobi_wavefront_gop_kernel(MobiWfArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  MobiWfShared& sh = *reinterpret_cast<MobiWfShared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t b = blockIdx.x / a.C;
  const int tid = (int)threadIdx.x;
  mobi_wf_init<MOBI_WF_NT>(a, b, rank, tid, sh);
  cluster.sync();
  for (int f = 0; f < a.F; ++f) {
    const MobiWfRound rd = mobi_wf_round(a.desc, f);
    const int head = mobi_wf_head(a.head, f);
    mobi_wf_phase_mc<MOBI_WF_NT>(a, rd, b, head, rank, tid, sh);
    cluster.sync();
    mobi_wf_phase_resid<MOBI_WF_NT>(a, rd, b, rank, tid, sh);
    cluster.sync();
    if (rank == 0) mobi_wf_phase_levels<MOBI_WF_NT>(a, rd, b, tid, sh);
    cluster.sync();
    mobi_wf_phase_commit<MOBI_WF_NT>(a, f, b, head, rank, tid);
    cluster.sync();
  }
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

// K6: ring (B, 6, HH, S) int32 in physical slots, head its logical slot
// 0's physical slot before the GOP; desc (F, 12) the rounds' descriptors
// on the card and desc_host the same on the host (checked here); the intra
// tables (20,480 bytes); scratch fa, fb (B, HH, S), ires (B, ires_stride),
// klev (B, lmax), ovf (B, 2 ovf_stride) -> out8 and out32 (F, B, HH, S) where not null, and the
// rounds' frames in the ring where commit (else F must be 1).  C is the
// cluster's size.
extern "C" int mobi_wavefront_gop_launch(int32_t* ring, const long long* desc,
                                         const long long* desc_host, const uint8_t* tables,
                                         int32_t* fa, int32_t* fb, int32_t* ires,
                                         long long ires_stride, int32_t* klev, int lmax,
                                         int32_t* ovf, long long ovf_stride,
                                         uint8_t* out8, int32_t* out32, long long B, int H, int S,
                                         int F, int head, int commit, int C, int device,
                                         void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (!mobi_wf_gop_ok(desc_host, B, H, S, F, head, commit, C, lmax, ires_stride,
                      ovf_stride))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(MobiWfShared);
  cudaError_t e = cudaFuncSetAttribute(mobi_wavefront_gop_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const MobiWfArgs a{ring, desc, tables, fa, fb, ires, klev, ovf, out8, out32, B,
                     ires_stride, ovf_stride, lmax, H, S, F, head, commit, C};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(MOBI_WF_NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mobi_wavefront_gop_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
