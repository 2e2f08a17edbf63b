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
//
// With few streams (no more than the card runs clusters of C at once: a
// file's launches, B = 1, and the CLI's batch of 8) that leaves most of
// the card idle and a frame's macroblocks in one serial chain: 1,200 of
// them at 640x480.  The cluster form
// (mobi_gop_executor_cluster_kernel, mobi_run_cluster) gives each stream a
// thread-block cluster of C blocks; block k decodes macroblock rows k,
// k + C, ..., each left to right with the same per-op phases and copies
// ahead, and keeps them in its shared memory (the whole plane leaves global
// memory at 640x480 too).  What bounds it: the critical path of a frame's
// macroblock rows, a row starting each macroblock once the row above is two
// ahead (cols + 2 (rows - 1) macroblocks: 38, 53 and 98 at the three
// geometries, against 192, 375 and 1,200 in one block), or the rows per
// block times a row, whichever is longer; plus the wait between rows.  The
// design keeps the wait off the per-op path: a block's progress is one int
// in its shared memory, stored with release; the copy threads poll the row
// above's through distributed shared memory (acquire) and copy the pixels
// of the line above that the next macroblock reads into the block's own
// shared memory, beside the compute of the op before it, so no op reads
// another block's memory and no barrier is added.  C is 16 where the card
// runs every stream's cluster of 16 at once (B <= 7 on the H100), else 8
// where it runs every cluster of 8 at once (B <= 15); more streams take the
// one-block form.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "exec_ops.cuh"

namespace cg = cooperative_groups;

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

// The cluster form's synchronisation: a block's progress is an int in its
// own shared memory, stored with release and read by the other blocks
// through distributed shared memory with acquire, at cluster scope; each
// copying thread polls before it reads the lines above, and the block's
// barrier that ends the phase holds the compute threads until it has.
struct MobiDevSync {
  uint8_t* const* peer = nullptr;
  MOBI_HD void publish(MobiClState* cs, int v) {
#if defined(__CUDA_ARCH__)
    const unsigned a = (unsigned)__cvta_generic_to_shared(&cs->prog);
    asm volatile("st.release.cluster.shared::cta.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
#endif
  }
  MOBI_HD void wait(MobiClState* cs, int m, int col, int nmb, int vcorner, int shift,
                    int& seen, int) {
#if defined(__CUDA_ARCH__)
    int q[2], need[2];
    const int n = mobi_cl_needs(m, col, nmb, vcorner, q, need);
    const unsigned a = (unsigned)__cvta_generic_to_shared(&cs->prog);
    for (int j = 0; j < n; ++j) {
      if (j == 0 && seen >= need[0]) continue;   // row m - 1, read far enough before
      unsigned ra;
      const unsigned owner = (unsigned)(q[j] & ((1 << shift) - 1));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(owner));
      int v;
      do {
        asm volatile("ld.acquire.cluster.shared::cluster.u32 %0, [%1];"
                     : "=r"(v) : "r"(ra) : "memory");
      } while (v < need[j]);
      if (j == 0) seen = v;
    }
#endif
  }
  MOBI_HD void cluster_sync() {
#if defined(__CUDA_ARCH__)
    cg::this_cluster().sync();
#endif
  }
};

// The cluster form: one cluster of 1 << shift blocks per stream.  Its
// rows of the plane take less shared memory than the whole plane, so one
// block per SM at most; the cluster has the SMs.
__global__ void __launch_bounds__(MOBI_NB, 1)
    mobi_gop_executor_cluster_kernel(MobiArgs a, int shift) {
  extern __shared__ __align__(16) uint8_t mobi_smem[];
  MobiDevSync sy;
  mobi_run_cluster(a, (int)blockIdx.x >> shift, (int)cg::this_cluster().block_rank(), shift,
                   mobi_smem, sy);
}

// The cluster form's shared memory and cluster attributes for clusters of
// C blocks; returns a CUDA error code.
static cudaError_t mobi_cluster_attrs(int H, int S, int C, int* bytes) {
  *bytes = mobi_cl_smem_bytes(H, S, C);
  if (H / 16 > MOBI_CL_MAXR || *bytes > MOBI_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mobi_gop_executor_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(mobi_gop_executor_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

static cudaLaunchConfig_t mobi_cluster_config(int B, int C, int bytes, cudaStream_t st,
                                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(MOBI_NB);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of C blocks the card runs at once at this geometry
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
extern "C" int mobi_gop_executor_cluster_capacity(int H, int S, int C, int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaErrorInvalidDevice;
  int bytes = 0;
  if (e == cudaSuccess) e = mobi_cluster_attrs(H, S, C, &bytes);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mobi_cluster_config(1, C, bytes, 0, attr);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, (void*)mobi_gop_executor_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Launches the cluster form, a cluster of C blocks (2, 4, 8 or 16) per
// stream, on `stream`; as mobi_gop_executor_launch otherwise.  A cluster
// the card cannot place, or rows that do not fit a block's shared memory,
// are refused here, never run in the other form.
extern "C" int mobi_gop_executor_cluster_launch(const int32_t* ops, const int32_t* resid,
                                                uint8_t* ring, uint8_t* frames,
                                                const uint8_t* tabs, int B, int nct, int F,
                                                int H, int S, int C, int device,
                                                void* stream) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device) return (int)cudaErrorInvalidDevice;
  int shift = 1;
  while (shift < 4 && (1 << shift) < C) ++shift;
  if ((1 << shift) != C) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  e = mobi_cluster_attrs(H, S, C, &bytes);
  if (e != cudaSuccess) return (int)e;
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
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mobi_cluster_config(B, C, bytes, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, mobi_gop_executor_cluster_kernel, a, shift);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
