// The batched audio ops for Hopper (sm_90a), bound with ctypes:
//   K8 mobi_fastaudio_synth  the FastAudio lattice of B channels over P
//        packets (a coefficient set each) in one launch, one thread per
//        channel (MOBI_FA_NT a block);
//   K9 mobi_ima_scan         the IMA ADPCM step-index and sample chains of M
//        rows in one launch, one block of MOBI_IMA_NT threads per row.
// What they replace in the JAX package (XLA code, no pallas_call), what
// bounds them and their exactness are in audio_ops.cuh.
#include <cuda_runtime.h>

#include "audio_ops.cuh"

__global__ void __launch_bounds__(MOBI_FA_NT)
    mobi_fastaudio_synth_kernel(const int32_t* excit, const int32_t* coef, const int32_t* hist0,
                                const int32_t* r9_0, const int32_t* lengths, int16_t* pcm,
                                int32_t* hist, int32_t* r9, long long B, int P, int L) {
  const long long b = (long long)blockIdx.x * MOBI_FA_NT + threadIdx.x;
  if (b < B) mobi_fa_channel(excit, coef, hist0, r9_0, lengths, pcm, hist, r9, b, P, L);
}

// The barrier between K9's phases (host and device, so that the host side
// of mobi_ima_row's instantiation compiles too).
struct MobiBarrier {
  __host__ __device__ void operator()() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

__global__ void __launch_bounds__(MOBI_IMA_NT)
    mobi_ima_scan_kernel(const int32_t* nibbles, const int32_t* index0, const int32_t* last0,
                         const int32_t* tables, const int32_t* lengths, int32_t* out,
                         int32_t* index_out, int32_t* last_out, long long N) {
  __shared__ MobiImaShared sh;
  const int t = (int)threadIdx.x;
  mobi_ima_row(nibbles, index0, last0, tables, lengths, out, index_out, last_out, blockIdx.x, N, t,
               t + 1, sh, MobiBarrier{});
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

// K8: excit (B, P * L), coef (B, P, 8), hist0 (B, 8), r9_0 (B,), lengths
// (B,) or null -> pcm (B, P * L) int16, and in hist (B, 8), r9 (B,) each
// row's state after its first lengths[b] coefficient sets of L samples
// (all P where lengths is null).
extern "C" int mobi_fastaudio_synth_launch(const int32_t* excit, const int32_t* coef,
                                           const int32_t* hist0, const int32_t* r9_0,
                                           const int32_t* lengths, int16_t* pcm, int32_t* hist,
                                           int32_t* r9, long long B, long long P, long long L,
                                           int device, void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (B < 1 || P < 1 || L < 0 || P * L > 0x7FFFFFFFLL ||
      (B + MOBI_FA_NT - 1) / MOBI_FA_NT > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  mobi_fastaudio_synth_kernel<<<(unsigned)((B + MOBI_FA_NT - 1) / MOBI_FA_NT), MOBI_FA_NT, 0,
                                (cudaStream_t)stream>>>(excit, coef, hist0, r9_0, lengths, pcm,
                                                        hist, r9, B, (int)P, (int)L);
  return (int)cudaGetLastError();
}

// K9: nibbles (M, N), index0 (M,), last0 (M,), tables (the index table's 8
// entries, then the step table's 89) -> out (M, N); with index_out and
// last_out (M,) not null, each row's state after its first lengths[row]
// nibbles (all N where lengths is null) too.
extern "C" int mobi_ima_scan_launch(const int32_t* nibbles, const int32_t* index0,
                                    const int32_t* last0, const int32_t* tables,
                                    const int32_t* lengths, int32_t* out, int32_t* index_out,
                                    int32_t* last_out, long long M, long long N, int device,
                                    void* stream) {
  const int rc = mobi_check_device(device);
  if (rc != 0) return rc;
  if (M < 1 || M > 0x7FFFFFFFLL || N < 1 || (index_out == nullptr) != (last_out == nullptr))
    return (int)cudaErrorInvalidValue;
  mobi_ima_scan_kernel<<<(unsigned)M, MOBI_IMA_NT, 0, (cudaStream_t)stream>>>(
      nibbles, index0, last0, tables, lengths, out, index_out, last_out, N);
  return (int)cudaGetLastError();
}
