// Host build of the batched audio ops' code (audio_ops.cuh), for the CPU
// tests only: K8's per-channel function over every channel, and K9's block
// run row by row with its threads taken in turn phase by phase (the same
// scan tree as on the card), so that the code the kernels run is checked
// against the JAX package on a machine without a GPU.
//   g++ -O3 -std=c++17 -shared -fPIC -o libaudio_host.so audio_host.cpp
#include <memory>

#include "audio_ops.cuh"

// K8's operands (see audio.cu).
extern "C" void mobi_fastaudio_synth_host(const int32_t* excit, const int32_t* coef,
                                          const int32_t* hist0, const int32_t* r9_0,
                                          const int32_t* lengths, int16_t* pcm, int32_t* hist,
                                          int32_t* r9, long long B, long long P, long long L) {
  for (long long b = 0; b < B; ++b)
    mobi_fa_channel(excit, coef, hist0, r9_0, lengths, pcm, hist, r9, b, (int)P, (int)L);
}

// K9's operands (see audio.cu).
extern "C" void mobi_ima_scan_host(const int32_t* nibbles, const int32_t* index0,
                                   const int32_t* last0, const int32_t* tables,
                                   const int32_t* lengths, int32_t* out, int32_t* index_out,
                                   int32_t* last_out, long long M, long long N) {
  std::unique_ptr<MobiImaShared> sh(new MobiImaShared());
  for (long long row = 0; row < M; ++row)
    mobi_ima_row(nibbles, index0, last0, tables, lengths, out, index_out, last_out, row, N, 0,
                 MOBI_IMA_NT, *sh, [] {});
}
