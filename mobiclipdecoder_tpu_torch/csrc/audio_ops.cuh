// Code of the batched audio ops, written once for the GPU kernels K8 and K9
// (audio.cu, nvcc) and for a host build (audio_host.cpp, g++) that the CPU
// tests hold against the JAX package.
//
// K8, the FastAudio lattice.  Replaces XLA code of
// mobiclipdecoder_tpu/ops/audio_lpc.py (no pallas_call there):
// fastaudio_synth (:43) with _mulshift15 (:36) and _DEEMPH (:33), a jitted
// lax.scan over the samples with every channel advancing one sample per
// step.  The plain PyTorch version is ops/audio_lpc.py fastaudio_synth_plain.
//   What bounds it: neither bytes (about 25 KB per round of 16 channels x
// 256 samples) nor operations, but each channel's serial chain: per sample
// 8 dependent multiply-shift-subtract pairs and the de-emphasis.  The
// design: one thread per channel keeps hist[8] and r9 in registers over all
// N samples, so a channel's whole run is one launch and the chain never
// leaves the thread.  A FastAudio packet brings its own coefficients, so
// K8 takes a set per packet (coef (B, P, 8) over N = 256 P samples) and
// each row's own packet count: the transcoder decodes the packets of a
// launch's channels, rows of different lengths, in one launch, and
// carries each row's state after its own packets into the next.  The
// JAX package's form, one set for all N samples, is P = 1.
//   Exactness: (coef * hist + 0x4000) >> 15 is taken as an int64 product and
// an arithmetic shift, truncated to int32, which equals the JAX package's
// exact int32 split for |coef| < 2^15; every add and subtract of the state
// wraps in uint32, as the references' int32 arithmetic does (signed
// overflow would be undefined in C++).
//
// K9, the IMA ADPCM scans.  Replaces XLA code of
// mobiclipdecoder_tpu/ops/adpcm.py (no pallas_call there): decode_nibbles
// (:47-73), two jax.lax.associative_scans of clamped-add maps x -> clamp(x +
// a, lo, hi) composed by _compose (:37).  The plain PyTorch version is
// ops/adpcm.py decode_nibbles_plain.
//   What bounds it: the bytes (int32 nibbles in, int32 samples out: 16.8 MB,
// about 5 us, at 64 rows x 32,768) and the depth of the scans.  The design:
// one block of MOBI_IMA_NT threads per row, thread t owning a contiguous
// segment of the row.  Pass 1 composes the segment's step-index maps (a =
// index table entry, lo 0, hi 88) in order; a block-wide inclusive scan of
// the threads' maps (Hillis-Steele over shared memory, the same _compose)
// gives each thread's starting index.  Pass 2 replays the segment from that
// index to the pre-update index and signed diff of each nibble
// (IMAADPCMDecoder.cs:37-42) and composes the sample maps (d, -32768,
// 32767); a second scan gives the starting sample, and a last replay writes
// the samples.  The diffs are recomputed, so nothing but the output is
// written.  The scan runs as phases of "each thread t" separated by
// barriers, so the host build runs the very same scan tree.  Given each
// row's length n, the thread that owns nibble n - 1 also writes the state
// after it (thread 0 the start where n is 0): the transcoder pads the
// ragged rows of a chunk's packets to one width and carries each row's own
// state into the next chunk.
//   Exactness: clamped-add composition is exact and associative, so any scan
// order equals the sequential decoder as long as no partial sum of a wraps
// in int32.  The largest |diff| is 61,436, so rows up to 34,952 nibbles
// cannot wrap in any order; a is kept in int32 (wrapping in uint32) as both
// reference versions keep it.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define MOBI_AU_HD __host__ __device__ __forceinline__
#else
#define MOBI_AU_HD inline
#endif

#define MOBI_FA_NT 128       // K8's threads per block, one per channel
#define MOBI_FA_DEEMPH 0x6E14 // de-emphasis coefficient (FastAudioDecoder.cs:66)
#define MOBI_IMA_NT 256      // K9's threads per block, one block per row
#define MOBI_IMA_NIDX 8      // the index table's entries (models/audio_ima.py)
#define MOBI_IMA_NSTEP 89    // the step table's entries

MOBI_AU_HD int32_t mobi_wrap_add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }

MOBI_AU_HD int32_t mobi_wrap_sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

MOBI_AU_HD int32_t mobi_clamp(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (a * b + 0x4000) >> 15 as int64, truncated to int32.
MOBI_AU_HD int32_t mobi_mulshift15(int32_t a, int32_t b) {
  return (int32_t)(uint32_t)(((int64_t)a * (int64_t)b + 0x4000) >> 15);
}

// ---------------------------------------------------------------- K8

// Channel b of K8: excit (B, P * L), coef (B, P, 8) (set p for samples
// [p * L, (p + 1) * L)), hist0 (B, 8), r9_0 (B,), lengths (B,) or null ->
// pcm (B, P * L) int16, and in hist (B, 8), r9 (B,) the state after the
// channel's first n = lengths[b] sets (clamped to [0, P]; P where lengths
// is null).  Samples past n * L are padding: they are not written.
MOBI_AU_HD void mobi_fa_channel(const int32_t* excit, const int32_t* coef, const int32_t* hist0,
                                const int32_t* r9_0, const int32_t* lengths, int16_t* pcm,
                                int32_t* hist_out, int32_t* r9_out, long long b, int P, int L) {
  int n = P;
  if (lengths != nullptr) n = lengths[b] < 0 ? 0 : (lengths[b] < P ? lengths[b] : P);
  int32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = hist0[b * 8 + j];
  int32_t r9 = r9_0[b];
  const long long N = (long long)P * L;
  const int32_t* e = excit + b * N;
  int16_t* out = pcm + b * N;
  for (int p = 0; p < n; ++p) {
    int32_t cf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cf[j] = coef[(b * P + p) * 8 + j];
    for (int s = p * L; s < (p + 1) * L; ++s) {
      int32_t r5 = e[s];
      int32_t nh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r5 = mobi_wrap_sub(r5, mobi_mulshift15(cf[j], h[j]));
        nh[j] = mobi_wrap_add(h[j], mobi_mulshift15(cf[j], r5));
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) h[j] = nh[j + 1];
      h[7] = r5;
      r9 = mobi_wrap_add(r5, mobi_mulshift15(MOBI_FA_DEEMPH, r9));
      const int32_t r8 = mobi_clamp(r9, -(1 << 28), 1 << 28) * 2;
      out[s] = (int16_t)mobi_clamp(r8, -32768, 32767);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) hist_out[b * 8 + j] = h[j];
  r9_out[b] = r9;
}

// ---------------------------------------------------------------- K9

// A clamped-add map x -> clamp(x + a, lo, hi).
struct MobiImaMap {
  int32_t a, lo, hi;
};

// _compose: g after f.
MOBI_AU_HD MobiImaMap mobi_ima_compose(MobiImaMap f, MobiImaMap g) {
  return MobiImaMap{mobi_wrap_add(f.a, g.a), mobi_clamp(mobi_wrap_add(f.lo, g.a), g.lo, g.hi),
                    mobi_clamp(mobi_wrap_add(f.hi, g.a), g.lo, g.hi)};
}

MOBI_AU_HD int32_t mobi_ima_apply(MobiImaMap f, int32_t x) {
  return mobi_clamp(mobi_wrap_add(x, f.a), f.lo, f.hi);
}

// The signed diff of nibble v at pre-update step index idx.  Only a row's
// index0 can lie outside [0, 88] (the decoder's state never does); the
// lookup reads the nearest entry rather than past the table.
MOBI_AU_HD int32_t mobi_ima_diff(const int32_t* step_t, int32_t idx, int32_t v) {
  const int32_t step = step_t[mobi_clamp(idx, 0, MOBI_IMA_NSTEP - 1)];
  const int32_t diff = (step >> 3) + (step >> 2) * (v & 1) + (step >> 1) * ((v >> 1) & 1) +
                       step * ((v >> 2) & 1);
  return (v & 8) != 0 ? -diff : diff;
}

// Shared memory of K9's block.
struct MobiImaShared {
  int32_t idx_t[MOBI_IMA_NIDX];
  int32_t step_t[MOBI_IMA_NSTEP];
  MobiImaMap scan[2][MOBI_IMA_NT];  // the threads' maps, double-buffered
  int32_t idx0[MOBI_IMA_NT];        // each thread's starting step index
};

// Nibbles per thread of a row of N.
MOBI_AU_HD long long mobi_ima_seg(long long N) { return (N + MOBI_IMA_NT - 1) / MOBI_IMA_NT; }

// K9's block for row `row` runs as phases, each "for every thread t in
// [t0, t1)", with sync() between them: on the card t1 = t0 + 1 (the calling
// thread) and sync is __syncthreads; on the host t0 = 0, t1 = MOBI_IMA_NT
// and sync does nothing, so both run the same scan tree.

// Inclusive Hillis-Steele scan of the threads' maps in sh.scan[p]; returns
// the buffer that holds the result.
template <class Sync>
MOBI_AU_HD int mobi_ima_block_scan(MobiImaShared& sh, int p, int t0, int t1, Sync sync) {
  for (int d = 1; d < MOBI_IMA_NT; d *= 2) {
    for (int t = t0; t < t1; ++t)
      sh.scan[p ^ 1][t] =
          t >= d ? mobi_ima_compose(sh.scan[p][t - d], sh.scan[p][t]) : sh.scan[p][t];
    sync();
    p ^= 1;
  }
  return p;
}

// Row `row` of K9: nibbles (M, N), index0 (M,), last0 (M,), tables (the
// index table, then the step table) -> out (M, N).  Thread t owns nibbles
// [t * seg, (t + 1) * seg) of the row; threads past the row's end own none
// and stand after every thread that does, so their maps reach no result.
// Where index_out is not null, also the row's state after its first n
// nibbles, n = lengths[row] clamped to [0, N] (N where lengths is null):
// the step index into index_out (M,) and the sample into last_out (M,), so
// that a caller that padded ragged rows can carry each one's state on.
template <class Sync>
MOBI_AU_HD void mobi_ima_row(const int32_t* nibbles, const int32_t* index0, const int32_t* last0,
                             const int32_t* tables, const int32_t* lengths, int32_t* out,
                             int32_t* index_out, int32_t* last_out, long long row, long long N,
                             int t0, int t1, MobiImaShared& sh, Sync sync) {
  const long long seg = mobi_ima_seg(N);
  long long n = N;
  if (lengths != nullptr) n = lengths[row] < 0 ? 0 : (lengths[row] < N ? lengths[row] : N);
  const int32_t* nib = nibbles + row * N;
  int32_t* dst = out + row * N;
  for (int t = t0; t < t1; ++t)
    for (int k = t; k < MOBI_IMA_NIDX + MOBI_IMA_NSTEP; k += MOBI_IMA_NT) {
      if (k < MOBI_IMA_NIDX)
        sh.idx_t[k] = tables[k];
      else
        sh.step_t[k - MOBI_IMA_NIDX] = tables[k];
    }
  sync();
  // pass 1: each segment's step-index map, composed in order
  for (int t = t0; t < t1; ++t) {
    const long long k0 = t * seg, k1 = k0 + seg < N ? k0 + seg : N;
    MobiImaMap m{0, 0, 88};
    for (long long k = k0; k < k1; ++k) {
      const MobiImaMap g{sh.idx_t[nib[k] & 7], 0, 88};
      m = k == k0 ? g : mobi_ima_compose(m, g);
    }
    sh.scan[0][t] = m;
  }
  sync();
  const int p1 = mobi_ima_block_scan(sh, 0, t0, t1, sync);
  // pass 2: the segment's starting index (the exclusive prefix applied to
  // index0), then each nibble's pre-update index and signed diff, composed
  // into the segment's sample map
  for (int t = t0; t < t1; ++t) {
    const long long k0 = t * seg, k1 = k0 + seg < N ? k0 + seg : N;
    int32_t idx = t == 0 ? index0[row] : mobi_ima_apply(sh.scan[p1][t - 1], index0[row]);
    sh.idx0[t] = idx;
    MobiImaMap m{0, -32768, 32767};
    for (long long k = k0; k < k1; ++k) {
      const int32_t v = nib[k];
      const MobiImaMap g{mobi_ima_diff(sh.step_t, idx, v), -32768, 32767};
      m = k == k0 ? g : mobi_ima_compose(m, g);
      idx = mobi_clamp(idx + sh.idx_t[v & 7], 0, 88);
    }
    sh.scan[p1 ^ 1][t] = m;
  }
  sync();
  const int p2 = mobi_ima_block_scan(sh, p1 ^ 1, t0, t1, sync);
  // pass 3: the segment's samples from its starting sample
  for (int t = t0; t < t1; ++t) {
    const long long k0 = t * seg, k1 = k0 + seg < N ? k0 + seg : N;
    int32_t s = t == 0 ? last0[row] : mobi_ima_apply(sh.scan[p2][t - 1], last0[row]);
    int32_t idx = sh.idx0[t];
    if (index_out != nullptr && t == 0 && n == 0) {
      index_out[row] = idx;
      last_out[row] = s;
    }
    for (long long k = k0; k < k1; ++k) {
      const int32_t v = nib[k];
      s = mobi_clamp(s + mobi_ima_diff(sh.step_t, idx, v), -32768, 32767);
      idx = mobi_clamp(idx + sh.idx_t[v & 7], 0, 88);
      dst[k] = s;
      if (index_out != nullptr && k == n - 1) {
        index_out[row] = idx;
        last_out[row] = s;
      }
    }
  }
}
