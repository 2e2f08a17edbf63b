// Code of the encoder's full-search SAD volume, written once for the GPU
// kernel K7 (sad.cu, nvcc) and for a host build (sad_host.cpp, g++) that the
// CPU tests hold against the JAX package.
//
// Replaces XLA code of mobiclipdecoder_tpu/ops/mesearch.py (no pallas_call
// there): _sad8_volume (:28-48), a jitted lax.scan over the (2r+1)^2
// full-pel offsets.  The plain PyTorch version is ops/mesearch.py
// _sad8_volume_plain.
//
// The function: cur (H, W), refs (R, H, W) int32 -> vol ((2r+1)^2, R, H/8,
// W/8) int32, entry [k, ri, by, bx] the SAD of cur's 8x8 tile (by, bx)
// against reference ri shifted by (dy, dx) = (k / side - r, k % side - r),
// side = 2r + 1, the reference zero-padded (an out-of-frame candidate reads
// 0, not a clamped edge: the encoder masks such candidates itself).
//
// What bounds it on the card: the bytes.  At 256x192, r = 16, R = 5 the
// volume is 16.7 MB of int32 written once (the inputs 1.2 MB), about 5 us
// at 3.35 TB/s; the 267.6 M absolute differences take about 4 us at one
// operation each.  The design: one block per (tile row by, vertical offset
// dy, reference ri), so a block writes side x W/8 outputs.  The block stages
// the reference's 8 rows at that offset, zero-padded to W + 2r columns, in
// shared memory, with column c at (c % 8) * P + c / 8 (P = ceil((W + 2r) /
// 8)): the threads of a warp take neighbouring tiles bx at one offset dx,
// so their reads fall in neighbouring banks and their stores on neighbouring
// addresses.  A thread keeps its tile of cur in 64 registers and walks the
// offsets dx = g, g + G, ..., so each cur value is read once per thread.
//
// Arithmetic wraps in uint32, as the plain version's int32 does: equal for
// any int32 input, exact for the encoder's 8-bit planes.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define MOBI_SAD_HD __host__ __device__ __forceinline__
#else
#define MOBI_SAD_HD inline
#endif

#define MOBI_SAD_NT 256          // most threads of K7's block
#define MOBI_SAD_SMEM_MAX 232448 // shared memory a Hopper block can use

// The operands of one volume.
struct MobiSadArgs {
  const int32_t* cur;   // (H, W)
  const int32_t* refs;  // (R, H, W)
  int32_t* vol;         // (side * side, R, H / 8, W / 8)
  int H, W, R, r;
};

// The pitch P of one staged row phase: ceil((W + 2r) / 8).
MOBI_SAD_HD int mobi_sad_pitch(int W, int r) { return (W + 2 * r + 7) / 8; }

// Bytes of the block's shared memory: 8 rows of 8 phases of P words.
MOBI_SAD_HD long long mobi_sad_smem_bytes(int W, int r) {
  return 64LL * mobi_sad_pitch(W, r) * (long long)sizeof(int32_t);
}

// Threads of a block share the W / 8 tiles of a row: G groups of W / 8.
MOBI_SAD_HD int mobi_sad_groups(int W) {
  const int wb = W / 8;
  return wb >= MOBI_SAD_NT ? 1 : MOBI_SAD_NT / wb;
}

// The sizes K7 takes: H, W multiples of 8 (as the plain version's reshape
// needs), W / 8 at most MOBI_SAD_NT tiles (W <= 2048), r >= 0 with the
// staged rows in shared memory, at least one reference, and grid
// dimensions the card takes.
MOBI_SAD_HD bool mobi_sad_sizes_ok(long long H, long long W, long long R, long long r) {
  if (H < 8 || W < 8 || H % 8 || W % 8 || W / 8 > MOBI_SAD_NT || R < 1 || R > 65535 || r < 0 ||
      2 * r + 1 > 65535 || H / 8 > 0x7FFFFFFFLL)
    return false;
  return mobi_sad_smem_bytes((int)W, (int)r) <= MOBI_SAD_SMEM_MAX;
}

MOBI_SAD_HD uint32_t mobi_absdiff(int32_t a, int32_t b) {
  const uint32_t d = (uint32_t)a - (uint32_t)b;
  return (int32_t)d < 0 ? 0u - d : d;
}

// Stage block (by, dy, ri)'s reference rows: row i of the tile row at
// vertical offset dy (0 .. 2r) is the reference's row 8 by + i + dy - r,
// columns -r .. W + r - 1, each 0 outside the frame.  Thread t of nt.
MOBI_SAD_HD void mobi_sad_stage(const MobiSadArgs& a, int by, int dy, int ri, int t, int nt,
                                int32_t* row) {
  const int P = mobi_sad_pitch(a.W, a.r);
  const int wp = a.W + 2 * a.r;
  const int32_t* ref = a.refs + (long long)ri * a.H * a.W;
  for (int w = t; w < 8 * wp; w += nt) {
    const int i = w / wp;
    const int c = w - i * wp;
    const int y = 8 * by + i + dy - a.r;
    const int x = c - a.r;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
    row[i * 8 * P + (c & 7) * P + (c >> 3)] = in ? ref[(long long)y * a.W + x] : 0;
  }
}

// Thread t of block (by, dy, ri), after the stage: the SADs of tile bx =
// t % (W / 8) at the offsets dx = t / (W / 8), + G, ... (G from
// mobi_sad_groups), each written to vol.  Threads t >= G * W / 8 do
// nothing.
MOBI_SAD_HD void mobi_sad_thread(const MobiSadArgs& a, int by, int dy, int ri, int t,
                                 const int32_t* row) {
  const int wb = a.W / 8;
  const int G = mobi_sad_groups(a.W);
  if (t >= G * wb) return;
  const int bx = t % wb;
  const int g = t / wb;
  const int side = 2 * a.r + 1;
  const int P = mobi_sad_pitch(a.W, a.r);
  int32_t c[64];
  const int32_t* src = a.cur + (long long)8 * by * a.W + 8 * bx;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i * 8 + j] = src[(long long)i * a.W + j];
  const long long plane = (long long)(a.H / 8) * wb;
  int32_t* out = a.vol + ((long long)dy * side * a.R + ri) * plane + (long long)by * wb + bx;
  for (int dx = g; dx < side; dx += G) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int32_t* rr = row + i * 8 * P + bx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = j + dx;  // column 8 bx + cc of the padded row
        acc += mobi_absdiff(c[i * 8 + j], rr[(cc & 7) * P + (cc >> 3)]);
      }
    }
    out[(long long)dx * a.R * plane] = (int32_t)acc;
  }
}
