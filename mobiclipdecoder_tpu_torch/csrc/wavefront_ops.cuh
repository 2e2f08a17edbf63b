// Code of the wavefront engine's frame round, written once for the GPU
// kernel K6 (wavefront.cu, nvcc) and for a host build (wavefront_host.cpp,
// g++) that the CPU tests hold against the JAX package.
//
// Replaces XLA code of mobiclipdecoder_tpu/models/pipeline.py (no
// pallas_call there): decode_frame_core (:343) under _decode_batch_jit
// (:368), with its three phases
//   mobi_wf_mc_pixel     _mc_kernel (:110), one pixel of one MC leaf;
//   mobi_wf_resid_block  _resid_kernel (:180) with _resid_block (:168), one
//                        inter residual block;
//   mobi_wf_intra_pixel  _intra_level_kernel (:254) with _plane_pred_batch
//                        (:210), one pixel of one intra op;
// and the fori_loop over the intra levels (:358) in mobi_wf_stream.  The
// plain PyTorch version is models/pipeline.py decode_frame_core_plain.
//
// Semantics kept from the functional engines:
//   * gathers clip (rows to [0, HH - 1], columns to [0, S - 1], the ring's
//     and the sequence map's flat index to their size); scatters drop every
//     pixel whose flat index lies outside [0, HH * S);
//   * padding rows write nothing: MC w <= 0, residual and intra size <= 0;
//   * every read of a phase (and of an intra level) sees the frame as it
//     stood before that phase's (level's) writes.  The planner orders a
//     level's ops by the last writer of each cell they read, but nothing in
//     it forbids an op of the level from rewriting a cell that another op of
//     the level reads (a pass-through op rewrites cells earlier ops wrote),
//     so K6 does not rely on it: phase 2 and each level compute their pixels
//     into the stream's stage buffer, and a barrier separates that from the
//     write-back.  Phase 1 reads only the ring, so it writes the frame
//     directly.
//
// What bounds it on the card: neither bytes nor operations but the serial
// chain of levels (214 in a DS I-frame round of 8 streams, 551 in a
// 640x480 I-frame), each a few barriers of one block; the bytes (plan
// arrays, the ring samples read, the frame written) come to about 0.9 MB
// per DS stream and frame (chip_smoke.py wavefront_work).  The design runs
// the whole frame round of a stream in one block, so a level costs
// barriers and no launch; the frame stays in global memory (L2) because a
// 640x480 frame does not fit in shared memory.
//
// Arithmetic is int32 with arithmetic right shifts, as in the JAX engine.
#pragma once
#include <stdint.h>

#include "prologue_ops.cuh"

#if defined(__CUDACC__)
#define MOBI_WF_HD __host__ __device__ __forceinline__
#else
#define MOBI_WF_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define MOBI_WF_MAX(p, v) atomicMax((p), (v))
#else
#define MOBI_WF_MAX(p, v) (*(p) = *(p) < (v) ? (v) : *(p))
#endif

#define MOBI_WF_NT 512      // threads of K6's block, one block per stream
#define MOBI_WF_KC 32       // intra ops staged in shared memory at a time
#define MOBI_WF_MODES 20    // rows of the intra tables (ops/intra_tables.py)

// Kinds of ops/intra_tables.py.
#define MOBI_WF_COPY 0
#define MOBI_WF_AVG2 1
#define MOBI_WF_AVG3 2
#define MOBI_WF_DC 3
#define MOBI_WF_PASS 4

// The operands of one frame round of B streams, each array contiguous with
// the stream axis first.
struct MobiWfArgs {
  const int32_t* ring;      // (B, 6, HH, S), slot r the frame r back
  const int32_t* mc;        // (B, M, 7): y, x, w, h, ref, dx, dy
  const int32_t* resid;     // (B, N, 4): plane, y, x, size
  const int32_t* rcoef;     // (B, N, 64)
  const int32_t* iops;      // (B, L, K, 11): plane, y, x, size, mode, grad,
                            //   has_coef, avail_top, avail_left, level, seq
  const int32_t* icoef;     // (B, L, K, 64)
  const int32_t* seqmap;    // (B, SR, S / 4)
  const int32_t* n_levels;  // (B,)
  const uint8_t* tables;    // KIND (20, 256), then TAPS (20, 256, 3)
  int32_t* out;             // (B, HH, S): the frame
  int32_t* stage;           // (B, max(N, K) * 256): staged pixels
  int H, S, M, N, L, K, SR;
};

// A block's shared memory (the host build's is one heap object).
struct MobiWfShared {
  uint8_t kind[MOBI_WF_MODES * 256];
  uint8_t taps[MOBI_WF_MODES * 256 * 3];
  int32_t tap[MOBI_WF_KC][33];   // corner, top 16, left 16
  int32_t res[MOBI_WF_KC][64];   // the op's residual, 8x8
  int32_t op[MOBI_WF_KC][11];
  int kmax[2];                   // a level's ops in use, by level parity
};

struct MobiWfGeom {
  int H, HH, S, Sc, nseq;
};

MOBI_WF_HD int mobi_wf_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Whether K6 takes these sizes: every count positive, S a multiple of 4 and
// every per-stream index inside int32.
MOBI_WF_HD bool mobi_wf_sizes_ok(long long B, int H, int S, int M, int N, int L, int K, int SR) {
  if (B < 1 || H < 2 || S < 4 || (S & 3) || M < 1 || N < 1 || L < 1 || K < 1 || SR < 1)
    return false;
  const long long HHS = (long long)(H + H / 2) * S;
  const long long big = 1LL << 30;
  return HHS * 6 < big && (long long)M * 384 < big && (long long)(N > K ? N : K) * 256 < big &&
         (long long)L * K * 64 < big && (long long)SR * (S >> 2) < big;
}

// _residual8 of one 64-coefficient record into an 8x8 tile at `out` with
// row pitch `pitch`: the 8x8 IDCT where `eight` holds, else the 4x4 IDCT of
// the first 16 coefficients in the top-left corner and zeros around it.
// Rows then columns, as ops/idct.py (the butterflies of the IDCT pre-pass).
MOBI_WF_HD void mobi_wf_idct(const int32_t* coef, bool eight, int32_t* out, int pitch) {
  int32_t c[64];
  if (eight) {
#pragma unroll
    for (int k = 0; k < 64; ++k) c[k] = coef[k];
    c[0] += 32;
#pragma unroll
    for (int r = 0; r < 8; ++r) mobi_btf8<1>(c + r * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) mobi_btf8<8>(c + i);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[i * pitch + j] = c[j * 8 + i] >> 6;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) c[k] = coef[k];
    c[0] += 32;
#pragma unroll
    for (int r = 0; r < 4; ++r) mobi_btf4<1>(c + r * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) mobi_btf4<4>(c + i);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[i * pitch + j] = (i < 4 && j < 4) ? c[j * 4 + i] >> 6 : 0;
  }
}

// One ring sample of a stream: slot `ref`, row and column clipped, the
// flat index clipped to the stream's ring (jnp.take's mode="clip").
MOBI_WF_HD int32_t mobi_wf_ring_at(const int32_t* ring, const MobiWfGeom& g, int ref, int row,
                                   int col) {
  const int64_t hhs = (int64_t)g.HH * g.S;
  int64_t f = (int64_t)ref * hhs + (int64_t)mobi_wf_clamp(row, 0, g.HH - 1) * g.S +
              mobi_wf_clamp(col, 0, g.S - 1);
  f = f < 0 ? 0 : (f > 6 * hhs - 1 ? 6 * hhs - 1 : f);
  return ring[f];
}

// Phase 1: pixel q of MC leaf `leaf` (q < 256: luma row q / 16, column
// q % 16; then 64 of U and 64 of V, each 8x8): the half-pel case of the
// (re-halved, for chroma) MV over the window at the MV's integer part,
// written into the frame.
MOBI_WF_HD void mobi_wf_mc_pixel(const int32_t* ring, const MobiWfGeom& g, const int32_t* leaf,
                                 int q, int32_t* frame) {
  const int y = leaf[0], x = leaf[1], w = leaf[2], h = leaf[3], ref = leaf[4];
  if (w <= 0) return;
  int i, j, yb, xb, oy, ox, bw, bh, ddx, ddy;
  if (q < 256) {
    i = q >> 4, j = q & 15;
    ddx = leaf[5], ddy = leaf[6];
    yb = y + (ddy >> 1), xb = x + (ddx >> 1);
    oy = y, ox = x, bw = w, bh = h;
  } else {
    q -= 256;
    const int xoff = (q >> 6) ? g.S / 2 : 0;
    i = (q >> 3) & 7, j = q & 7;
    ddx = leaf[5] >> 1, ddy = leaf[6] >> 1;
    yb = g.H + (y >> 1) + (ddy >> 1), xb = (x >> 1) + xoff + (ddx >> 1);
    oy = g.H + (y >> 1), ox = (x >> 1) + xoff, bw = w >> 1, bh = h >> 1;
  }
  if (i >= bh || j >= bw) return;
  const int64_t flat = (int64_t)(oy + i) * g.S + ox + j;
  if (flat < 0 || flat >= (int64_t)g.HH * g.S) return;
  const int32_t a = mobi_wf_ring_at(ring, g, ref, yb + i, xb + j);
  const int hcase = (ddx & 1) | ((ddy & 1) << 1);
  int32_t px;
  if (hcase == 0) {
    px = a;
  } else if (hcase == 1) {
    px = (a >> 1) + (mobi_wf_ring_at(ring, g, ref, yb + i, xb + j + 1) >> 1);
  } else if (hcase == 2) {
    px = (a >> 1) + (mobi_wf_ring_at(ring, g, ref, yb + i + 1, xb + j) >> 1);
  } else {
    const int32_t b = mobi_wf_ring_at(ring, g, ref, yb + i, xb + j + 1);
    const int32_t c = mobi_wf_ring_at(ring, g, ref, yb + i + 1, xb + j);
    const int32_t d = mobi_wf_ring_at(ring, g, ref, yb + i + 1, xb + j + 1);
    px = (((a >> 1) + (b >> 1)) >> 1) + (((c >> 1) + (d >> 1)) >> 1);
  }
  frame[flat] = px;
}

// Phase 2, compute: residual block `row` (plane, y, x, size) into its 16x16
// tile of the stage, `st` (row-major, pitch 16): the IDCT of `coef` (8x8
// where size == 8, else 4x4) added to the frame's clipped pixels and
// saturated.  Only the pixels the block writes are computed.
MOBI_WF_HD void mobi_wf_resid_block(const int32_t* frame, const MobiWfGeom& g,
                                    const int32_t* row, const int32_t* coef, int32_t* st) {
  const int size = row[3];
  if (size <= 0) return;
  const int row0 = row[1] + row[0] * g.H, x = row[2];
  const int n = size < 16 ? size : 16;
  mobi_wf_idct(coef, size == 8, st, 16);
  for (int ii = 0; ii < n; ++ii)
    for (int jj = 0; jj < n; ++jj) {
      const int32_t cur = frame[(int64_t)mobi_wf_clamp(row0 + ii, 0, g.HH - 1) * g.S +
                                mobi_wf_clamp(x + jj, 0, g.S - 1)];
      const int32_t res = (ii < 8 && jj < 8) ? st[ii * 16 + jj] : 0;
      st[ii * 16 + jj] = mobi_wf_clamp(cur + res, 0, 255);
    }
}

// The write-back of a staged 16x16 tile's pixel p for a block at (row0, x)
// of this size: the frame's flat index, or -1 where nothing is written.
MOBI_WF_HD int64_t mobi_wf_target(const MobiWfGeom& g, int row0, int x, int size, int p) {
  const int r = p >> 4, c = p & 15;
  if (size <= 0 || r >= size || c >= size) return -1;
  const int64_t flat = (int64_t)(row0 + r) * g.S + x + c;
  return (flat < 0 || flat >= (int64_t)g.HH * g.S) ? -1 : flat;
}

// The frame's pixel at (row, col), clipped, if the sequence map shows it
// written before op sequence `seq` (0 <= cell < seq), else 0.
MOBI_WF_HD int32_t mobi_wf_visible(const int32_t* frame, const int32_t* smap,
                                   const MobiWfGeom& g, int row, int col, int seq) {
  const int cr = mobi_wf_clamp(row, 0, g.HH - 1), cc = mobi_wf_clamp(col, 0, g.S - 1);
  const int cell = smap[mobi_wf_clamp((cr >> 2) * g.Sc + (cc >> 2), 0, g.nseq - 1)];
  return (cell >= 0 && cell < seq) ? frame[(int64_t)cr * g.S + cc] : 0;
}

// Tap t of intra op `op`: 0 the corner, 1-16 the row above from the
// block's column onward, 17-32 the column to the left.
MOBI_WF_HD int32_t mobi_wf_tap(const int32_t* frame, const int32_t* smap, const MobiWfGeom& g,
                               const int32_t* op, int t) {
  const int row0 = op[1] + op[0] * g.H, x = op[2];
  const int row = t <= 16 ? row0 - 1 : row0 + t - 17;
  const int col = (t == 0 || t > 16) ? x - 1 : x + t - 1;
  return mobi_wf_visible(frame, smap, g, row, col, op[10]);
}

// The plane predictor's value at (r, c) before the byte aliasing, with
// t = tap + 1 and l = tap + 17 (_plane_pred_batch's acc >> rshift).
MOBI_WF_HD int32_t mobi_wf_plane_value(const int32_t* tap, int size, int grad, int r, int c) {
  const int32_t* t = tap + 1;
  const int32_t* l = tap + 17;
  const bool n16 = size == 16, n4 = size == 4;
  const int nm1 = mobi_wf_clamp(size - 1, 0, 15);
  const int32_t tr = t[nm1], bl = l[nm1];
  const int32_t r5 = ((bl + tr + 1) >> 1) + 2 * grad;
  const int32_t r6 = n16 ? r5 - bl + 1 : r5 - bl;
  const int32_t r9 = n16 ? r5 - tr + 1 : r5 - tr;
  const int32_t tscale = n4 ? 4 : 8, ascale = n4 ? 16 : 64, rnd = n4 ? 16 : 64;
  const int32_t r4 = bl * tscale + (c + 1) * (n16 ? r6 >> 1 : r6);
  const int32_t bv = n16 ? r4 - t[c] * 8 + 1 : r4 - t[c] * tscale;
  const int32_t bt = n16 ? bv >> 1 : bv;
  const int32_t r10 = tr * tscale + (r + 1) * (n16 ? r9 >> 1 : r9);
  const int32_t r7 = n16 ? r10 - l[r] * 8 + 1 : r10 - l[r] * tscale;
  const int32_t r7t = n16 ? r7 >> 1 : r7;
  const int32_t acc = ascale * t[c] + (r + 1) * bt + ascale * l[r] + (c + 1) * r7t + rnd;
  return acc >> (n4 ? 5 : 7);
}

// The plane predictor at (r, c): the four values of the pixel's group of
// four columns composed into one u32 word (value k in byte k, each shifted
// in whole, the reference's word stores), and byte c % 4 read back.  Only
// the values at or left of c reach that byte.
MOBI_WF_HD int32_t mobi_wf_plane_pixel(const int32_t* tap, int size, int grad, int r, int c) {
  const int k = c & 3;
  uint32_t word = 0;
  for (int j = 0; j <= k; ++j)
    word |= (uint32_t)mobi_wf_plane_value(tap, size, grad, r, c - k + j) << (8 * j);
  return (int32_t)((word >> (8 * k)) & 0xFFu);
}

// The DC value of an op from its taps: the first npx (4 for size 4, else 8)
// of the top row and of the left column, by availability; 0x80 with
// neither.
MOBI_WF_HD int32_t mobi_wf_dc(const int32_t* tap, const int32_t* op) {
  const int size = op[3], av_t = op[7], av_l = op[8];
  const int npx = size == 4 ? 4 : 8, log_n = size == 4 ? 2 : 3;
  int32_t st = 0, sl = 0;
  for (int i = 0; i < npx; ++i) st += tap[1 + i], sl += tap[17 + i];
  if (av_t == 1 && av_l == 0) return (st + (npx >> 1)) >> log_n;
  if (av_l == 1 && av_t == 0) return (sl + (npx >> 1)) >> log_n;
  if (av_t == 1 && av_l == 1) return (st + sl + npx) >> (log_n + 1);
  return 0x80;
}

// Phase 3: pixel (r, c) of intra op `op` (its 33 taps and, if it has
// coefficients, its residual `res`, 8x8): the prediction of its mode (the
// plane predictor for modes 2 and 12, else the formula of KIND / TAPS, the
// current pixel for PASS), the residual added and saturated.
MOBI_WF_HD int32_t mobi_wf_intra_pixel(const int32_t* frame, const int32_t* smap,
                                       const MobiWfGeom& g, const int32_t* op,
                                       const int32_t* tap, const int32_t* res,
                                       const uint8_t* kind_t, const uint8_t* taps_t, int r,
                                       int c) {
  const int size = op[3], mode = op[4];
  const int p = mobi_wf_clamp(mode, 0, MOBI_WF_MODES - 1) * 256 + r * 16 + c;
  const int kind = kind_t[p];
  int32_t pred;
  if (mode == 2 || mode == 12) {
    pred = mobi_wf_plane_pixel(tap, size, op[5], r, c);
  } else if (kind == MOBI_WF_PASS) {
    pred = mobi_wf_visible(frame, smap, g, op[1] + op[0] * g.H + r, op[2] + c, op[10]);
  } else {
    const uint8_t* ts = taps_t + p * 3;
    const int32_t a = tap[ts[0]], b = tap[ts[1]], cc = tap[ts[2]];
    pred = kind == MOBI_WF_COPY   ? a
           : kind == MOBI_WF_AVG2 ? (a + b + 1) >> 1
           : kind == MOBI_WF_AVG3 ? (a + 2 * b + cc + 2) >> 2
           : kind == MOBI_WF_DC   ? mobi_wf_dc(tap, op)
                                  : 0;
  }
  if (op[6] != 1) return pred;
  return mobi_wf_clamp(pred + ((r < 8 && c < 8) ? res[r * 8 + c] : 0), 0, 255);
}

// Stream b's whole frame round: zero the frame; phase 1 (MC from the
// ring); phase 2 (inter residuals, staged); phase 3, levels 0 to
// min(n_levels[b], L) - 1, each: count the level's ops in use (one past the
// last of size > 0), then in chunks of MOBI_WF_KC ops gather their taps,
// rows and residuals into shared memory and compute their pixels into the
// stage; a barrier; write the staged pixels back.  On the card every thread
// of the stream's block calls this with its threadIdx.x and NT =
// MOBI_WF_NT; the host build calls it once per stream with tid 0 and NT =
// 1, so that each loop runs every thread's iterations in turn and the
// barriers fall at the loops' ends.
template <int NT>
MOBI_WF_HD void mobi_wf_stream(const MobiWfArgs& a, int64_t b, int tid, MobiWfShared& sh) {
  MobiWfGeom g;
  g.H = a.H, g.HH = a.H + a.H / 2, g.S = a.S, g.Sc = a.S >> 2, g.nseq = a.SR * (a.S >> 2);
  const int64_t hhs = (int64_t)g.HH * g.S;
  const int stride_stage = (a.N > a.K ? a.N : a.K) * 256;
  const int32_t* ring = a.ring + b * 6 * hhs;
  const int32_t* mc = a.mc + b * a.M * 7;
  const int32_t* resid = a.resid + b * a.N * 4;
  const int32_t* rcoef = a.rcoef + b * a.N * 64;
  const int32_t* smap = a.seqmap + b * g.nseq;
  int32_t* frame = a.out + b * hhs;
  int32_t* stage = a.stage + b * stride_stage;

  for (int i = tid; i < MOBI_WF_MODES * 256; i += NT) sh.kind[i] = a.tables[i];
  for (int i = tid; i < MOBI_WF_MODES * 256 * 3; i += NT)
    sh.taps[i] = a.tables[MOBI_WF_MODES * 256 + i];
  for (int64_t i = tid; i < hhs; i += NT) frame[i] = 0;
  if (tid == 0) sh.kmax[0] = 0;
  MOBI_SYNC();

  // phase 1: MC
  for (int e = tid; e < a.M * 384; e += NT) mobi_wf_mc_pixel(ring, g, mc + (e / 384) * 7, e % 384, frame);
  MOBI_SYNC();

  // phase 2: inter residuals, computed into the stage, then written back
  for (int n = tid; n < a.N; n += NT)
    mobi_wf_resid_block(frame, g, resid + n * 4, rcoef + n * 64, stage + n * 256);
  MOBI_SYNC();
  for (int e = tid; e < a.N * 256; e += NT) {
    const int32_t* row = resid + (e >> 8) * 4;
    const int64_t f = mobi_wf_target(g, row[1] + row[0] * g.H, row[2], row[3], e & 255);
    if (f >= 0) frame[f] = stage[e];
  }
  MOBI_SYNC();

  // phase 3: the intra levels
  const int nl = a.n_levels[b] < a.L ? a.n_levels[b] : a.L;
  for (int lv = 0; lv < nl; ++lv) {
    const int32_t* ops = a.iops + (b * a.L + lv) * a.K * 11;
    const int32_t* coefs = a.icoef + (b * a.L + lv) * a.K * 64;
    for (int k = tid; k < a.K; k += NT)
      if (ops[k * 11 + 3] > 0) MOBI_WF_MAX(&sh.kmax[lv & 1], k + 1);
    MOBI_SYNC();
    const int kmax = sh.kmax[lv & 1];
    if (tid == 0) sh.kmax[(lv + 1) & 1] = 0;
    for (int k0 = 0; k0 < kmax; k0 += MOBI_WF_KC) {
      const int kc = kmax - k0 < MOBI_WF_KC ? kmax - k0 : MOBI_WF_KC;
      for (int e = tid; e < kc * 33; e += NT) {
        const int k = e / 33, t = e - k * 33;
        const int32_t* op = ops + (k0 + k) * 11;
        sh.tap[k][t] = op[3] > 0 ? mobi_wf_tap(frame, smap, g, op, t) : 0;
      }
      for (int k = tid; k < kc; k += NT) {
        const int32_t* op = ops + (k0 + k) * 11;
        for (int w = 0; w < 11; ++w) sh.op[k][w] = op[w];
        if (op[3] > 0 && op[6] == 1) mobi_wf_idct(coefs + (k0 + k) * 64, op[3] != 4, sh.res[k], 8);
      }
      MOBI_SYNC();
      for (int e = tid; e < kc * 256; e += NT) {
        const int k = e >> 8, r = (e >> 4) & 15, c = e & 15;
        const int size = sh.op[k][3];
        if (size > 0 && r < size && c < size)
          stage[(k0 + k) * 256 + (e & 255)] = mobi_wf_intra_pixel(
              frame, smap, g, sh.op[k], sh.tap[k], sh.res[k], sh.kind, sh.taps, r, c);
      }
      MOBI_SYNC();
    }
    for (int e = tid; e < kmax * 256; e += NT) {
      const int32_t* op = ops + (e >> 8) * 11;
      const int64_t f = mobi_wf_target(g, op[1] + op[0] * g.H, op[2], op[3], e & 255);
      if (f >= 0) frame[f] = stage[e];
    }
    MOBI_SYNC();
  }
}
