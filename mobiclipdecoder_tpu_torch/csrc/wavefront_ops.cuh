// Code of the wavefront engine's GOP decode, written once for the GPU
// kernel K6 (wavefront.cu, nvcc) and for a host build (wavefront_host.cpp,
// g++) that the CPU tests hold against the JAX package.
//
// Replaces XLA code of the JAX package (no pallas_call there):
// decode_gop_jit (mobiclipdecoder_tpu/parallel/batch.py:58), a lax.scan
// over a GOP's frame rounds with the ring as carry (:40-55), each round
// decode_frame_core (mobiclipdecoder_tpu/models/pipeline.py:343) with its
// three phases
//   mobi_wf_phase_mc      _mc_kernel (:110), with mobi_wf_mc_pixel for one
//                         pixel of one MC leaf;
//   mobi_wf_phase_resid   _resid_kernel (:180) with _resid_block (:168),
//                         the inter residual blocks pixel by pixel;
//   mobi_wf_phase_levels  the fori_loop over the intra levels (:358), with
//                         mobi_wf_intra_pixel for one pixel of one op of
//                         _intra_level_kernel (:254) and _plane_pred_batch
//                         (:210);
// and mobi_wf_phase_commit for the scan's carry (the ring's slot update).
// The plain PyTorch version is models/pipeline.py decode_gop_plain (a loop
// of decode_frame_core_plain over the rounds).
//
// Semantics kept from the functional engines:
//   * gathers clip (rows to [0, HH - 1], columns to [0, S - 1], the ring's
//     and the sequence map's flat index to their size); scatters drop every
//     pixel whose flat index lies outside [0, HH * S);
//   * padding rows write nothing: MC w <= 0, residual and intra size <= 0;
//   * every read of a phase (and of an intra level) sees the frame as it
//     stood before that phase's (level's) writes.  Nothing in the planner
//     forbids an op of a level from rewriting a cell that another op of the
//     level reads, and edge blocks read clipped cells that their own or
//     other blocks' wrapped writes hit, so K6 relies on neither: MC writes
//     two copies of the frame, A and B; the residual phase reads A and
//     writes B; each intra level stages its pixels in shared memory and
//     writes them back into B after a barrier;
//   * the ring (B, 6, HH, S) keeps physical slots: logical slot r (the
//     frame r rounds back) is physical slot (head + r) mod 6, and each
//     round first steps head back by one (jnp.roll's shift by one, without
//     the copy).  MC clips the logical flat index to the ring's size, then
//     maps its slot to the physical one, so any ref reads what the plain
//     version reads.  The round's frame is built in the scratch frames, so
//     logical slot 0 still holds the stale frame while the round runs, and
//     the round's last pass copies it into its slot.
//
// What bounds it on the card: neither bytes nor operations but the serial
// chain of intra levels (214 in a DS I-frame round, 551 in a 640x480
// I-frame), each three barriers of one block; the bytes (plan arrays, the
// ring samples read, the frames written) come to about 1 MB per DS stream
// and frame (chip_smoke.py wavefront_work).  The design:
//   * one launch per GOP and shard: the rounds' operands are the views of
//     one upload, found through a per-round descriptor table;
//   * each stream gets a cluster of C blocks (MOBI_WF_NT threads each).
//     The wide phases (MC, the intra residual transforms, the inter
//     residuals, the end-of-round copy) split their work over the
//     cluster's blocks, with a cluster barrier between phases; the intra
//     levels run on the cluster's first block, the others wait at the
//     round's closing barrier;
//   * threads only on real pixels: each chunk of leaves, blocks or ops
//     gets an exclusive scan of its pixel counts, and a thread maps its
//     pixel index to (row, pixel) by a binary search of the scan;
//   * a level's op rows, taps, residuals (transformed ahead in the MC
//     phase) and staged pixels stay in shared memory, and the next level's
//     op rows load beside the current level's taps.
// The frames stay in global memory (L2): a 640x480 frame does not fit in
// shared memory.  Reads of what another block wrote go through L2
// (MOBI_WF_LD, __ldcg on the card).
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
#define MOBI_WF_LD(p) __ldcg(p)
#else
#define MOBI_WF_MAX(p, v) (*(p) = *(p) < (v) ? (v) : *(p))
#define MOBI_WF_LD(p) (*(p))
#endif

#define MOBI_WF_NT 512      // threads of each block of a stream's cluster
#define MOBI_WF_KC 64       // intra ops of a level gathered at a time
#define MOBI_WF_STAGE (MOBI_WF_KC * 256)   // a level's pixels staged in
                                           // shared memory; the rest spill
#define MOBI_WF_CH 128      // MC leaves or residual blocks of a chunk
#define MOBI_WF_MODES 20    // rows of the intra tables (ops/intra_tables.py)
#define MOBI_WF_DESC 12     // words of a round's descriptor (MobiWfRound)
#define MOBI_WF_CMAX 8      // the largest cluster (the portable limit)

// Kinds of ops/intra_tables.py.
#define MOBI_WF_COPY 0
#define MOBI_WF_AVG2 1
#define MOBI_WF_AVG3 2
#define MOBI_WF_DC 3
#define MOBI_WF_PASS 4

// One frame round's operands, each array contiguous with the stream axis
// first; the descriptor table holds per round the seven addresses, then M,
// N, L, K, SR, as 64-bit words.
struct MobiWfRound {
  const int32_t* mc;        // (B, M, 7): y, x, w, h, ref, dx, dy
  const int32_t* resid;     // (B, N, 4): plane, y, x, size
  const int32_t* rcoef;     // (B, N, 64)
  const int32_t* iops;      // (B, L, K, 11): plane, y, x, size, mode, grad,
                            //   has_coef, avail_top, avail_left, level, seq
  const int32_t* icoef;     // (B, L, K, 64)
  const int32_t* seqmap;    // (B, SR, S / 4)
  const int32_t* n_levels;  // (B,)
  int M, N, L, K, SR;
};

// The operands of one GOP of F rounds of B streams.
struct MobiWfArgs {
  int32_t* ring;            // (B, 6, HH, S), physical slots
  const long long* desc;    // (F, MOBI_WF_DESC)
  const uint8_t* tables;    // KIND (20, 256), then TAPS (20, 256, 3)
  int32_t* fa;              // (B, HH, S) scratch: MC's frame
  int32_t* fb;              // (B, HH, S) scratch: the round's frame
  int32_t* ires;            // (B, ires_stride): the intra residuals
  int32_t* klev;            // (B, lmax): each level's ops in use
  int32_t* ovf;             // (B, 2 ovf_stride): a level's staged pixels
                            //   past MOBI_WF_STAGE, (value, target) pairs
  uint8_t* out8;            // (F, B, HH, S) or null
  int32_t* out32;           // (F, B, HH, S) or null
  long long B, ires_stride, ovf_stride;
  int lmax, H, S, F, head, commit, C;
};

// A block's shared memory (the host build's is one heap object).  The
// residual chunk and a level's stage are never live together.
struct MobiWfShared {
  uint8_t kind[MOBI_WF_MODES * 256];
  uint8_t taps[MOBI_WF_MODES * 256 * 3];
  alignas(16) int32_t res[MOBI_WF_KC][64];   // the op's residual, 8x8
  int32_t tap[MOBI_WF_KC][33];   // corner, top 16, left 16
  int32_t op[2][MOBI_WF_KC][11];            // a level chunk's op rows,
  int32_t loff[2][MOBI_WF_KC + 1];          // its pixel scan and its
  int32_t kmax[2];                          // level's ops in use, by parity
  int32_t off[MOBI_WF_CH + 1];   // an MC or residual chunk's pixel scan
  union {
    struct {
      int32_t px[MOBI_WF_STAGE];      // a level's staged pixels
      int32_t tgt[MOBI_WF_STAGE];     // and the flat index of each, or -1
    } stage;
    int32_t rres[MOBI_WF_CH][64];     // a residual chunk's transforms
  } u;
};

struct MobiWfGeom {
  int H, HH, S, Sc, nseq;
};

MOBI_WF_HD int mobi_wf_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Whether K6 takes one round's sizes: every count positive, S a multiple
// of 4 and every per-stream index inside int32.
MOBI_WF_HD bool mobi_wf_sizes_ok(long long B, int H, int S, long long M, long long N, long long L,
                                 long long K, long long SR) {
  if (B < 1 || H < 2 || S < 4 || (S & 3) || M < 1 || N < 1 || L < 1 || K < 1 || SR < 1)
    return false;
  const long long HHS = (long long)(H + H / 2) * S;
  const long long big = 1LL << 30;
  return HHS * 6 < big && M * 7 < big && N * 64 < big && L * K * 64 < big && SR * (S >> 2) < big;
}

// Whether K6 takes a GOP: each round's sizes, its levels inside the
// scratch (L <= lmax, L * K * 64 <= ires_stride, K * 256 <= MOBI_WF_STAGE
// + ovf_stride), a head in [0, 6), a cluster of 1 to MOBI_WF_CMAX blocks,
// and a ring left alone only for F=1.
MOBI_WF_HD bool mobi_wf_gop_ok(const long long* desc, long long B, int H, int S, int F, int head,
                               int commit, int C, int lmax, long long ires_stride,
                               long long ovf_stride) {
  if (F < 1 || head < 0 || head > 5 || C < 1 || C > MOBI_WF_CMAX || (!commit && F != 1) ||
      B * C > 0x7FFFFFFFLL)
    return false;
  for (int f = 0; f < F; ++f) {
    const long long* d = desc + (long long)f * MOBI_WF_DESC;
    if (!mobi_wf_sizes_ok(B, H, S, d[7], d[8], d[9], d[10], d[11]) || d[9] > lmax ||
        d[9] * d[10] * 64 > ires_stride || d[10] * 256 > MOBI_WF_STAGE + ovf_stride)
      return false;
  }
  return true;
}

MOBI_WF_HD MobiWfRound mobi_wf_round(const long long* desc, int f) {
  const long long* d = desc + (long long)f * MOBI_WF_DESC;
  MobiWfRound r;
  r.mc = (const int32_t*)(uintptr_t)d[0];
  r.resid = (const int32_t*)(uintptr_t)d[1];
  r.rcoef = (const int32_t*)(uintptr_t)d[2];
  r.iops = (const int32_t*)(uintptr_t)d[3];
  r.icoef = (const int32_t*)(uintptr_t)d[4];
  r.seqmap = (const int32_t*)(uintptr_t)d[5];
  r.n_levels = (const int32_t*)(uintptr_t)d[6];
  r.M = (int)d[7], r.N = (int)d[8], r.L = (int)d[9], r.K = (int)d[10], r.SR = (int)d[11];
  return r;
}

// off[0, n] = the exclusive scan of cnt(0) .. cnt(n - 1), off[n] the
// total; n <= MOBI_WF_CH.  On the card the block's last warp computes it
// (4 items a lane, a shuffle scan of the lanes' sums); the caller's next
// barrier publishes it.
template <int NT, class Cnt>
MOBI_WF_HD void mobi_wf_scan(int n, int tid, int32_t* off, Cnt cnt) {
#if defined(__CUDA_ARCH__)
  static_assert(MOBI_WF_CH == 4 * 32, "four items a lane");
  tid -= NT - 32;
  if (tid >= 0) {
    int v[4], s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid * 4 + j;
      v[j] = i < n ? cnt(i) : 0;
      s += v[j];
    }
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += t;
    }
    int run = incl - s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid * 4 + j;
      if (i < n) off[i] = run;
      run += v[j];
    }
    if (tid == 31) off[n] = incl;
  }
#else
  (void)tid;
  int run = 0;
  for (int i = 0; i < n; ++i) off[i] = run, run += cnt(i);
  off[n] = run;
#endif
}

// The item of pixel e of a chunk: the last k with off[k] <= e (off[0] = 0
// <= e < off[n]); items of no pixels are passed over.
MOBI_WF_HD int mobi_wf_find(const int32_t* off, int n, int e) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
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

// One ring sample of a stream: logical slot `ref`, row and column clipped,
// the logical flat index clipped to the stream's ring (jnp.take's
// mode="clip"), then its slot mapped to the physical one.  The clipped
// cell lies inside one slot, so the flat index leaves the ring only by its
// slot: a ref below 0 reads the ring's first sample, one above 5 its last.
MOBI_WF_HD int32_t mobi_wf_ring_at(const int32_t* ring, const MobiWfGeom& g, int head, int ref,
                                   int row, int col) {
  const int64_t hhs = (int64_t)g.HH * g.S;
  int64_t cell = (int64_t)mobi_wf_clamp(row, 0, g.HH - 1) * g.S + mobi_wf_clamp(col, 0, g.S - 1);
  if (ref < 0) ref = 0, cell = 0;
  if (ref > 5) ref = 5, cell = hhs - 1;
  const int slot = head + ref < 6 ? head + ref : head + ref - 6;
  return MOBI_WF_LD(ring + slot * hhs + cell);
}

// p = q * n + r for 0 <= p and 0 < n: shifts where n is a power of two (the
// block sizes 4, 8 and 16), else a division.
MOBI_WF_HD void mobi_wf_divmod(int p, int n, int& q, int& r) {
  if ((n & (n - 1)) == 0) {
#if defined(__CUDA_ARCH__)
    const int sh = __ffs(n) - 1;
#else
    const int sh = __builtin_ctz((unsigned)n);
#endif
    q = p >> sh, r = p & (n - 1);
  } else {
    q = p / n, r = p - (p / n) * n;
  }
}

// The pixels an MC leaf writes at most: its luma block (16x16 at most),
// then its U and V blocks (8x8 at most each); 0 for w <= 0.
MOBI_WF_HD int mobi_wf_leaf_pixels(const int32_t* leaf) {
  const int w = leaf[2], h = leaf[3];
  if (w <= 0) return 0;
  const int lw = mobi_wf_clamp(w, 0, 16), lh = mobi_wf_clamp(h, 0, 16);
  const int cw = mobi_wf_clamp(w >> 1, 0, 8), ch = mobi_wf_clamp(h >> 1, 0, 8);
  return lw * lh + 2 * cw * ch;
}

// Phase 1: pixel p of MC leaf `leaf` (p < mobi_wf_leaf_pixels: the luma
// block row by row, then U, then V): the half-pel case of the (re-halved,
// for chroma) MV over the window at the MV's integer part, written into
// both scratch frames.
MOBI_WF_HD void mobi_wf_mc_pixel(const int32_t* ring, const MobiWfGeom& g, int head,
                                 const int32_t* leaf, int p, int32_t* fa, int32_t* fb) {
  const int y = leaf[0], x = leaf[1], w = leaf[2], h = leaf[3], ref = leaf[4];
  const int lw = mobi_wf_clamp(w, 0, 16), lh = mobi_wf_clamp(h, 0, 16);
  int i, j, yb, xb, oy, ox, ddx, ddy;
  if (p < lw * lh) {
    mobi_wf_divmod(p, lw, i, j);
    ddx = leaf[5], ddy = leaf[6];
    yb = y + (ddy >> 1), xb = x + (ddx >> 1);
    oy = y, ox = x;
  } else {
    const int cw = mobi_wf_clamp(w >> 1, 0, 8), ch = mobi_wf_clamp(h >> 1, 0, 8);
    p -= lw * lh;
    const int xoff = p >= cw * ch ? g.S / 2 : 0;
    p -= p >= cw * ch ? cw * ch : 0;
    mobi_wf_divmod(p, cw, i, j);
    ddx = leaf[5] >> 1, ddy = leaf[6] >> 1;
    yb = g.H + (y >> 1) + (ddy >> 1), xb = (x >> 1) + xoff + (ddx >> 1);
    oy = g.H + (y >> 1), ox = (x >> 1) + xoff;
  }
  const int64_t flat = (int64_t)(oy + i) * g.S + ox + j;
  if (flat < 0 || flat >= (int64_t)g.HH * g.S) return;
  const int32_t a = mobi_wf_ring_at(ring, g, head, ref, yb + i, xb + j);
  const int hcase = (ddx & 1) | ((ddy & 1) << 1);
  int32_t px;
  if (hcase == 0) {
    px = a;
  } else if (hcase == 1) {
    px = (a >> 1) + (mobi_wf_ring_at(ring, g, head, ref, yb + i, xb + j + 1) >> 1);
  } else if (hcase == 2) {
    px = (a >> 1) + (mobi_wf_ring_at(ring, g, head, ref, yb + i + 1, xb + j) >> 1);
  } else {
    const int32_t b = mobi_wf_ring_at(ring, g, head, ref, yb + i, xb + j + 1);
    const int32_t c = mobi_wf_ring_at(ring, g, head, ref, yb + i + 1, xb + j);
    const int32_t d = mobi_wf_ring_at(ring, g, head, ref, yb + i + 1, xb + j + 1);
    px = (((a >> 1) + (b >> 1)) >> 1) + (((c >> 1) + (d >> 1)) >> 1);
  }
  fa[flat] = px;
  fb[flat] = px;
}

// The pixels a residual block or an intra op of this size writes at most:
// an n x n block, n = min(size, 16); none for size <= 0.
MOBI_WF_HD int mobi_wf_block_pixels(int size) {
  const int n = size < 16 ? size : 16;
  return size > 0 ? n * n : 0;
}

// The frame's pixel at (row, col), clipped, if the sequence map shows it
// written before op sequence `seq` (0 <= cell < seq), else 0.
MOBI_WF_HD int32_t mobi_wf_visible(const int32_t* frame, const int32_t* smap,
                                   const MobiWfGeom& g, int row, int col, int seq) {
  const int cr = mobi_wf_clamp(row, 0, g.HH - 1), cc = mobi_wf_clamp(col, 0, g.S - 1);
  const int cell = smap[mobi_wf_clamp((cr >> 2) * g.Sc + (cc >> 2), 0, g.nseq - 1)];
  const int32_t v = MOBI_WF_LD(frame + (int64_t)cr * g.S + cc);   // beside the cell's load
  return (cell >= 0 && cell < seq) ? v : 0;
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

// ---------------------------------------------------------------- phases
// Each phase below is run by every thread of one block of stream b's
// cluster: block `rank` of C, thread tid of NT.  On the card the kernel
// puts a cluster barrier between phases; the host build runs the ranks of
// a phase one after another with NT = 1 and tid 0, so that each loop runs
// every thread's iterations in turn and the block barriers fall at the
// loops' ends.

struct MobiWfStream {
  MobiWfGeom g;
  int64_t hhs;
  int32_t* ring;   // the stream's 6 physical slots
  int32_t* fa;
  int32_t* fb;
  int32_t* ires;
  int32_t* klev;
};

MOBI_WF_HD MobiWfStream mobi_wf_stream(const MobiWfArgs& a, int64_t b, int SR) {
  MobiWfStream s;
  s.g.H = a.H, s.g.HH = a.H + a.H / 2, s.g.S = a.S, s.g.Sc = a.S >> 2, s.g.nseq = SR * (a.S >> 2);
  s.hhs = (int64_t)s.g.HH * s.g.S;
  s.ring = a.ring + b * 6 * s.hhs;
  s.fa = a.fa + b * s.hhs;
  s.fb = a.fb + b * s.hhs;
  s.ires = a.ires + b * a.ires_stride;
  s.klev = a.klev + b * a.lmax;
  return s;
}

// [lo, hi) of n items for block rank of C.
MOBI_WF_HD void mobi_wf_share(int n, int rank, int C, int& lo, int& hi) {
  lo = (int)((int64_t)n * rank / C), hi = (int)((int64_t)n * (rank + 1) / C);
}

// Before the first round: zero both scratch frames and the level table,
// split over the cluster; the first block loads the intra tables.
template <int NT>
MOBI_WF_HD void mobi_wf_init(const MobiWfArgs& a, int64_t b, int rank, int tid, MobiWfShared& sh) {
  const MobiWfStream s = mobi_wf_stream(a, b, 1);
  const int64_t step = (int64_t)a.C * NT;
  for (int64_t i = (int64_t)rank * NT + tid; i < s.hhs; i += step) s.fa[i] = 0, s.fb[i] = 0;
  for (int64_t i = (int64_t)rank * NT + tid; i < a.lmax; i += step) s.klev[i] = 0;
  if (rank == 0) {
    for (int i = tid; i < MOBI_WF_MODES * 256; i += NT) sh.kind[i] = a.tables[i];
    for (int i = tid; i < MOBI_WF_MODES * 256 * 3; i += NT)
      sh.taps[i] = a.tables[MOBI_WF_MODES * 256 + i];
  }
}

// Phase 1 of round f, head the round's physical slot 0: MC, this block's
// share of the leaves in chunks of MOBI_WF_CH, a thread per pixel; then its
// share of the intra ops of the stream's levels: each level's ops in use
// (one past the last of size > 0) and the residuals of those with
// coefficients, into ires.
template <int NT>
MOBI_WF_HD void mobi_wf_phase_mc(const MobiWfArgs& a, const MobiWfRound& rd, int64_t b, int head,
                                 int rank, int tid, MobiWfShared& sh) {
  const MobiWfStream s = mobi_wf_stream(a, b, rd.SR);
  const int32_t* mc = rd.mc + b * rd.M * 7;
  int lo, hi;
  mobi_wf_share(rd.M, rank, a.C, lo, hi);
  for (int m0 = lo; m0 < hi; m0 += MOBI_WF_CH) {
    const int n = hi - m0 < MOBI_WF_CH ? hi - m0 : MOBI_WF_CH;
    const int32_t* leaves = mc + (int64_t)m0 * 7;
    mobi_wf_scan<NT>(n, tid, sh.off, [&](int i) { return mobi_wf_leaf_pixels(leaves + i * 7); });
    MOBI_SYNC();
    const int total = sh.off[n];
    for (int e = tid; e < total; e += NT) {
      const int k = mobi_wf_find(sh.off, n, e);
      mobi_wf_mc_pixel(s.ring, s.g, head, leaves + k * 7, e - sh.off[k], s.fa, s.fb);
    }
    MOBI_SYNC();
  }
  const int nl = rd.n_levels[b] < rd.L ? rd.n_levels[b] : rd.L;
  const int64_t items = (int64_t)nl * rd.K;
  const int32_t* ops = rd.iops + b * rd.L * rd.K * 11;
  const int32_t* coefs = rd.icoef + b * rd.L * rd.K * 64;
  for (int64_t i = (int64_t)rank * NT + tid; i < items; i += (int64_t)a.C * NT) {
    const int32_t* op = ops + i * 11;
    if (op[3] <= 0) continue;
    MOBI_WF_MAX(s.klev + i / rd.K, (int)(i % rd.K) + 1);
    if (op[6] == 1) mobi_wf_idct(coefs + i * 64, op[3] != 4, s.ires + i * 64, 8);
  }
}

// Phase 2: the inter residuals, this block's share of the blocks in
// chunks of MOBI_WF_CH: the chunk's transforms into shared memory and its
// pixel scan, then a thread per pixel reads MC's frame (A), adds and
// saturates, and writes the round's frame (B).
template <int NT>
MOBI_WF_HD void mobi_wf_phase_resid(const MobiWfArgs& a, const MobiWfRound& rd, int64_t b,
                                    int rank, int tid, MobiWfShared& sh) {
  const MobiWfStream s = mobi_wf_stream(a, b, rd.SR);
  const MobiWfGeom& g = s.g;
  int lo, hi;
  mobi_wf_share(rd.N, rank, a.C, lo, hi);
  for (int n0 = lo; n0 < hi; n0 += MOBI_WF_CH) {
    const int n = hi - n0 < MOBI_WF_CH ? hi - n0 : MOBI_WF_CH;
    const int32_t* rows = rd.resid + (b * rd.N + n0) * 4;
    const int32_t* coefs = rd.rcoef + (b * rd.N + n0) * 64;
    for (int k = tid; k < n; k += NT)
      if (rows[k * 4 + 3] > 0) mobi_wf_idct(coefs + k * 64, rows[k * 4 + 3] == 8, sh.u.rres[k], 8);
    mobi_wf_scan<NT>(n, tid, sh.off, [&](int i) { return mobi_wf_block_pixels(rows[i * 4 + 3]); });
    MOBI_SYNC();
    const int total = sh.off[n];
    for (int e = tid; e < total; e += NT) {
      const int k = mobi_wf_find(sh.off, n, e);
      const int32_t* row = rows + k * 4;
      const int size = row[3], nn = size < 16 ? size : 16;
      int ii, jj;
      mobi_wf_divmod(e - sh.off[k], nn, ii, jj);
      const int row0 = row[1] + row[0] * g.H, x = row[2];
      const int32_t cur = MOBI_WF_LD(s.fa + (int64_t)mobi_wf_clamp(row0 + ii, 0, g.HH - 1) * g.S +
                                     mobi_wf_clamp(x + jj, 0, g.S - 1));
      const int32_t res = (ii < 8 && jj < 8) ? sh.u.rres[k][ii * 8 + jj] : 0;
      const int64_t flat = (int64_t)(row0 + ii) * g.S + x + jj;
      if (flat >= 0 && flat < s.hhs) s.fb[flat] = mobi_wf_clamp(cur + res, 0, 255);
    }
    MOBI_SYNC();
  }
}

// A level chunk's loads that do not read the frame, into buffer p: the op
// rows of slots k0 .. k0 + MOBI_WF_KC - 1 (at most K - k0), their pixel
// scan, and the level's ops in use.  The caller's next barrier publishes
// them.
template <int NT>
MOBI_WF_HD void mobi_wf_level_load(const int32_t* ops, int K, int k0, const int32_t* kmax,
                                   int tid, MobiWfShared& sh, int p) {
  const int kc = K - k0 < MOBI_WF_KC ? K - k0 : MOBI_WF_KC;
  const int32_t* cops = ops + (int64_t)k0 * 11;
  for (int e = tid; e < kc * 11; e += NT) sh.op[p][e / 11][e % 11] = cops[e];
  if (tid == 0) sh.kmax[p] = MOBI_WF_LD(kmax);
  mobi_wf_scan<NT>(kc, tid, sh.loff[p],
                   [&](int i) { return mobi_wf_block_pixels(cops[i * 11 + 3]); });
}

// Phase 3, the first block only: levels 0 to min(n_levels[b], L) - 1 on
// the round's frame (B).  A level runs in chunks of MOBI_WF_KC of its ops
// in use (its op rows and pixel scan in shared memory ahead of it), each:
// gather the chunk's taps and residuals into shared memory, the first
// chunk's threads loading the next level's op rows beside them; a barrier;
// a thread per pixel computes it and its target into the level's stage
// (shared memory, past MOBI_WF_STAGE pixels the stream's overflow); a
// barrier.  Then the level's staged pixels are written back while the last
// warp scans the next level's pixel counts, and a barrier closes the
// level, so that every read of the level comes before its first write.
template <int NT>
MOBI_WF_HD void mobi_wf_phase_levels(const MobiWfArgs& a, const MobiWfRound& rd, int64_t b,
                                     int tid, MobiWfShared& sh) {
  const MobiWfStream s = mobi_wf_stream(a, b, rd.SR);
  const MobiWfGeom& g = s.g;
  const int32_t* smap = rd.seqmap + b * g.nseq;
  const int32_t* iops = rd.iops + b * rd.L * rd.K * 11;
  int32_t* ovf = a.ovf + b * 2 * a.ovf_stride;
  const int nl = rd.n_levels[b] < rd.L ? rd.n_levels[b] : rd.L;
  const int kl = rd.K < MOBI_WF_KC ? rd.K : MOBI_WF_KC;   // a level's first chunk
  if (nl > 0) mobi_wf_level_load<NT>(iops, rd.K, 0, s.klev, tid, sh, 0);
  MOBI_SYNC();
  for (int lv = 0; lv < nl; ++lv) {
    const int p = lv & 1;
    const int64_t lbase = (int64_t)lv * rd.K;
    const int32_t* ops = iops + lbase * 11;
    const int kmax = sh.kmax[p];
    const bool ahead = kmax > 0 && lv + 1 < nl;   // next level loaded beside this one
    int staged = 0;
    if (kmax == 0 && lv + 1 < nl) {
      mobi_wf_level_load<NT>(ops + rd.K * 11, rd.K, 0, s.klev + lv + 1, tid, sh, p ^ 1);
      MOBI_SYNC();
    }
    for (int k0 = 0; k0 < kmax; k0 += MOBI_WF_KC) {
      if (k0 > 0) {
        mobi_wf_level_load<NT>(ops, rd.K, k0, s.klev + lv, tid, sh, p);
        MOBI_SYNC();
      }
      const int kc = kmax - k0 < MOBI_WF_KC ? kmax - k0 : MOBI_WF_KC;
      const int nw = ahead && k0 == 0 ? kl * 11 : 0;
      const int jobs = kc * 49 > nw ? kc * 49 : nw;
      const int32_t nk = nw && tid == NT - 1 ? MOBI_WF_LD(s.klev + lv + 1) : 0;
      for (int e = tid; e < jobs; e += NT) {
        // loads first, side by side: a tap (or 4 residual words) and a word
        // of the next level's op rows
        int32_t tv = 0, ow = 0, rv[4] = {0, 0, 0, 0};
        bool res = false;
        if (e < kc * 33) {
          const int32_t* op = sh.op[p][e / 33];
          if (op[3] > 0) tv = mobi_wf_tap(s.fb, smap, g, op, e % 33);
        } else if (e < kc * 49) {
          const int k = (e - kc * 33) >> 4, q = (e - kc * 33) & 15;
          const int32_t* op = sh.op[p][k];
          const int32_t* src = s.ires + (lbase + k0 + k) * 64 + q * 4;
          if (op[3] > 0 && op[6] == 1) {
            res = true;
#if defined(__CUDA_ARCH__)
            const int4 v = __ldcg(reinterpret_cast<const int4*>(src));
            rv[0] = v.x, rv[1] = v.y, rv[2] = v.z, rv[3] = v.w;
#else
            for (int j = 0; j < 4; ++j) rv[j] = src[j];
#endif
          }
        }
        if (e < nw) ow = ops[rd.K * 11 + e];
        if (e < kc * 33) {
          sh.tap[e / 33][e % 33] = tv;
        } else if (res) {
          const int k = (e - kc * 33) >> 4, q = (e - kc * 33) & 15;
          for (int j = 0; j < 4; ++j) sh.res[k][q * 4 + j] = rv[j];
        }
        if (e < nw) sh.op[p ^ 1][e / 11][e % 11] = ow;
      }
      if (nw && tid == NT - 1) sh.kmax[p ^ 1] = nk;
      MOBI_SYNC();
      const int total = sh.loff[p][kc];
      for (int e = tid; e < total; e += NT) {
        const int k = mobi_wf_find(sh.loff[p], kc, e);
        const int32_t* op = sh.op[p][k];
        const int size = op[3], nn = size < 16 ? size : 16;
        int r, c;
        mobi_wf_divmod(e - sh.loff[p][k], nn, r, c);
        const int32_t v = mobi_wf_intra_pixel(s.fb, smap, g, op, sh.tap[k], sh.res[k], sh.kind,
                                              sh.taps, r, c);
        const int64_t flat = (int64_t)(op[1] + op[0] * g.H + r) * g.S + op[2] + c;
        const int32_t tgt = (flat >= 0 && flat < s.hhs) ? (int32_t)flat : -1;
        const int i = staged + e;
        if (i < MOBI_WF_STAGE) {
          sh.u.stage.px[i] = v, sh.u.stage.tgt[i] = tgt;
        } else {
          ovf[2 * (i - MOBI_WF_STAGE)] = v, ovf[2 * (i - MOBI_WF_STAGE) + 1] = tgt;
        }
      }
      staged += total;
      MOBI_SYNC();
    }
    for (int i = tid; i < staged; i += NT) {
      int32_t v, tgt;
      if (i < MOBI_WF_STAGE) {
        v = sh.u.stage.px[i], tgt = sh.u.stage.tgt[i];
      } else {
        v = MOBI_WF_LD(ovf + 2 * (i - MOBI_WF_STAGE));
        tgt = MOBI_WF_LD(ovf + 2 * (i - MOBI_WF_STAGE) + 1);
      }
      if (tgt >= 0) s.fb[tgt] = v;
    }
    if (ahead)
      mobi_wf_scan<NT>(kl, tid, sh.loff[p ^ 1],
                       [&](int i) { return mobi_wf_block_pixels(sh.op[p ^ 1][i][3]); });
    if (staged > 0) MOBI_SYNC();
  }
}

// Phase 4: the round's frame (B) into its ring slot (physical slot head,
// unless the ring is left alone) and into the outputs as uint8 and int32
// where asked; both scratch frames and the level table zeroed for the next
// round.  Split over the cluster, four pixels at a time (HH * S is a
// multiple of 4).
template <int NT>
MOBI_WF_HD void mobi_wf_phase_commit(const MobiWfArgs& a, int f, int64_t b, int head, int rank,
                                     int tid) {
  const MobiWfStream s = mobi_wf_stream(a, b, 1);
  const int64_t step = (int64_t)a.C * NT, quads = s.hhs >> 2;
  const int64_t obase = ((int64_t)f * a.B + b) * s.hhs;
  int32_t* slot = s.ring + head * s.hhs;
  for (int64_t q = (int64_t)rank * NT + tid; q < quads; q += step) {
#if defined(__CUDA_ARCH__)
    const int4 v = __ldcg(reinterpret_cast<const int4*>(s.fb) + q);
    const int4 z = make_int4(0, 0, 0, 0);
    if (a.commit) reinterpret_cast<int4*>(slot)[q] = v;
    if (a.out32) reinterpret_cast<int4*>(a.out32 + obase)[q] = v;
    if (a.out8)
      reinterpret_cast<uchar4*>(a.out8 + obase)[q] =
          make_uchar4((uint8_t)v.x, (uint8_t)v.y, (uint8_t)v.z, (uint8_t)v.w);
    reinterpret_cast<int4*>(s.fa)[q] = z;
    reinterpret_cast<int4*>(s.fb)[q] = z;
#else
    for (int64_t i = q * 4; i < q * 4 + 4; ++i) {
      const int32_t v = s.fb[i];
      if (a.commit) slot[i] = v;
      if (a.out32) a.out32[obase + i] = v;
      if (a.out8) a.out8[obase + i] = (uint8_t)v;
      s.fa[i] = 0, s.fb[i] = 0;
    }
#endif
  }
  for (int64_t i = (int64_t)rank * NT + tid; i < a.lmax; i += step) s.klev[i] = 0;
}

// The physical slot that round f's frame goes to: head steps back by one
// each round (logical slot r of round f is physical (head_f + r) mod 6).
MOBI_WF_HD int mobi_wf_head(int head, int f) { return (head + 5 * (f + 1)) % 6; }
