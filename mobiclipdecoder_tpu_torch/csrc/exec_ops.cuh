// Per-op logic of the whole-GOP executor, written once for the GPU kernel
// (gop_executor.cu, nvcc) and for a host build (exec_host.cpp, g++) that the
// CPU tests hold against the plain PyTorch executor (ops/executor_ref.py).
//
// Replaces the Pallas kernel body _make_kernel(..., fused=(B, nct, stage))
// launched by _build_gop_executor in mobiclipdecoder_tpu/ops/vmem_engine.py.
//
// Execution model (the one-block form; the cluster form at the end of this
// file walks the same ops by macroblock row): one thread block per stream,
// of MOBI_NT compute threads (one per pixel of a 16x16 block) and MOBI_NF
// copy threads.  The block walks its stream's op chunks, and the ops inside
// each chunk, strictly in decode order.  MOBI_PAR runs one barrier phase: on the device every thread
// runs the body once and the block synchronises; on the host a loop over the
// thread index runs the same body.  Every op takes one phase, except a luma
// quad batch, which takes one phase per present sub-block (each reads the
// pixels its predecessors wrote).  An intra op reads its taps straight from
// the plane in the phase that writes its block: the taps (row r - 1 and
// column c - 1 of each block) lie outside every block the phase writes.
//
// Storage is uint8 in global memory: every stored value is a clipped pixel.
//   ring   (B, 6, R, SP)   frame f writes slot (5 - f) mod 6, reference r of
//                          frame f reads slot (5 - f + r) mod 6
//   frames (F, B, R, SP)   the decoded frames
// with R = G8 * 8 rows (8 top margin rows, Y then packed U|V rows, >= 17
// slack rows) and SP = S + 128 columns (8 left margin columns).
//
// The working plane of the frame being decoded is either
//   * in shared memory (SM = true): rows [MR, MR + HH) by columns [0, RW),
//     RW = S + 16 (MCOL + S rounded up to 16 bytes).  Every op the scanner
//     emits writes inside it (luma blocks at rows [MR, MR + H), chroma at
//     [MR + H, MR + HH), columns [MCOL, MCOL + S)); a read outside it returns
//     0, which is what the plane in global memory holds there.  The frame is
//     zeroed at its first chunk and written to frames[f] and its ring slot,
//     margins included, at its last; or
//   * frames[f] itself in global memory (SM = false), zeroed at the frame's
//     first chunk and copied to the ring slot at its last.
// The wrapper picks shared memory where it fits (mobi_smem_bytes).
//
// Inputs that do not depend on the frame being decoded are copied ahead
// into shared memory: the next chunk's op rows (double-buffered), and for
// each op its coefficient rows and the reference-window segments its MC
// reads, MOBI_K - 1 ops ahead of the op being computed, by the copy threads
// (a ring of MOBI_K slots; cp.async on the device, plain copies on the
// host).  Copies never
// cross a chunk, so they never run past a frame's ring commit, which the
// next frame's MC reads.  The intra tables (20 KB, read-only) are read
// where they are used, through the read-only cache.
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>

#if defined(__CUDACC__)
#define MOBI_HD __host__ __device__
#else
#define MOBI_HD
#endif

#define MOBI_NT 256       // compute threads per stream (one per pixel of a 16x16 block)
#define MOBI_NF 96        // copy threads per stream (one per coefficient segment)
#define MOBI_NB (MOBI_NT + MOBI_NF)   // threads per block
#define MOBI_CHUNK 256    // op rows per chunk (row 0 = header)
#define MOBI_MR 8         // top margin rows
#define MOBI_MCOL 8       // left margin columns
#define MOBI_K 8          // op slots: op r computes while r + 1 .. r + K - 1 copy
#define MOBI_SMEM_MAX 232448   // dynamic shared memory a block may use (H100)

#if defined(__CUDA_ARCH__)
#define MOBI_PAR(t, ...) { const int t = (int)threadIdx.x; __VA_ARGS__ } __syncthreads()
#else
#define MOBI_PAR(t, ...) for (int t = 0; t < MOBI_NB; ++t) { __VA_ARGS__ }
#endif

struct MobiArgs {
  const int32_t* ops;    // (B, nct, CHUNK, 4)  [count, frame, first, last] headers
  const int32_t* resid;  // (B, nct, CHUNK, 64) spatial residual rows, chunk-local
  uint8_t* ring;         // (B, 6, R, SP)
  uint8_t* frames;       // (F, B, R, SP)
  const uint8_t* tabs;   // (20, 256, 4): kind, tap0, tap1, tap2 (ops/intra_tables.py)
  int B, nct, F, H, S;
};

struct MobiGeom { int H, S, G8, R, SP, HH, RW, nseg; };

// One op's inputs, copied ahead of it.
struct MobiSlot {
  int32_t coef[6][64];    // coefficient rows w3 .. w3 + 5 (clamped to the chunk)
  uint8_t lum[17][32];    // MC luma window: 17 rows x two 16-byte segments
  uint8_t chr[2][9][32];  // MC chroma windows, U and V
};

// Dynamic shared memory: op rows of two chunks, the op slots, then (SM) the
// plane region.
struct MobiStage {
  int32_t ops[2][MOBI_CHUNK * 4];
  MobiSlot slot[MOBI_K];
};

// The working plane: rows [r0, r0 + nr) by columns [0, pitch) held at p.
struct MobiPlane {
  uint8_t* p;
  int r0, nr, pitch, SP;
};

MOBI_HD static inline MobiGeom mobi_geom(int H, int S) {
  MobiGeom g;
  g.H = H;
  g.S = S;
  g.G8 = (H + H / 2 + 32) / 8;
  g.R = g.G8 * 8;
  g.SP = S + 128;
  g.HH = H + H / 2;
  g.RW = S + 16;
  g.nseg = g.SP / 16;
  return g;
}

// Dynamic shared memory of one block, with the plane in shared memory or not.
MOBI_HD static inline int mobi_smem_bytes(int H, int S, int smem_plane) {
  const MobiGeom g = mobi_geom(H, S);
  return (int)sizeof(MobiStage) + (smem_plane ? g.HH * g.RW : 0);
}

MOBI_HD static inline int mobi_min(int a, int b) { return a < b ? a : b; }
MOBI_HD static inline int mobi_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
MOBI_HD static inline int mobi_clip8(int v) { return mobi_clamp(v, 0, 255); }
MOBI_HD static inline int mobi_pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
// a mod m for a that is almost always in [0, m): no division on that path
MOBI_HD static inline int mobi_wrap(int a, int m) {
  return (unsigned)a < (unsigned)m ? a : mobi_pmod(a, m);
}
MOBI_HD static inline int mobi_popc(unsigned v) {
#if defined(__CUDA_ARCH__)
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// ------------------------------------------------------- asynchronous copies
// cp.async on the device (completion per thread by commit groups, made
// visible to the block by the barrier that follows); plain copies on the host.
MOBI_HD static inline void mobi_cp16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}
MOBI_HD static inline void mobi_cp_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// Wait until at most N of this thread's newest commit groups are in flight.
template <int N>
MOBI_HD static inline void mobi_cp_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// 16-byte stores and loads for the plane's zeroing and commit.
#if defined(__CUDACC__)
typedef uint4 MobiV16;
#else
struct alignas(16) MobiV16 { uint32_t x, y, z, w; };
#endif

MOBI_HD static inline void mobi_st16(uint8_t* dst, const MobiV16& v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = v;
#else
  memcpy(dst, &v, 16);
#endif
}
MOBI_HD static inline MobiV16 mobi_ld16(const uint8_t* src) {
  MobiV16 v;
#if defined(__CUDA_ARCH__)
  v = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(&v, src, 16);
#endif
  return v;
}

// ------------------------------------------------------------------- plane
// A read outside the held rows and columns returns 0, and a write there is
// dropped.  The plain executor wraps plane columns modulo SP (the TPU
// kernel's lane roll); no wrap is taken here, because plane accesses stay
// within columns [MCOL - 1, MCOL + S + 31), and the columns a wrapped access
// could reach (the left margin, the pad past MCOL + S) hold 0 in every
// frame, as do those past the shared-memory region.
MOBI_HD static inline int mobi_get(const MobiPlane& P, int r, int c) {
  const unsigned rr = (unsigned)(r - P.r0);
  return (rr < (unsigned)P.nr && (unsigned)c < (unsigned)P.pitch)
      ? (int)P.p[rr * (unsigned)P.pitch + c] : 0;
}
MOBI_HD static inline void mobi_put(const MobiPlane& P, int r, int c, int v) {
  const unsigned rr = (unsigned)(r - P.r0);
  if (rr < (unsigned)P.nr && (unsigned)c < (unsigned)P.pitch)
    P.p[rr * (unsigned)P.pitch + c] = (uint8_t)v;
}

// The cluster form's working plane, spread over the cluster's C = 1 << shift
// blocks: macroblock row m (luma rows MR + 16m .. + 15, packed U|V rows
// MR + H + 8m .. + 7) lives in block m mod C, in a window of 26 lines of
// pitch RW from local line 26 (m / C): the line above its luma rows, its
// 16 luma rows, the line above its U|V rows, its 8 U|V rows.  The ops of
// row m read only the rows of its window (a block's taps lie in the line
// above it and the column left of it, inside its macroblock row), so a
// read of any other row returns 0, as does one outside columns [0, RW).
// The lines above belong to row m - 1 (the last luma line, for the first
// U|V row): the block copies the part each macroblock reads into its
// window once its wait clears, so that no op reads another block's shared
// memory.  An op writes only the 24 rows of its own macroblock row.
struct MobiClPlane {
  uint8_t* p;             // this block's windows
  uint8_t* const* peer;   // host build: each block's windows (unused on the device)
  uint8_t* row;           // the window of macroblock row m
  int H, HH, pitch, shift, rank;
  int y0, c0;             // plane rows of the window's lines 0 and 17
};

#define MOBI_CL_ROWS 24   // plane rows of one macroblock row: 16 luma, 8 U|V
#define MOBI_CL_WIN 26    // lines of its window

// Offset of plane pixel (r, c) in its owner's windows, or -1 outside the plane.
MOBI_HD static inline int mobi_cl_off(const MobiClPlane& P, int r, int c, int* owner) {
  const int y = r - MOBI_MR;
  if ((unsigned)y >= (unsigned)P.HH || (unsigned)c >= (unsigned)P.pitch) return -1;
  const bool luma = y < P.H;
  const int m = luma ? y >> 4 : (y - P.H) >> 3;
  const int w = luma ? 1 + (y & 15) : 18 + ((y - P.H) & 7);
  *owner = m & ((1 << P.shift) - 1);
  return ((m >> P.shift) * MOBI_CL_WIN + w) * P.pitch + c;
}
// Any pixel of the plane, from whichever block holds it.
MOBI_HD static inline int mobi_cl_get_any(const MobiClPlane& P, int r, int c) {
  int owner = 0;
  const int off = mobi_cl_off(P, r, c, &owner);
  if (off < 0) return 0;
  if (owner == P.rank) return P.p[off];
#if defined(__CUDA_ARCH__)
  // another block's row (distributed shared memory): its macroblocks that
  // this read can reach were published before the wait that let it start
  const unsigned a = (unsigned)__cvta_generic_to_shared(P.p + off);
  unsigned ra;
  unsigned short v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(owner));
  asm volatile("ld.shared::cluster.u8 %0, [%1];" : "=h"(v) : "r"(ra) : "memory");
  return (int)v;
#else
  return P.peer[owner][off];
#endif
}
// The window line of plane row r, or -1 for a row outside the window.
MOBI_HD static inline int mobi_cl_line(const MobiClPlane& P, int r) {
  const int yl = r - P.y0, yc = r - P.c0;
  const bool luma = (unsigned)yl < 17u;
  return luma ? yl : ((unsigned)yc < 9u ? 17 + yc : -1);
}
MOBI_HD static inline int mobi_get(const MobiClPlane& P, int r, int c) {
  const int w = mobi_cl_line(P, r);
  return (w >= 0 && (unsigned)c < (unsigned)P.pitch) ? (int)P.row[w * P.pitch + c] : 0;
}
MOBI_HD static inline void mobi_put(const MobiClPlane& P, int r, int c, int v) {
  const int w = mobi_cl_line(P, r);
  if (w > 0 && w != 17 && (unsigned)c < (unsigned)P.pitch) P.row[w * P.pitch + c] = (uint8_t)v;
}

// Intra tap k of a block at (r, c): 0 the corner, 1..31 t[0..30] (the row
// above from column c), 32..47 l[0..15] (the column left of the block).
template <class PL>
MOBI_HD static inline int mobi_tap(const PL& P, int r, int c, int k) {
  const bool top = k < 32;
  return mobi_get(P, top ? r - 1 : r + k - 32, top ? c - 1 + k : c - 1);
}
template <class PL>
MOBI_HD static inline int mobi_tapv(const PL& P, int r, int c, int idx) {
  return mobi_tap(P, r, c, idx <= 16 ? idx : 32 + idx - 17);
}

// CopyBlock's four half-pel cases (cs = x half | y half << 1), truncating
// >> 1 on each operand: a; (a>>1)+(b>>1); (a>>1)+(c>>1); and the average
// of the two horizontal ones.
MOBI_HD static inline int mobi_halfpel(int a, int b, int c, int d, int cs) {
  const int ab = (cs & 1) ? (a >> 1) + (b >> 1) : a;
  const int cd = (cs & 1) ? (c >> 1) + (d >> 1) : c;
  return (cs & 2) ? (ab >> 1) + (cd >> 1) : ab;
}

// Intra table entry [kind, tap0, tap1, tap2] (bytes, little end first) of
// pixel (i, j) in `mode`, through the read-only cache on the device.
MOBI_HD static inline uint32_t mobi_tab(const uint8_t* tabs, int mode, int i, int j) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(tabs) + mode * 256 + i * 16 + j;
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// Directional / DC prediction of pixel (i, j) of the block at (r, c).
// Kinds: 0 COPY, 1 AVG2, 2 AVG3, 3 DC, 4 PASS (PASS copies tap 0, the corner).
template <class PL>
MOBI_HD static inline int mobi_pred_dir(const PL& P, int r, int c, const uint8_t* tabs,
                                        int mode, int i, int j, int npx, int logn, int avt,
                                        int avl) {
  if (mode == 3 || mode == 13) {
    int st = 0, sl = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // npx is 4 or 8: unrolled, the reads overlap
      if (k < npx) {
        st += mobi_tap(P, r, c, 1 + k);
        sl += mobi_tap(P, r, c, 32 + k);
      }
    }
    if (avt && avl) return (st + sl + npx) >> (logn + 1);
    if (avt) return (st + (npx >> 1)) >> logn;
    if (avl) return (sl + (npx >> 1)) >> logn;
    return 0x80;
  }
  const uint32_t e = mobi_tab(tabs, mode, i, j);
  const int kind = e & 0xFF;
  const int a = mobi_tapv(P, r, c, (e >> 8) & 0xFF);
  if (kind == 1) return (a + mobi_tapv(P, r, c, (e >> 16) & 0xFF) + 1) >> 1;
  if (kind == 2)
    return (a + 2 * mobi_tapv(P, r, c, (e >> 16) & 0xFF) + mobi_tapv(P, r, c, e >> 24) + 2)
        >> 2;
  return a;
}

// Closed form of the plane predictors (modes 2/12 and plane16) at (i, j),
// from the taps tr = t[size - 1], bl = l[size - 1], tj = t[j], li = l[i].
MOBI_HD static inline int mobi_plane_pout(int tr, int bl, int tj, int li, int size, int grad,
                                          int i, int j) {
  const int n16 = size == 16;
  const int r5 = ((bl + tr + 1) >> 1) + 2 * grad;
  const int r6 = r5 - bl + n16, r9 = r5 - tr + n16;
  const int tsc = size == 4 ? 4 : 8, asc = size == 4 ? 16 : 64, rsh = size == 4 ? 5 : 7;
  const int r4i = bl * tsc + (j + 1) * (n16 ? (r6 >> 1) : r6);
  const int bi = n16 ? r4i - tj * 8 + 1 : r4i - tj * tsc;
  const int bt = n16 ? (bi >> 1) : bi;
  const int r10 = tr * tsc + (i + 1) * (n16 ? (r9 >> 1) : r9);
  const int r7 = n16 ? r10 - li * 8 + 1 : r10 - li * tsc;
  const int r7t = n16 ? (r7 >> 1) : r7;
  return (asc * tj + (i + 1) * bt + asc * li + (j + 1) * r7t + asc) >> rsh;
}

// The reference stores plane rows as u32 words composed with |, so an
// out-of-range value bleeds into its neighbours' bytes: rebuild the word of
// pixel j's 4-pixel group and take byte j & 3.
template <class PL>
MOBI_HD static inline int mobi_plane_px(const PL& P, int r, int c, int size,
                                        int grad, int i, int j) {
  const int j0 = j & ~3;
  const int tr = mobi_tap(P, r, c, size), bl = mobi_tap(P, r, c, 32 + size - 1);
  const int li = mobi_tap(P, r, c, 32 + i);
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k)
    w |= (uint32_t)mobi_plane_pout(tr, bl, mobi_tap(P, r, c, 1 + j0 + k), li, size, grad, i,
                                   j0 + k) << (8 * k);
  return (int)((w >> (8 * (j & 3))) & 0xFFu);
}

// ------------------------------------------------------------ op decoding
// Coefficient rows an op reads from w3 on (ops/packing.py _op_nrows).
MOBI_HD static inline int mobi_op_nrows(int w0) {
  const int typ = w0 & 3, sl = (w0 >> 2) & 7;
  if (typ == 2) {
    if (sl == 4) return mobi_popc((w0 >> 5) & 0xF);
    if (sl == 5) return mobi_popc((w0 >> 5) & 0x3);
    return 1;
  }
  if (typ == 3) {
    if (sl == 5 || sl == 6) return mobi_popc((w0 >> 21) & 0xF);
    if (sl == 7) return mobi_popc((w0 >> 10) & 0x3);
    return (w0 >> 10) & 1;
  }
  if (typ == 1) return mobi_popc((w0 >> 3) & 0x3F);
  return 0;
}

// Copy thread u's share (u < MOBI_NF) of copying op row w's inputs into
// slot s: coefficient segment u, and MC window segment u (< 70).  The MC
// windows use the executor's row clamp, roll within the 24/16-row window
// and column wrap modulo SP; a row is copied as the two 16-byte segments
// (SP is a multiple of 16, so they wrap cleanly) that hold its 17 (luma)
// or 9 (chroma) columns.
MOBI_HD static inline void mobi_fetch(const MobiGeom& g, const uint8_t* ring,
                                      const int32_t* rz, int fm, const int32_t* w,
                                      MobiSlot* s, int u) {
  const int w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const int typ = w0 & 3;
  if (u < mobi_op_nrows(w0) * 16) {
    const int k = u >> 4, seg = u & 15;
    mobi_cp16(&s->coef[k][seg * 4],
              rz + (size_t)mobi_min(w3 + k, MOBI_CHUNK - 1) * 64 + seg * 4);
  }
  if (typ == 1) {
    const int rr = w1 & 0xFFFF, cc = w1 >> 16, ref = (w0 >> 13) & 7;
    const int dx = (int16_t)(w2 & 0xFFFF), dy = w2 >> 16;
    const uint8_t* rs = ring + (size_t)((5 - fm + ref) % 6) * g.R * g.SP;
    if (u < 34) {
      const int i = u >> 1, sg = u & 1;
      const int yb = rr + (dy >> 1), xb = cc + (dx >> 1);
      const int gl = mobi_clamp(yb >> 3, 0, g.G8 - 3), yo = yb & 7;
      const int row = gl * 8 + (i + yo) % 24;
      const int col = mobi_wrap((xb >> 4) + sg, g.nseg) * 16;
      mobi_cp16(&s->lum[i][sg * 16], rs + (size_t)row * g.SP + col);
    }
    const int v = u - 34;
    if (v >= 0 && v < 36) {
      const int half = v / 18, i = (v % 18) >> 1, sg = v & 1;
      const int cdx = dx >> 1, cdy = dy >> 1;
      const int cy = MOBI_MR + g.H + ((rr - MOBI_MR) >> 1);
      const int ccu = MOBI_MCOL + ((cc - MOBI_MCOL) >> 1);
      const int cyb = cy + (cdy >> 1);
      const int gc = mobi_clamp(cyb >> 3, 0, g.G8 - 2), co = cyb & 7;
      const int xo = ccu + (cdx >> 1) + (half ? g.S / 2 : 0);
      const int row = gc * 8 + (i + co) % 16;
      const int col = mobi_wrap((xo >> 4) + sg, g.nseg) * 16;
      mobi_cp16(&s->chr[half][i][sg * 16], rs + (size_t)row * g.SP + col);
    }
  }
}

// ------------------------------------------------------------------ MC (1)
template <class PL>
MOBI_HD static inline void mobi_mc(const MobiGeom& g, const PL& P, const MobiSlot& s,
                                   int w0, int w1, int w2, int t) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int bw = (w0 >> 16) & 0x1F, bh = (w0 >> 21) & 0x1F;
  const int rmask = (w0 >> 3) & 0x3F;   // fused residual rows: 4 luma quads, U, V
  const int dx = (int16_t)(w2 & 0xFFFF), dy = w2 >> 16;
  {
    const int i = t >> 4, j = t & 15;
    if (i < bh && j < bw) {
      const int o = (cc + (dx >> 1)) & 15;   // the column within its segment
      const uint8_t* a = &s.lum[i][o + j];
      int px = mobi_halfpel(a[0], a[1], a[32], a[33], (dx & 1) | ((dy & 1) << 1));
      if (rmask & 0xF) {
        const int q = (i >> 3) * 2 + (j >> 3);
        if ((rmask >> q) & 1)
          px += s.coef[mobi_popc(rmask & ((1u << q) - 1))][(i & 7) * 8 + (j & 7)];
        px = mobi_clip8(px);
      }
      mobi_put(P, rr + i, cc + j, px);
    }
  }
  if (t < 128) {
    // chroma: U at ccu, V at ccu + S/2; MVs halved again
    const int half = t >> 6, i = (t >> 3) & 7, j = t & 7;
    if (i < (bh >> 1) && j < (bw >> 1)) {
      const int cdx = dx >> 1, cdy = dy >> 1;
      const int cy = MOBI_MR + g.H + ((rr - MOBI_MR) >> 1);
      const int ccu = MOBI_MCOL + ((cc - MOBI_MCOL) >> 1);
      const int off = half ? g.S / 2 : 0;
      const int o = (ccu + (cdx >> 1) + off) & 15;
      const uint8_t* a = &s.chr[half][i][o + j];
      int px = mobi_halfpel(a[0], a[1], a[32], a[33], (cdx & 1) | ((cdy & 1) << 1));
      if (rmask >> 4) {
        const int nl = mobi_popc(rmask & 0xF);
        const int bu = (rmask >> 4) & 1, bv = (rmask >> 5) & 1;
        if (half ? bv : bu) px += s.coef[half ? nl + bu : nl][i * 8 + j];
        px = mobi_clip8(px);
      }
      mobi_put(P, cy + i, ccu + off + j, px);
    }
  }
}

// --------------------------------------------------------------- resid (2)
template <class PL>
MOBI_HD static inline void mobi_resid(const MobiGeom& g, const PL& P,
                                      const MobiSlot& s, int w0, int w1, int t) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int sl = (w0 >> 2) & 7;
  if (sl < 4) {                 // plain block
    const int size = 1 << sl, i = t >> 4, j = t & 15;
    if (i < size && j < size)
      mobi_put(P, rr + i, cc + j, mobi_clip8(mobi_get(P, rr + i, cc + j) + s.coef[0][i * 8 + j]));
  } else if (sl == 4) {         // masked 16x16: uncoded quads add 0
    const int mask = (w0 >> 5) & 0xF, i = t >> 4, j = t & 15;
    const int q = (i >> 3) * 2 + (j >> 3);
    const int r = ((mask >> q) & 1)
        ? s.coef[mobi_popc(mask & ((1u << q) - 1))][(i & 7) * 8 + (j & 7)] : 0;
    mobi_put(P, rr + i, cc + j, mobi_clip8(mobi_get(P, rr + i, cc + j) + r));
  } else if (sl == 5 && t < 128) {   // chroma U+V pair, V at +S/2
    const int half = t >> 6, i = (t >> 3) & 7, j = t & 7;
    const int bu = (w0 >> 5) & 1, bv = (w0 >> 6) & 1;
    const int c = cc + (half ? g.S / 2 : 0) + j;
    const int r = (half ? bv : bu) ? s.coef[half ? bu : 0][i * 8 + j] : 0;
    mobi_put(P, rr + i, c, mobi_clip8(mobi_get(P, rr + i, c) + r));
  }
}

// --------------------------------------------------------------- intra (3)
// Phase ph of an intra op (only a luma quad batch has more than one: its
// ph-th present sub-block).  The three forms only place the block; one
// prediction serves them all.
template <class PL>
MOBI_HD static inline void mobi_intra(const MobiGeom& g, const PL& P,
                                      const MobiSlot& s, const uint8_t* tabs, int w0, int w1,
                                      int w2, int ph, int t) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int isl = (w0 >> 2) & 7;
  int r = rr, c = cc, n, i, j, mode, avt, avl;
  int k = -1;           // the coefficient row added, or -1
  bool plane = false;   // the plane closed form (single blocks, modes 2/12)
  if (isl == 5 || isl == 6) {
    // luma quad batch: sub-blocks in q order, each reading the pixels its
    // predecessors wrote in the phases before
    int q = 0;
    for (int seen = 0; q < 4; ++q) {
      if (((w0 >> (5 + 4 * q)) & 0xF) == 0xF) continue;   // slot absent
      if (seen++ == ph) break;
    }
    if (q == 4) return;
    n = isl == 5 ? 4 : 8;
    i = t >> 4;
    j = t & 15;
    if (i >= n || j >= n) return;
    r += n * (q >> 1);
    c += n * (q & 1);
    mode = mobi_min(((w0 >> (5 + 4 * q)) & 0xF) + (n == 4 ? 10 : 0), 19);
    avt = q < 2 ? (w2 & 1) : 1;
    avl = (q & 1) == 0 ? ((w2 >> 1) & 1) : 1;
    const int hbits = (w0 >> 21) & 0xF;
    if ((hbits >> q) & 1) k = mobi_popc(hbits & ((1u << q) - 1));
  } else if (isl == 7) {
    // chroma U+V pair: neither block's taps lie in the other block
    if (t >= 128) return;
    const int half = t >> 6;
    n = 8;
    i = (t >> 3) & 7;
    j = t & 7;
    c += half ? g.S / 2 : 0;
    mode = mobi_min((w0 >> 5) & 0x1F, 19);
    avt = rr != MOBI_MR + g.H;
    avl = cc != MOBI_MCOL;
    const int hasu = (w0 >> 10) & 1, hasv = (w0 >> 11) & 1;
    if (half ? hasv : hasu) k = half ? hasu : 0;
  } else {
    // single block: directional/DC, or the plane closed form
    n = 1 << isl;
    i = t >> 4;
    j = t & 15;
    if (i >= n || j >= n) return;
    mode = mobi_min((w0 >> 5) & 0x1F, 19);
    avt = (w0 >> 11) & 1;
    avl = (w0 >> 12) & 1;
    plane = mode == 2 || mode == 12;
    if ((w0 >> 10) & 1) k = 0;
  }
  int px = plane ? mobi_plane_px(P, r, c, n, w2, i, j)
                 : mobi_pred_dir(P, r, c, tabs, mode, i, j, n == 4 ? 4 : 8, n == 4 ? 2 : 3,
                                 avt, avl);
  if (k >= 0) px = mobi_clip8(px + ((i < 8 && j < 8) ? s.coef[k][i * 8 + j] : 0));
  mobi_put(P, r + i, c + j, px);
}

// Barrier phases an op row takes: one, or one per present sub-block of a
// luma quad batch (the op's first phase runs whatever it holds).
MOBI_HD static inline int mobi_op_phases(int w0) {
  const int isl = (w0 >> 2) & 7;
  if ((w0 & 3) == 3 && (isl == 5 || isl == 6)) {
    int n = 0;
    for (int q = 0; q < 4; ++q) n += ((w0 >> (5 + 4 * q)) & 0xF) != 0xF;
    return n;
  }
  return 1;
}

template <class PL>
MOBI_HD static inline void mobi_op_phase(const MobiGeom& g, const PL& P,
                                         const MobiSlot& s, const uint8_t* tabs, int w0,
                                         int w1, int w2, int t) {
  switch (w0 & 3) {
    case 1: mobi_mc(g, P, s, w0, w1, w2, t); break;
    case 2: mobi_resid(g, P, s, w0, w1, t); break;
    case 3: mobi_intra(g, P, s, tabs, w0, w1, w2, 0, t); break;
    default: break;
  }
}

// ------------------------------------------------------- frame lifecycle
MOBI_HD static inline void mobi_zero_plane(const MobiPlane& P, int t) {
  const MobiV16 z = {0, 0, 0, 0};
  const size_t n = (size_t)P.nr * P.pitch / 16;
  for (size_t k = t; k < n; k += MOBI_NB) mobi_st16(P.p + k * 16, z);
}

// Write the finished frame to frames[f] (shared-memory plane only: the
// global plane is frames[f]) and to its ring slot, 16 bytes per store.
template <bool SM>
MOBI_HD static inline void mobi_commit_frame(const MobiGeom& g, const MobiPlane& P,
                                             uint8_t* frame, uint8_t* slot, int t) {
  const int nseg = g.SP / 16;
  const size_t n = (size_t)g.R * nseg;
  for (size_t k = t; k < n; k += MOBI_NB) {
    MobiV16 v = {0, 0, 0, 0};
    if (SM) {
      const int row = (int)(k / nseg) - P.r0, col = (int)(k % nseg) * 16;
      if ((unsigned)row < (unsigned)P.nr && col < P.pitch)
        v = mobi_ld16(P.p + (size_t)row * P.pitch + col);
      mobi_st16(frame + k * 16, v);
    } else {
      v = mobi_ld16(frame + k * 16);
    }
    mobi_st16(slot + k * 16, v);
  }
}

// One stream's whole GOP: chunks in order, ops in order inside each chunk.
// `smem` holds a MobiStage, followed (SM) by the plane region.
template <bool SM>
MOBI_HD static inline void mobi_run_stream(const MobiArgs& a, int b, uint8_t* smem) {
  const MobiGeom g = mobi_geom(a.H, a.S);
  const size_t psz = (size_t)g.R * g.SP;
  MobiStage* st = reinterpret_cast<MobiStage*>(smem);
  uint8_t* ring = a.ring + (size_t)b * 6 * psz;
  const int32_t* ops = a.ops + (size_t)b * a.nct * MOBI_CHUNK * 4;
  MOBI_PAR(t, if (t < MOBI_CHUNK) mobi_cp16(&st->ops[0][t * 4], ops + t * 4); mobi_cp_commit();
           mobi_cp_wait<0>(););
  for (int c = 0; c < a.nct; ++c) {
    const int32_t* ck = st->ops[c & 1];
    const int count = mobi_min(ck[0], MOBI_CHUNK - 1), fid = ck[1];
    const int first = ck[2], last = ck[3];
    const bool live = fid >= 0 && fid < a.F;
    const int fm = live ? fid % 6 : 0;
    uint8_t* frame = a.frames + ((size_t)(live ? fid : 0) * a.B + b) * psz;
    MobiPlane P;
    P.SP = g.SP;
    if (SM) {
      P.p = smem + sizeof(MobiStage);
      P.r0 = MOBI_MR;
      P.nr = g.HH;
      P.pitch = g.RW;
    } else {
      P.p = frame;
      P.r0 = 0;
      P.nr = g.R;
      P.pitch = g.SP;
    }
    const int32_t* rz = a.resid + ((size_t)b * a.nct + c) * MOBI_CHUNK * 64;
    // the next chunk's op rows (its buffer held chunk c - 1, done), the
    // plane's zeroing, and the inputs of ops 1 .. K - 1
    MOBI_PAR(t,
      if (c + 1 < a.nct && t < MOBI_CHUNK)
        mobi_cp16(&st->ops[(c + 1) & 1][t * 4], ops + (size_t)(c + 1) * MOBI_CHUNK * 4 + t * 4);
      mobi_cp_commit();
      if (live) {
        if (first) mobi_zero_plane(P, t);
        for (int r = 1; r < MOBI_K; ++r) {
          if (t >= MOBI_NT && r <= count)
            mobi_fetch(g, ring, rz, fm, ck + r * 4, &st->slot[r], t - MOBI_NT);
          mobi_cp_commit();
        }
        mobi_cp_wait<MOBI_K - 2>();
      } else {
        mobi_cp_wait<0>();
      });
    if (!live) continue;
    for (int r = 1; r <= count; ++r) {
      const int w0 = ck[r * 4], w1 = ck[r * 4 + 1], w2 = ck[r * 4 + 2];
      const MobiSlot& s = st->slot[r % MOBI_K];
      // op r computes; op r + K - 1's inputs go into the slot op r - 1
      // freed; op r + 1's inputs are complete before the barrier.  (No
      // loop around this phase: the compiler would hoist every op form's
      // decoding out of it and run them all for every op.)
      MOBI_PAR(t,
        if (t < MOBI_NT) mobi_op_phase(g, P, s, a.tabs, w0, w1, w2, t);
        const int rn = r + MOBI_K - 1;
        if (t >= MOBI_NT && rn <= count)
          mobi_fetch(g, ring, rz, fm, ck + rn * 4, &st->slot[rn % MOBI_K], t - MOBI_NT);
        mobi_cp_commit();
        mobi_cp_wait<MOBI_K - 2>(););
      // a luma quad batch: one more phase per further present sub-block
      const int nph = mobi_op_phases(w0);
      for (int ph = 1; ph < nph; ++ph) {
        MOBI_PAR(t, if (t < MOBI_NT) mobi_intra(g, P, s, a.tabs, w0, w1, w2, ph, t););
      }
    }
    if (last) {
      MOBI_PAR(t, mobi_commit_frame<SM>(g, P, frame, ring + (size_t)(5 - fm) * psz, t););
    }
  }
}

// --------------------------------------------------------- the cluster form
// One stream's GOP on a thread-block cluster of C = 1 << shift blocks: block
// `rank` owns macroblock rows rank, rank + C, ... of every frame and walks
// each of them left to right, the row's ops in decode order, with the same
// per-op phases and copies ahead as the one-block walk above.  A macroblock
// starts once the rows it reads have published enough (mobi_cl_needs), so
// the rows run as a wavefront two macroblocks apart.
#define MOBI_CL_MAXR 64     // macroblock rows the cluster form serves (H <= 1,024)
#define MOBI_CL_WHOLE 127   // progress of a finished row (a row has at most 64 macroblocks)

// A block's state in the cluster form, after its MobiStage.
struct alignas(16) MobiClState {
  int prog;                      // published progress: row * 128 + macroblocks done
  int last;                      // the frame's last chunk (none: more than nct)
  int full;                      // the frame is as wide as its stride
  unsigned vc[2];                // rows whose V block of column 0 reads its corner tap
  int start[MOBI_CL_MAXR + 1];   // each row's first op (chunk * CHUNK + op row), then the frame's end
};

// Dynamic shared memory of one block of the cluster form: the staging area,
// the state and the windows of the block's macroblock rows.
MOBI_HD static inline int mobi_cl_smem_bytes(int H, int S, int C) {
  const MobiGeom g = mobi_geom(H, S);
  const int nloc = (H / 16 + C - 1) / C;
  return (int)(sizeof(MobiStage) + sizeof(MobiClState)) + nloc * MOBI_CL_WIN * g.RW;
}

// Threads that copy a macroblock's part of the lines above its row: the
// luma line from column 16 col - 1 on (33 bytes: the corner, its own
// columns and the next macroblock's, where its taps reach), and the U and
// V lines from 8 col - 1 on (17 bytes each).  The copy runs beside the
// last op of macroblock col - 1, which may read its top-right taps from the
// bytes the copy rewrites (luma 16 col - 1 .. 16 col + 15, U and V 8 col - 1
// .. 8 col + 7: pixels of macroblocks col - 1 and col of the row above).
// That is safe only because the rewrite stores the values those bytes
// already hold: macroblock col - 1's own copy waited for the row above to
// have done col + 1 macroblocks (mobi_cl_needs), so they were final then.
// A wait that asks less of the row above breaks it.
#define MOBI_CL_TOPN 67

MOBI_HD static inline void mobi_cl_copy_top(const MobiGeom& g, const MobiClPlane& P, int col,
                                            int u) {
  const bool luma = u < 33;
  const int x = luma ? MOBI_MCOL + 16 * col - 1 + u
                     : MOBI_MCOL + 8 * col - 1 + (u < 50 ? u - 33 : g.S / 2 + u - 50);
  const int r = luma ? P.y0 : P.c0;
  if ((unsigned)x < (unsigned)P.pitch) P.row[(luma ? 0 : 17 * P.pitch) + x] = mobi_cl_get_any(P, r, x);
}

MOBI_HD static inline int mobi_max(int a, int b) { return a > b ? a : b; }

MOBI_HD static inline void mobi_atomic_min(int* p, int v) {
#if defined(__CUDA_ARCH__)
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}
MOBI_HD static inline void mobi_atomic_or(unsigned* p, unsigned v) {
#if defined(__CUDA_ARCH__)
  atomicOr(p, v);
#else
  *p |= v;
#endif
}

// The macroblock row and column of an op, from the row and column of its
// block (w1): luma rows are 16 to a macroblock row, U|V rows 8, and a V
// block's column lies S/2 right of its U block's.
MOBI_HD static inline int mobi_cl_row(const MobiGeom& g, int w1) {
  const int rr = w1 & 0xFFFF;
  const int m = rr < MOBI_MR + g.H ? (rr - MOBI_MR) >> 4 : (rr - MOBI_MR - g.H) >> 3;
  return mobi_clamp(m, 0, g.H / 16 - 1);
}
MOBI_HD static inline int mobi_cl_col(const MobiGeom& g, int w1) {
  const int rr = w1 & 0xFFFF, x = (w1 >> 16) - MOBI_MCOL;
  return mobi_max(rr < MOBI_MR + g.H ? x >> 4 : (x & (g.S / 2 - 1)) >> 3, 0);
}

// Whether intra prediction `mode` of an n x n block reads its corner tap
// (the pixel above and left of it); `pair` for the chroma U+V pair, which
// predicts modes 2 and 12 by the table, not the plane closed form.
MOBI_HD static inline bool mobi_reads_corner(const uint8_t* tabs, int mode, int n, bool pair) {
  if (mode == 3 || mode == 13 || (!pair && (mode == 2 || mode == 12))) return false;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      const uint32_t e = mobi_tab(tabs, mode, i, j);
      const int kind = e & 0xFF, nt = kind == 1 ? 2 : (kind == 2 ? 3 : (kind == 3 ? 0 : 1));
      for (int k = 0; k < nt; ++k)
        if (((e >> (8 + 8 * k)) & 0xFF) == 0) return true;
    }
  return false;
}

// What must be published before macroblock (m, col) starts, as (row q,
// least progress v) pairs; returns their count.  The taps above a block
// reach column col + 1 of row m - 1, so that row must be two macroblocks
// ahead (or done).  `vcorner`: the frame is as wide as its stride and the
// V block of column 0 reads its corner tap, the last U pixel of row m - 1,
// so column 0 waits for row m - 1 to be done (a legal stream predicts
// there without the left pixels, so without the corner).  The last row
// waits for rows 0 and 1 to be done: the first U|V row's top taps read the
// last luma row, which the decode order has not written by then.  Every
// other read of a pixel the decode order has not yet written (the V
// block's left taps into the last U block of its own row) stays
// unwritten: a row cannot pass column col - 2 of the row above it.
MOBI_HD static inline int mobi_cl_needs(int m, int col, int nmb, int vcorner, int* q, int* v) {
  int n = 0;
  if (m > 0) {
    q[n] = m - 1;
    v[n++] = (m - 1) * 128 +
             (vcorner && col == 0 ? MOBI_CL_WHOLE : mobi_min(col + 2, MOBI_CL_WHOLE));
  }
  if (m > 0 && m == nmb - 1) {
    q[n] = mobi_min(1, m - 1);
    v[n] = q[n] * 128 + MOBI_CL_WHOLE;
    ++n;
  }
  return n;
}

MOBI_HD static inline void mobi_cl_zero(const MobiClPlane& P, int nloc, int t) {
  const MobiV16 z = {0, 0, 0, 0};
  const int n = nloc * MOBI_CL_WIN * P.pitch / 16;
  for (int k = t; k < n; k += MOBI_NB) mobi_st16(P.p + (size_t)k * 16, z);
}

// Write this block's rows of the finished frame, and its share of the rows
// outside the plane (zeros: margin rank, rank + C, ...), to frames[f] and to
// the frame's ring slot, 16 bytes per store.
MOBI_HD static inline void mobi_cl_commit(const MobiGeom& g, const MobiClPlane& P, int nloc,
                                          uint8_t* frame, uint8_t* slot, int t) {
  const int nseg = g.SP / 16, C = 1 << P.shift;
  const int nown = nloc * MOBI_CL_ROWS;
  const int nout = (g.R - g.HH - P.rank + C - 1) >> P.shift;
  const int n = (nown + nout) * nseg;
  for (int k = t; k < n; k += MOBI_NB) {
    const int li = k / nseg, col = (k - li * nseg) * 16;
    MobiV16 v = {0, 0, 0, 0};
    int row;
    if (li < nown) {
      const int i = li / MOBI_CL_ROWS, w = li - i * MOBI_CL_ROWS;
      const int m = P.rank + (i << P.shift);
      row = w < 16 ? MOBI_MR + 16 * m + w : MOBI_MR + g.H + 8 * m + w - 16;
      const int wl = i * MOBI_CL_WIN + (w < 16 ? 1 + w : 2 + w);
      if (col < P.pitch) v = mobi_ld16(P.p + (size_t)wl * P.pitch + col);
    } else {
      const int j = P.rank + ((li - nown) << P.shift);
      row = j < MOBI_MR ? j : j + g.HH;
    }
    const size_t o = (size_t)row * g.SP + col;
    mobi_st16(frame + o, v);
    mobi_st16(slot + o, v);
  }
}

// Whether row m's column 0 waits for row m - 1 to be done (mobi_cl_needs).
MOBI_HD static inline int mobi_cl_vcorner(const MobiClState* cs, int m) {
  return cs->full && ((cs->vc[m >> 5] >> (m & 31)) & 1);
}

// The first of own rows i, i + 1, ... (row rank + (i << shift)) with an op.
MOBI_HD static inline int mobi_cl_next_row(const MobiClState* cs, int rank, int shift,
                                           int nloc, int i) {
  for (; i < nloc; ++i) {
    const int m = rank + (i << shift);
    if (cs->start[m] < cs->start[m + 1]) break;
  }
  return i;
}

// Block `rank`'s part of stream b's GOP.  `smem` holds a MobiStage, a
// MobiClState and the windows of the block's rows.  Sync is the cluster's:
// publish(cs, v) stores this block's progress (release), by the last
// thread; wait(cs, m, col, nmb, vcorner, shift, seen, u) returns once
// mobi_cl_needs holds for macroblock (m, col) (acquire), called by each
// copying thread u < MOBI_CL_TOPN before it copies its byte of the lines
// above (seen: its last reading of row m - 1, from this frame);
// cluster_sync() is the cluster's barrier, called by every thread.  The
// wait and copy for a macroblock run beside the compute of the op before
// it (or in the setup of the op rows it starts), and a macroblock's start
// is published in its first op's phase: no barrier phase of their own.
template <class Sync>
MOBI_HD static inline void mobi_run_cluster(const MobiArgs& a, int b, int rank, int shift,
                                            uint8_t* smem, Sync& sy) {
  const MobiGeom g = mobi_geom(a.H, a.S);
  const int C = 1 << shift, nmb = a.H >> 4;
  const int nloc = (nmb - rank + C - 1) >> shift;
  const size_t psz = (size_t)g.R * g.SP;
  MobiStage* st = reinterpret_cast<MobiStage*>(smem);
  MobiClState* cs = reinterpret_cast<MobiClState*>(smem + sizeof(MobiStage));
  MobiClPlane P;
  P.p = smem + sizeof(MobiStage) + sizeof(MobiClState);
  P.peer = sy.peer;
  P.H = g.H;
  P.HH = g.HH;
  P.pitch = g.RW;
  P.shift = shift;
  P.rank = rank;
  uint8_t* ring = a.ring + (size_t)b * 6 * psz;
  const int32_t* ops = a.ops + (size_t)b * a.nct * MOBI_CHUNK * 4;
  const int32_t* rzb = a.resid + (size_t)b * a.nct * MOBI_CHUNK * 64;
  int pub = -1;    // the last thread: the progress published last
  int seen = -1;   // copying threads: row m - 1's progress as last read
  for (int c = 0; c < a.nct;) {
    // a frame: from a live chunk that is its first to the next that is
    // its last (chunks between frames, padding among them, hold no op)
    const int32_t* hd = ops + (size_t)c * MOBI_CHUNK * 4;
    const int fid = hd[1];
    if (fid < 0 || fid >= a.F || !hd[2]) {
      ++c;
      continue;
    }
    // the frame's last chunk and this block's rows zeroed (no block reads
    // them or its progress since the last frame's closing cluster barrier)
    MOBI_PAR(t,
      if (t == 0) {
        cs->last = 0x7FFFFFFF;
        cs->full = 0;
        cs->vc[0] = cs->vc[1] = 0;
        cs->prog = -1;
      }
      pub = seen = -1;
      if (t <= nmb) cs->start[t] = 0x7FFFFFFF;
      mobi_cl_zero(P, nloc, t););
    MOBI_PAR(t,
      for (int k = c + t; k < a.nct; k += MOBI_NB)
        if (ops[(size_t)k * MOBI_CHUNK * 4 + 3]) {
          mobi_atomic_min(&cs->last, k);
          break;
        });
    // where each macroblock row's ops start: one pass over the frame's op
    // rows (the scanner emits a row's ops together, rows in order)
    const bool commit = cs->last < a.nct;
    const int last = commit ? cs->last : a.nct - 1;
    MOBI_PAR(t,
      const int n = (last - c + 1) * (MOBI_CHUNK - 1);
#pragma unroll 4
      for (int o = t; o < n; o += MOBI_NB) {
        const int k = c + o / (MOBI_CHUNK - 1), j = 1 + o % (MOBI_CHUNK - 1);
        const int32_t* ck = ops + (size_t)k * MOBI_CHUNK * 4;
        if (j > mobi_min(ck[0], MOBI_CHUNK - 1)) continue;
        const int w0 = ck[j * 4], w1 = ck[j * 4 + 1];
        const int m = mobi_cl_row(g, w1);
        if (mobi_cl_col(g, w1) == g.S / 16 - 1) cs->full = 1;
        // an intra V block at column 0 of V (a U+V pair at column 0, or a
        // single block at S/2) that reads its corner
        const int isl = (w0 >> 2) & 7, cc = w1 >> 16;
        if ((w0 & 3) == 3 && (w1 & 0xFFFF) >= MOBI_MR + g.H &&
            (isl == 7 ? cc == MOBI_MCOL : (isl < 5 && cc == MOBI_MCOL + g.S / 2)) &&
            mobi_reads_corner(a.tabs, mobi_min((w0 >> 5) & 0x1F, 19), isl == 7 ? 8 : 1 << isl,
                              isl == 7))
          mobi_atomic_or(&cs->vc[m >> 5], 1u << (m & 31));
        int pm = -1;
        if (j > 1) {
          pm = mobi_cl_row(g, ck[(j - 1) * 4 + 1]);
        } else if (k > c) {
          const int32_t* pk = ck - MOBI_CHUNK * 4;
          const int pn = mobi_min(pk[0], MOBI_CHUNK - 1);
          if (pn >= 1) pm = mobi_cl_row(g, pk[pn * 4 + 1]);
        }
        if (m != pm) mobi_atomic_min(&cs->start[m], k * MOBI_CHUNK + j);
      });
    MOBI_PAR(t,
      if (t == 0) {
        const int32_t* lk = ops + (size_t)last * MOBI_CHUNK * 4;
        int nx = last * MOBI_CHUNK + mobi_clamp(lk[0], 0, MOBI_CHUNK - 1) + 1;
        cs->start[nmb] = nx;
        for (int m = nmb - 1; m >= 0; --m) {   // a row without ops starts where the next does
          nx = mobi_min(cs->start[m], nx);
          cs->start[m] = nx;
        }
      });
    // the first segment's op rows; own rows before it hold no op: done
    int i = mobi_cl_next_row(cs, rank, shift, nloc, 0);
    int k = i < nloc ? cs->start[rank + (i << shift)] / MOBI_CHUNK : 0;
    MOBI_PAR(t,
      if (i < nloc && t < MOBI_CHUNK)
        mobi_cp16(&st->ops[0][t * 4], ops + (size_t)k * MOBI_CHUNK * 4 + t * 4);
      mobi_cp_commit();
      mobi_cp_wait<0>();
      if (t == MOBI_NB - 1 && i > 0) {
        pub = (rank + ((i - 1) << shift)) * 128 + MOBI_CL_WHOLE;
        sy.publish(cs, pub);
      });
    // every block's rows zeroed and the previous frame in the ring
    sy.cluster_sync();
    const int fm = fid % 6;
    int buf = 0, mbc = -1;
    // segments: the part of one own row's ops in one chunk
    while (i < nloc) {
      const int m = rank + (i << shift);
      P.row = P.p + (size_t)i * MOBI_CL_WIN * g.RW;
      P.y0 = MOBI_MR + 16 * m - 1;
      P.c0 = MOBI_MR + g.H + 8 * m - 1;
      const int p0 = cs->start[m], p1 = cs->start[m + 1];
      const int ke = (p1 - 1) / MOBI_CHUNK;
      int ni = i, nk = k + 1;
      if (k >= ke) {
        ni = mobi_cl_next_row(cs, rank, shift, nloc, i + 1);
        nk = ni < nloc ? cs->start[rank + (ni << shift)] / MOBI_CHUNK : 0;
      }
      const int32_t* ck = st->ops[buf];
      const int count = mobi_min(ck[0], MOBI_CHUNK - 1);
      const int lo = k == p0 / MOBI_CHUNK ? p0 % MOBI_CHUNK : 1;
      const int hi = mobi_min(k == ke ? (p1 - 1) % MOBI_CHUNK : count, count);
      const int32_t* rz = rzb + (size_t)k * MOBI_CHUNK * 64;
      // the next segment's op rows, the inputs of ops lo .. lo + K - 2,
      // and, if op lo starts a macroblock, its wait and lines above
      const int c0 = lo <= hi ? mobi_cl_col(g, ck[lo * 4 + 1]) : mbc;
      MOBI_PAR(t,
        if (ni < nloc && t < MOBI_CHUNK)
          mobi_cp16(&st->ops[buf ^ 1][t * 4], ops + (size_t)nk * MOBI_CHUNK * 4 + t * 4);
        mobi_cp_commit();
        for (int r = lo; r < lo + MOBI_K - 1; ++r) {
          if (t >= MOBI_NT && r <= hi)
            mobi_fetch(g, ring, rz, fm, ck + r * 4, &st->slot[r % MOBI_K], t - MOBI_NT);
          mobi_cp_commit();
        }
        const int u = t - MOBI_NT;
        if (c0 != mbc && (unsigned)u < (unsigned)MOBI_CL_TOPN) {
          sy.wait(cs, m, c0, nmb, mobi_cl_vcorner(cs, m), shift, seen, u);
          mobi_cl_copy_top(g, P, c0, u);
        }
        mobi_cp_wait<MOBI_K - 2>(););
      for (int r = lo; r <= hi; ++r) {
        const int w0 = ck[r * 4], w1 = ck[r * 4 + 1], w2 = ck[r * 4 + 2];
        const int col = mobi_cl_col(g, w1);
        // op r starts a macroblock: publish the ones before it; op r + 1
        // starts one: wait for the rows it reads and copy its part of the
        // lines above, beside op r
        const bool start = col != mbc;
        const int nc = r < hi ? mobi_cl_col(g, ck[(r + 1) * 4 + 1]) : col;
        mbc = col;
        const MobiSlot& s = st->slot[r % MOBI_K];
        MOBI_PAR(t,
          if (t < MOBI_NT) mobi_op_phase(g, P, s, a.tabs, w0, w1, w2, t);
          const int rn = r + MOBI_K - 1;
          if (t >= MOBI_NT && rn <= hi)
            mobi_fetch(g, ring, rz, fm, ck + rn * 4, &st->slot[rn % MOBI_K], t - MOBI_NT);
          mobi_cp_commit();
          if (start && t == MOBI_NB - 1) {
            pub = mobi_max(pub, m * 128 + mobi_min(col, MOBI_CL_WHOLE - 1));
            sy.publish(cs, pub);
          }
          const int u = t - MOBI_NT;
          if (nc != col && (unsigned)u < (unsigned)MOBI_CL_TOPN) {
            sy.wait(cs, m, nc, nmb, mobi_cl_vcorner(cs, m), shift, seen, u);
            mobi_cl_copy_top(g, P, nc, u);
          }
          mobi_cp_wait<MOBI_K - 2>(););
        const int nph = mobi_op_phases(w0);
        for (int ph = 1; ph < nph; ++ph) {
          MOBI_PAR(t, if (t < MOBI_NT) mobi_intra(g, P, s, a.tabs, w0, w1, w2, ph, t););
        }
      }
      if (ni != i) {
        // the row is done, and the own rows before ni hold no op
        MOBI_PAR(t,
          if (t == MOBI_NB - 1) {
            pub = (rank + ((ni - 1) << shift)) * 128 + MOBI_CL_WHOLE;
            sy.publish(cs, pub);
          });
        mbc = -1;
      }
      i = ni;
      k = nk;
      buf ^= 1;
    }
    // every row decoded: no block reads another's rows until the next frame
    sy.cluster_sync();
    uint8_t* frame = a.frames + ((size_t)fid * a.B + b) * psz;
    if (commit) {
      MOBI_PAR(t, mobi_cl_commit(g, P, nloc, frame, ring + (size_t)(5 - fm) * psz, t););
    }
    c = last + 1;
  }
}
