// Per-op logic of the whole-GOP executor, written once for the GPU kernel
// (gop_executor.cu, nvcc) and for a host build (exec_host.cpp, g++) that the
// CPU tests hold against the plain PyTorch executor (ops/executor_ref.py).
//
// Replaces the Pallas kernel body _make_kernel(..., fused=(B, nct, stage))
// launched by _build_gop_executor in mobiclipdecoder_tpu/ops/vmem_engine.py.
//
// Execution model: one thread block of MOBI_NT threads per stream.  The block
// walks its stream's op chunks, and the ops inside each chunk, strictly in
// decode order; each op is split into barrier-separated phases (an intra op
// first loads its taps into shared memory, then predicts and writes, so it
// never reads a pixel it has already overwritten).  MOBI_PAR runs one phase:
// on the device every thread runs the body once and the block synchronises;
// on the host a loop over the thread index runs the same body.
//
// Storage is uint8 in global memory: every stored value is a clipped pixel.
//   ring   (B, 6, R, SP)   frame f writes slot (5 - f) mod 6, reference r of
//                          frame f reads slot (5 - f + r) mod 6
//   frames (F, B, R, SP)   frame f of stream b is the working plane of that
//                          frame; zeroed at the frame's first chunk
// with R = G8 * 8 rows (8 top margin rows, Y then packed U|V rows) and
// SP = S + 128 columns (8 left margin columns).
#pragma once
#include <stdint.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define MOBI_HD __host__ __device__
#else
#define MOBI_HD
#endif

#define MOBI_NT 256       // threads per stream
#define MOBI_CHUNK 256    // op rows per chunk (row 0 = header)
#define MOBI_MR 8         // top margin rows
#define MOBI_MCOL 8       // left margin columns

#if defined(__CUDA_ARCH__)
#define MOBI_PAR(t, ...) { const int t = (int)threadIdx.x; __VA_ARGS__ } __syncthreads()
#else
#define MOBI_PAR(t, ...) for (int t = 0; t < MOBI_NT; ++t) { __VA_ARGS__ }
#endif

struct MobiArgs {
  const int32_t* ops;    // (B, nct, CHUNK, 4)  [count, frame, first, last] headers
  const int32_t* resid;  // (B, nct, CHUNK, 64) spatial residual rows, chunk-local
  uint8_t* ring;         // (B, 6, R, SP)
  uint8_t* frames;       // (F, B, R, SP)
  const uint8_t* tabs;   // (20, 256, 4): kind, tap0, tap1, tap2 (ops/intra_tables.py)
  int B, nct, F, H, S;
};

struct MobiGeom { int H, S, G8, R, SP; };

// Intra taps of up to two predictions: [0] corner, [1..31] t[0..30],
// [32..47] l[0..15].
struct MobiShared { int tap[2][48]; };

MOBI_HD static inline MobiGeom mobi_geom(int H, int S) {
  MobiGeom g;
  g.H = H;
  g.S = S;
  g.G8 = (H + H / 2 + 32) / 8;
  g.R = g.G8 * 8;
  g.SP = S + 128;
  return g;
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
MOBI_HD static inline int mobi_popc(unsigned v) {
#if defined(__CUDA_ARCH__)
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// Plane pixel read: columns wrap modulo SP (the TPU kernel's lane roll);
// rows outside the plane read 0 and writes outside it are dropped.
MOBI_HD static inline int mobi_get(const uint8_t* p, const MobiGeom& g, int r, int c) {
  return (r >= 0 && r < g.R) ? (int)p[(size_t)r * g.SP + mobi_pmod(c, g.SP)] : 0;
}
MOBI_HD static inline void mobi_put(uint8_t* p, const MobiGeom& g, int r, int c, int v) {
  if (r >= 0 && r < g.R && c >= 0 && c < g.SP) p[(size_t)r * g.SP + c] = (uint8_t)v;
}

// Coefficient row `row` of the chunk (clamped: a chunk may close with
// w3 + n == CHUNK, and dead reads must stay inside it), element (i, j).
MOBI_HD static inline int mobi_res(const int32_t* rz, int row, int i, int j) {
  return rz[(size_t)mobi_min(row, MOBI_CHUNK - 1) * 64 + i * 8 + j];
}

// CopyBlock's four half-pel cases, truncating >> 1 on each operand.
MOBI_HD static inline int mobi_halfpel(int a, int b, int c, int d, int cs) {
  switch (cs) {
    case 0: return a;
    case 1: return (a >> 1) + (b >> 1);
    case 2: return (a >> 1) + (c >> 1);
    default: return (((a >> 1) + (b >> 1)) >> 1) + (((c >> 1) + (d >> 1)) >> 1);
  }
}

MOBI_HD static inline int mobi_tapv(const int* tp, int idx) {
  return idx <= 16 ? tp[idx] : tp[32 + idx - 17];
}

// Directional / DC prediction of pixel (i, j).  Kinds: 0 COPY, 1 AVG2,
// 2 AVG3, 3 DC, 4 PASS (PASS copies tap 0, the corner).
MOBI_HD static inline int mobi_pred_dir(const int* tp, const uint8_t* tabs, int mode,
                                        int i, int j, int npx, int logn, int avt, int avl) {
  if (mode == 3 || mode == 13) {
    int st = 0, sl = 0;
    for (int k = 0; k < npx; ++k) {
      st += tp[1 + k];
      sl += tp[32 + k];
    }
    if (avt && avl) return (st + sl + npx) >> (logn + 1);
    if (avt) return (st + (npx >> 1)) >> logn;
    if (avl) return (sl + (npx >> 1)) >> logn;
    return 0x80;
  }
  const uint8_t* e = tabs + ((size_t)mode * 256 + i * 16 + j) * 4;
  const int a = mobi_tapv(tp, e[1]);
  if (e[0] == 1) return (a + mobi_tapv(tp, e[2]) + 1) >> 1;
  if (e[0] == 2) return (a + 2 * mobi_tapv(tp, e[2]) + mobi_tapv(tp, e[3]) + 2) >> 2;
  return a;
}

// Closed form of the plane predictors (modes 2/12 and plane16) at (i, j).
MOBI_HD static inline int mobi_plane_pout(const int* tp, int size, int grad, int i, int j) {
  const int* t16 = tp + 1;
  const int* l16 = tp + 32;
  const int n16 = size == 16;
  const int tr = t16[size - 1], bl = l16[size - 1];
  const int r5 = ((bl + tr + 1) >> 1) + 2 * grad;
  const int r6 = r5 - bl + n16, r9 = r5 - tr + n16;
  const int tsc = size == 4 ? 4 : 8, asc = size == 4 ? 16 : 64, rsh = size == 4 ? 5 : 7;
  const int r4i = bl * tsc + (j + 1) * (n16 ? (r6 >> 1) : r6);
  const int bi = n16 ? r4i - t16[j] * 8 + 1 : r4i - t16[j] * tsc;
  const int bt = n16 ? (bi >> 1) : bi;
  const int r10 = tr * tsc + (i + 1) * (n16 ? (r9 >> 1) : r9);
  const int r7 = n16 ? r10 - l16[i] * 8 + 1 : r10 - l16[i] * tsc;
  const int r7t = n16 ? (r7 >> 1) : r7;
  return (asc * t16[j] + (i + 1) * bt + asc * l16[i] + (j + 1) * r7t + asc) >> rsh;
}

// The reference stores plane rows as u32 words composed with |, so an
// out-of-range value bleeds into its neighbours' bytes: rebuild the word of
// pixel j's 4-pixel group and take byte j & 3.
MOBI_HD static inline int mobi_plane_px(const int* tp, int size, int grad, int i, int j) {
  const int j0 = j & ~3;
  const uint32_t w = (uint32_t)mobi_plane_pout(tp, size, grad, i, j0)
      | ((uint32_t)mobi_plane_pout(tp, size, grad, i, j0 + 1) << 8)
      | ((uint32_t)mobi_plane_pout(tp, size, grad, i, j0 + 2) << 16)
      | ((uint32_t)mobi_plane_pout(tp, size, grad, i, j0 + 3) << 24);
  return (int)((w >> (8 * (j & 3))) & 0xFFu);
}

// Load 48 taps of a block at (r, c) for thread t < 48: the row above from
// column c - 1 (corner, t[0..30]) and the column left of it (l[0..15]).
MOBI_HD static inline void mobi_load_taps(int* tp, const uint8_t* plane, const MobiGeom& g,
                                          int r, int c, int t) {
  if (t < 32) tp[t] = mobi_get(plane, g, r - 1, c - 1 + t);
  else if (t < 48) tp[t] = mobi_get(plane, g, r + t - 32, c - 1);
}

// ------------------------------------------------------------------ MC (1)
MOBI_HD static inline void mobi_mc(const MobiGeom& g, const uint8_t* ring, uint8_t* plane,
                                   const int32_t* rz, int fm, int w0, int w1, int w2,
                                   int w3, int t) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int bw = (w0 >> 16) & 0x1F, bh = (w0 >> 21) & 0x1F, ref = (w0 >> 13) & 7;
  const int rmask = (w0 >> 3) & 0x3F;   // fused residual rows: 4 luma quads, U, V
  const int dx = (int16_t)(w2 & 0xFFFF), dy = w2 >> 16;
  const uint8_t* rs = ring + (size_t)((5 - fm + ref) % 6) * g.R * g.SP;
  {
    const int i = t >> 4, j = t & 15;
    if (i < bh && j < bw) {
      // 24-row window at a clamped row group; rows roll within the window,
      // columns modulo SP (a window left of the margin wraps to the pad)
      const int yb = rr + (dy >> 1), xb = cc + (dx >> 1);
      const int gl = mobi_clamp(yb >> 3, 0, g.G8 - 3), yo = yb & 7;
#define MOBI_WL(ii, jj) \
  (int)rs[(size_t)(gl * 8 + ((ii) + yo) % 24) * g.SP + mobi_pmod((jj) + xb, g.SP)]
      int px = mobi_halfpel(MOBI_WL(i, j), MOBI_WL(i, j + 1), MOBI_WL(i + 1, j),
                            MOBI_WL(i + 1, j + 1), (dx & 1) | ((dy & 1) << 1));
#undef MOBI_WL
      if (rmask & 0xF) {
        const int q = (i >> 3) * 2 + (j >> 3);
        if ((rmask >> q) & 1)
          px += mobi_res(rz, w3 + mobi_popc(rmask & ((1u << q) - 1)), i & 7, j & 7);
        px = mobi_clip8(px);
      }
      mobi_put(plane, g, rr + i, cc + j, px);
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
      const int cyb = cy + (cdy >> 1);
      const int gc = mobi_clamp(cyb >> 3, 0, g.G8 - 2), co = cyb & 7;
      const int xo = ccu + (cdx >> 1) + off;
#define MOBI_WC(ii, jj) \
  (int)rs[(size_t)(gc * 8 + ((ii) + co) % 16) * g.SP + mobi_pmod((jj) + xo, g.SP)]
      int px = mobi_halfpel(MOBI_WC(i, j), MOBI_WC(i, j + 1), MOBI_WC(i + 1, j),
                            MOBI_WC(i + 1, j + 1), (cdx & 1) | ((cdy & 1) << 1));
#undef MOBI_WC
      if (rmask >> 4) {
        const int nl = w3 + mobi_popc(rmask & 0xF);
        const int bu = (rmask >> 4) & 1, bv = (rmask >> 5) & 1;
        if (half ? bv : bu) px += mobi_res(rz, half ? nl + bu : nl, i, j);
        px = mobi_clip8(px);
      }
      mobi_put(plane, g, cy + i, ccu + off + j, px);
    }
  }
}

// --------------------------------------------------------------- resid (2)
MOBI_HD static inline void mobi_resid(const MobiGeom& g, uint8_t* plane, const int32_t* rz,
                                      int w0, int w1, int w3, int t) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int sl = (w0 >> 2) & 7;
  if (sl < 4) {                 // plain block
    const int size = 1 << sl, i = t >> 4, j = t & 15;
    if (i < size && j < size)
      mobi_put(plane, g, rr + i, cc + j,
               mobi_clip8(mobi_get(plane, g, rr + i, cc + j) + mobi_res(rz, w3, i, j)));
  } else if (sl == 4) {         // masked 16x16: uncoded quads add 0
    const int mask = (w0 >> 5) & 0xF, i = t >> 4, j = t & 15;
    const int q = (i >> 3) * 2 + (j >> 3);
    const int r = ((mask >> q) & 1)
        ? mobi_res(rz, w3 + mobi_popc(mask & ((1u << q) - 1)), i & 7, j & 7) : 0;
    mobi_put(plane, g, rr + i, cc + j, mobi_clip8(mobi_get(plane, g, rr + i, cc + j) + r));
  } else if (sl == 5 && t < 128) {   // chroma U+V pair, V at +S/2
    const int half = t >> 6, i = (t >> 3) & 7, j = t & 7;
    const int bu = (w0 >> 5) & 1, bv = (w0 >> 6) & 1;
    const int c = cc + (half ? g.S / 2 : 0) + j;
    const int r = (half ? bv : bu) ? mobi_res(rz, half ? w3 + bu : w3, i, j) : 0;
    mobi_put(plane, g, rr + i, c, mobi_clip8(mobi_get(plane, g, rr + i, c) + r));
  }
}

// --------------------------------------------------------------- intra (3)
MOBI_HD static inline void mobi_intra(const MobiGeom& g, uint8_t* plane, const int32_t* rz,
                                      const uint8_t* tabs, int w0, int w1, int w2, int w3,
                                      int ph, int t, MobiShared* sh) {
  const int rr = w1 & 0xFFFF, cc = w1 >> 16;
  const int isl = (w0 >> 2) & 7;
  if (isl == 5 || isl == 6) {
    // luma quad batch: sub-blocks in q order, each reading the pixels its
    // predecessors just wrote (phase 2q loads taps, 2q+1 predicts)
    const int q = ph >> 1, ssz = isl == 5 ? 4 : 8;
    const int ro = ssz * (q >> 1), co = ssz * (q & 1);
    const int nib = (w0 >> (5 + 4 * q)) & 0xF;
    if (nib == 0xF) return;     // slot absent
    if (!(ph & 1)) {
      mobi_load_taps(sh->tap[0], plane, g, rr + ro, cc + co, t);
      return;
    }
    const int i = t >> 4, j = t & 15;
    if (i >= ssz || j >= ssz) return;
    const int mode = mobi_min(nib + (ssz == 4 ? 10 : 0), 19);
    const int avt = q < 2 ? (w2 & 1) : 1, avl = (q & 1) == 0 ? ((w2 >> 1) & 1) : 1;
    int px = mobi_pred_dir(sh->tap[0], tabs, mode, i, j, ssz, ssz == 4 ? 2 : 3, avt, avl);
    const int hbits = (w0 >> 21) & 0xF;
    if ((hbits >> q) & 1)
      px = mobi_clip8(px + mobi_res(rz, w3 + mobi_popc(hbits & ((1u << q) - 1)), i, j));
    mobi_put(plane, g, rr + ro + i, cc + co + j, px);
  } else if (isl == 7) {
    // chroma U+V pair: both predictions from taps loaded before either write
    if (ph == 0) {
      if (t < 96) {
        const int half = t >= 48;
        mobi_load_taps(sh->tap[half], plane, g, rr, cc + (half ? g.S / 2 : 0), t - 48 * half);
      }
      return;
    }
    if (t >= 128) return;
    const int half = t >> 6, i = (t >> 3) & 7, j = t & 7;
    const int mode = mobi_min((w0 >> 5) & 0x1F, 19);
    const int hasu = (w0 >> 10) & 1, hasv = (w0 >> 11) & 1;
    const int avt = rr != MOBI_MR + g.H, avl = cc != MOBI_MCOL;
    int px = mobi_pred_dir(sh->tap[half], tabs, mode, i, j, 8, 3, avt, avl);
    if (half ? hasv : hasu) px = mobi_clip8(px + mobi_res(rz, half ? w3 + hasu : w3, i, j));
    mobi_put(plane, g, rr + i, cc + (half ? g.S / 2 : 0) + j, px);
  } else {
    // single block: directional/DC, or the plane closed form (modes 2/12)
    if (ph == 0) {
      mobi_load_taps(sh->tap[0], plane, g, rr, cc, t);
      return;
    }
    const int size = 1 << isl, i = t >> 4, j = t & 15;
    if (i >= size || j >= size) return;
    const int mode = mobi_min((w0 >> 5) & 0x1F, 19);
    const int has = (w0 >> 10) & 1, avt = (w0 >> 11) & 1, avl = (w0 >> 12) & 1;
    int px = (mode == 2 || mode == 12)
        ? mobi_plane_px(sh->tap[0], size, w2, i, j)
        : mobi_pred_dir(sh->tap[0], tabs, mode, i, j, size == 4 ? 4 : 8, size == 4 ? 2 : 3,
                        avt, avl);
    if (has) px = mobi_clip8(px + ((i < 8 && j < 8) ? mobi_res(rz, w3, i, j) : 0));
    mobi_put(plane, g, rr + i, cc + j, px);
  }
}

// Barrier-separated phases an op row needs.
MOBI_HD static inline int mobi_op_phases(int w0) {
  const int typ = w0 & 3;
  if (typ == 3) {
    const int isl = (w0 >> 2) & 7;
    return (isl == 5 || isl == 6) ? 8 : 2;
  }
  return typ == 0 ? 0 : 1;
}

MOBI_HD static inline void mobi_op_phase(const MobiGeom& g, const uint8_t* ring,
                                         uint8_t* plane, const int32_t* rz,
                                         const uint8_t* tabs, int fm, int w0, int w1,
                                         int w2, int w3, int ph, int t, MobiShared* sh) {
  switch (w0 & 3) {
    case 1: mobi_mc(g, ring, plane, rz, fm, w0, w1, w2, w3, t); break;
    case 2: mobi_resid(g, plane, rz, w0, w1, w3, t); break;
    case 3: mobi_intra(g, plane, rz, tabs, w0, w1, w2, w3, ph, t, sh); break;
    default: break;
  }
}

// One stream's whole GOP: chunks in order, ops in order inside each chunk.
MOBI_HD static inline void mobi_run_stream(const MobiArgs& a, int b, MobiShared* sh) {
  const MobiGeom g = mobi_geom(a.H, a.S);
  const size_t psz = (size_t)g.R * g.SP;
  uint8_t* ring = a.ring + (size_t)b * 6 * psz;
  for (int c = 0; c < a.nct; ++c) {
    const int32_t* ck = a.ops + ((size_t)b * a.nct + c) * MOBI_CHUNK * 4;
    const int32_t* rz = a.resid + ((size_t)b * a.nct + c) * MOBI_CHUNK * 64;
    const int count = mobi_min(ck[0], MOBI_CHUNK - 1), fid = ck[1];
    const int first = ck[2], last = ck[3];
    if (fid < 0 || fid >= a.F) continue;
    const int fm = fid % 6;
    uint8_t* plane = a.frames + ((size_t)fid * a.B + b) * psz;
    if (first) {
      MOBI_PAR(t, for (size_t k = t; k < psz; k += MOBI_NT) plane[k] = 0;);
    }
    for (int r = 1; r <= count; ++r) {
      const int32_t* w = ck + r * 4;
      const int w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
      const int nph = mobi_op_phases(w0);
      for (int ph = 0; ph < nph; ++ph) {
        MOBI_PAR(t, mobi_op_phase(g, ring, plane, rz, a.tabs, fm, w0, w1, w2, w3, ph, t, sh););
      }
    }
    if (last) {
      uint8_t* dst = ring + (size_t)(5 - fm) * psz;
      MOBI_PAR(t, for (size_t k = t; k < psz; k += MOBI_NT) dst[k] = plane[k];);
    }
  }
}
