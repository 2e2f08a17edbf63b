// Per-row code of the whole-GOP decode's device prologue, written once for
// the GPU kernels (prologue.cu, nvcc) and for a host build (prologue_host.cpp,
// g++) that the CPU tests hold against the JAX package.
//
// Replaces XLA code of mobiclipdecoder_tpu/ops/vmem_engine.py (the JAX
// package runs it outside its Pallas kernel; there is no pallas_call):
//   mobi_unpack_op3    _unpack_ops3 (:1779), the op-row widening of
//                      _decode_gop_fused_sblob (:1618);
//   mobi_scatter_one   the int16 pair decode and the per-stream coefficient
//                      scatter of _decode_gop_fused_sblob (:1620-1634);
//   mobi_row_size      its size-bit unpack (:1635-1638);
//   mobi_residual_row  _residuals (:215) for one row, with _btf8_ax0 (:180)
//                      and _btf4_ax0 (:205).
// The plain PyTorch versions are ops/prologue.py unpack_gop_blob and
// ops/residuals.py _residuals.
//
// What bounds the stage on the card: bytes.  Per DS 256x192 GOP of 8
// streams x 24 frames the padded layout has 131,072 rows: the blob's op rows
// (1.6 MB) and nonzeros are read, and ops (2.1 MB) and resid (33.5 MB) are
// written, about 40 MB or 12 us at 3.35 TB/s; the arithmetic (about 10^8
// integer operations) is far below its own bound.  The design therefore
// moves each byte once where it can: the scatter writes the nonzeros
// straight into the zeroed resid buffer, and the row transform then runs in
// place there (each block stages its rows in shared memory, so that reads
// and writes are coalesced), widening the op rows and reading the size bits
// in the same pass.  The plain chain instead runs about 160 elementwise
// launches over the whole layout.
//
// Arithmetic is int32 with arithmetic right shifts, as in the reference
// (MobiclipDecoder.cs:3450-3505, :3728-3784).  Coefficient magnitudes below
// 2^24 keep every intermediate of the two butterfly passes inside int32 (the
// passes grow a value at most about 83 times), so the results equal the
// plain version's wrapping int32 tensors bit for bit; dequantized
// coefficients are far smaller.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define MOBI_PRO_HD __host__ __device__ __forceinline__
#else
#define MOBI_PRO_HD inline
#endif

// One packed op row (3 words) -> the executor's 4 words (the inverse of
// ops/packing.py _pack_ops3).  Logical shifts on uint32.
MOBI_PRO_HD void mobi_unpack_op3(const int32_t* p3, int32_t* out) {
  const uint32_t a = (uint32_t)p3[0];
  const uint32_t b = (uint32_t)p3[1];
  out[0] = (int32_t)(a & 0x03FFFFFFu);
  out[1] = (int32_t)((b & 0xFFFu) | (((b >> 12) & 0xFFFu) << 16));
  out[2] = p3[2];
  out[3] = (int32_t)((((a >> 26) & 0x3Fu) << 8) | ((b >> 24) & 0xFFu));
}

// Size of row r (4 or 8): bit r of the little-endian size-bit words.
MOBI_PRO_HD int mobi_row_size(const int32_t* sbits, int64_t r) {
  return (((uint32_t)sbits[r >> 5] >> (r & 31)) & 1u) ? 4 : 8;
}

// Nonzero i = b * nnzb + k of the blob: its value, the k-th int16 of stream
// b's little-endian pairs (nnzb is even, so word i / 2, the low half for an
// even k), goes to dense[b * rows64 + idx[i]].  An index outside
// [0, rows64), such as the pads (rows64 exactly), is dropped.  Each index
// is written at most once, so the order of the nonzeros does not matter.
MOBI_PRO_HD void mobi_scatter_one(int32_t* dense, const int32_t* idx,
                                  const int32_t* v32, int64_t i, int64_t nnzb,
                                  int64_t rows64) {
  const int32_t x = idx[i];
  if (x < 0 || (int64_t)x >= rows64) return;
  const int32_t w = v32[i >> 1];
  const int32_t v = (i & 1) ? (w >> 16) : (((w & 0xFFFF) ^ 0x8000) - 0x8000);
  dense[(i / nnzb) * rows64 + x] = v;
}

// 8-point butterfly of v[0], v[ST], ..., v[7 * ST], in place (_btf8_ax0).
template <int ST>
MOBI_PRO_HD void mobi_btf8(int32_t* v) {
  const int32_t r0 = v[0], r1 = v[ST], r2 = v[2 * ST], r3 = v[3 * ST];
  const int32_t r4 = v[4 * ST], r5 = v[5 * ST], r6 = v[6 * ST], r7 = v[7 * ST];
  const int32_t a0 = r0 + r4, a1 = r0 - r4;
  const int32_t b0 = r2 + (r6 >> 1), b1 = (r2 >> 1) - r6;
  const int32_t e0 = a0 + b0, e2 = a1 + b1, e4 = a1 - b1, e6 = a0 - b0;
  const int32_t o0 = r1 + r7 - r3 - (r3 >> 1);
  const int32_t o1 = r7 - r1 + r5 + (r5 >> 1);
  const int32_t o2 = r5 - r7 - (r7 >> 1) - r3;
  const int32_t o3 = r3 + r5 + r1 + (r1 >> 1);
  const int32_t f1 = o2 + (o3 >> 2), f7 = o3 - (o2 >> 2);
  const int32_t f3 = o0 + (o1 >> 2), f5 = (o0 >> 2) - o1;
  v[0] = e0 + f7;
  v[ST] = e2 + f5;
  v[2 * ST] = e4 + f3;
  v[3 * ST] = e6 + f1;
  v[4 * ST] = e6 - f1;
  v[5 * ST] = e4 - f3;
  v[6 * ST] = e2 - f5;
  v[7 * ST] = e0 - f7;
}

// 4-point butterfly of v[0], v[ST], v[2 * ST], v[3 * ST], in place
// (_btf4_ax0, IDCT16Px4).
template <int ST>
MOBI_PRO_HD void mobi_btf4(int32_t* v) {
  const int32_t r0 = v[0], r1 = v[ST], r2 = v[2 * ST], r3 = v[3 * ST];
  const int32_t e0 = r0 + r2, e1 = r0 - r2;
  const int32_t o0 = r1 + (r3 >> 1), o1 = (r1 >> 1) - r3;
  v[0] = e0 + o0;
  v[ST] = e1 + o1;
  v[2 * ST] = e1 - o1;
  v[3 * ST] = e0 - o0;
}

// One row of _residuals: 64 coefficients and the row's size -> 64 words
// whose (8, 8) row-major view is the spatial residual.  `in` and `out` may
// be the same row: every read comes before the first write.
//   size 8: one 8x8 block; +32 on [0, 0], a butterfly along each coefficient
//           row, then along each column, >> 6; output row i, column j is
//           column i's j-th output.
//   size 4: four 4x4 quads [q0|q1|q2|q3] of 16 words, each with its own +32
//           and the same two passes; quad q's column oc, output or lands at
//           row (q >> 1) * 4 + oc, column (q & 1) * 4 + or (idct4's
//           transposed orientation).
// Any size other than 4 is an 8x8 block, as in the plain version.  A row of
// zeros gives zeros (the +32 is shifted out).
MOBI_PRO_HD void mobi_residual_row(const int32_t* in, int size, int32_t* out) {
  int32_t c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = in[k];
  if (size == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q * 16] += 32;
#pragma unroll
      for (int r = 0; r < 4; ++r) mobi_btf4<1>(c + q * 16 + r * 4);
#pragma unroll
      for (int oc = 0; oc < 4; ++oc) mobi_btf4<4>(c + q * 16 + oc);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int oc = 0; oc < 4; ++oc)
#pragma unroll
        for (int o = 0; o < 4; ++o)
          out[((q >> 1) * 4 + oc) * 8 + (q & 1) * 4 + o] = c[q * 16 + o * 4 + oc] >> 6;
  } else {
    c[0] += 32;
#pragma unroll
    for (int r = 0; r < 8; ++r) mobi_btf8<1>(c + r * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) mobi_btf8<8>(c + i);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[i * 8 + j] = c[j * 8 + i] >> 6;
  }
}
