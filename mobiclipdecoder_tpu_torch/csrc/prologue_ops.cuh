// Code of the whole-GOP decode's device prologue, written once for the GPU
// kernels (prologue.cu, nvcc) and for a host build (prologue_host.cpp, g++)
// that the CPU tests hold against the JAX package.
//
// Replaces XLA code of mobiclipdecoder_tpu/ops/vmem_engine.py (the JAX
// package runs it outside its Pallas kernel; there is no pallas_call):
//   mobi_unpack_op3    _unpack_ops3 (:1779), the op-row widening of
//                      _decode_gop_fused_sblob (:1618);
//   mobi_blob_value    the int16 pair decode of _decode_gop_fused_sblob
//                      (:1620-1622);
//   mobi_row_size      its size-bit unpack (:1635-1638);
//   mobi_residual_row  _residuals (:215) for one row, with _btf8_ax0 (:180)
//                      and _btf4_ax0 (:205);
//   mobi_sblob_block   all of _decode_gop_fused_sblob's unpack (:1607-1639)
//                      and _residuals for one block of MOBI_ROWS rows: the
//                      per-stream coefficient scatter becomes a gather of
//                      the block's nonzeros (K5, prologue.cu).
// The plain PyTorch versions are ops/prologue.py unpack_gop_blob and
// ops/residuals.py _residuals.
//
// What bounds the stage on the card: bytes.  Per DS 256x192 GOP of 8
// streams x 24 frames the padded layout has 155,648 rows: the blob's op
// rows (1.9 MB), size bits and nonzero slots (3.1 MB) are read, and ops
// (2.5 MB) and resid (39.8 MB) are written, about 47 MB or 14 us at
// 3.35 TB/s; the arithmetic (about 10^8 integer operations) is below its
// own bound.  The design therefore writes each output byte once and reads
// no output back: a block finds its rows' nonzeros in the stream's sorted
// index list, places them in a zeroed tile in shared memory, transforms
// the tile's rows there and writes them out with coalesced stores, with
// the op widening and the size bits in the same pass.  The plain chain
// instead runs about 160 elementwise launches over the whole layout.
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

// Value of slot k of a stream's nonzeros: the k-th int16 of the stream's
// little-endian pairs v32 (word k / 2, the low half for an even k).
MOBI_PRO_HD int32_t mobi_blob_value(const int32_t* v32, int k) {
  const int32_t w = v32[k >> 1];
  return (k & 1) ? (w >> 16) : (((w & 0xFFFF) ^ 0x8000) - 0x8000);
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

#define MOBI_ROWS 128   // rows of one block of K4 and K5, one per thread
#define MOBI_PITCH 65   // words per staged row: a warp's 32 rows in 32 banks

#if defined(__CUDA_ARCH__)
#define MOBI_SYNC() __syncthreads()
#else
#define MOBI_SYNC() ((void)0)
#endif

// Whether K5 takes these sizes: B streams of nrows / B rows each, a whole
// number of blocks per stream (so that no block straddles two streams; the
// layout's nct * 256 rows always are), an even nnzb whose slots a 32-bit
// int counts, and each stream's coefficient positions below 2^31.
MOBI_PRO_HD bool mobi_sblob_sizes_ok(long long B, long long nnzb, long long nrows) {
  if (B < 1 || nrows < 1 || nrows % B != 0) return false;
  const long long rows_ps = nrows / B;
  return rows_ps % MOBI_ROWS == 0 && rows_ps * 64 <= 0x7FFFFFFFLL && nnzb >= 2 &&
         (nnzb & 1) == 0 && nnzb <= (1LL << 30);
}

// The first slot s of idx[0, n) after the last slot whose index, compared
// as uint32, is below key: the lower bound of key where the in-range
// indices ascend (pads, larger and negative indices all compare as at
// least any key).  A warp-cooperative 32-ary search: lane l probes slot
// a + l * step of the open range [a, b), a ballot of "below key" narrows
// the range to the gap after the highest probe below it, and about 4
// rounds cover n <= 262,144.  Narrowing to the last probe below (and not to
// the first at or above) keeps a negative index in a stream's first slot
// from ending the search at 0.  All 32 lanes of the warp call it and get
// the same answer; the host build computes the ballot in a loop (lane is
// then unused).
MOBI_PRO_HD int mobi_search32(const int32_t* idx, int n, uint32_t key, int lane) {
  int a = 0, b = n;
  while (a < b) {
    const int step = (b - a + 31) >> 5;
#if defined(__CUDA_ARCH__)
    const int q = a + lane * step;
    const unsigned below = __ballot_sync(0xFFFFFFFFu, q < b && (uint32_t)idx[q] < key);
    const int last = 31 - __clz((int)below);
#else
    (void)lane;
    int last = -1;
    for (int l = 0; l < 32; ++l) {
      const int q = a + l * step;
      if (q < b && (uint32_t)idx[q] < key) last = l;
    }
#endif
    if (last < 0) return a;
    const int q_last = a + last * step;
    b = q_last + step < b ? q_last + step : b;
    a = q_last + 1;
  }
  return a;
}

// K5's work for block blk: rows [blk * MOBI_ROWS, + MOBI_ROWS) of the
// layout (the last block may be shorter), all of one stream b.
//   1. The range [lo, hi) of stream b's slots whose indices fall in the
//      block's coefficient positions [r0 * 64, r1 * 64): warp 0 searches lo,
//      warp 1 hi (mobi_search32); meanwhile the tile is zeroed.
//   2. The block's threads walk [lo, hi) in coalesced steps and write each
//      value whose index, compared as uint32, lies in the block's positions
//      into the tile.  The check drops the pads, out-of-range and negative
//      indices, and makes a search range that is too wide harmless.
//   3. Each thread transforms its row in the tile (mobi_residual_row, the
//      size from the size bits) and widens its packed op row into ops.
//   4. The block writes the tile's rows to resid with coalesced stores.
// Every row of ops and resid is written exactly once, so neither needs a
// fill beforehand.
// The input contract is the JAX package's own (its scatter is told
// indices_are_sorted, unique_indices, mode="drop"): each stream's in-range
// indices ascend and are unique, and the rest are dropped; the assemblers
// put the pads (rows * 64) after the nonzeros.  Under it, a negative index
// in the first slot and pads followed by larger or negative indices give the
// plain version's answer.  Out of it (in-range indices out of order,
// duplicates, or junk between in-range entries) nothing is promised, as in
// the JAX package.
// On the card every thread of the block calls this with its threadIdx.x
// and STRIDE = MOBI_ROWS, the tile and range in shared memory; the host
// build calls it once per block with tid 0 and STRIDE = 1, so that each
// loop runs every thread's iterations in turn and the barriers fall at the
// loops' ends.
template <int STRIDE>
MOBI_PRO_HD void mobi_sblob_block(long long blk, int tid, const int32_t* ops3,
                                  const int32_t* sbits, const int32_t* idx,
                                  const int32_t* v32, int32_t* ops, int32_t* resid,
                                  long long nrows, long long rows_ps, int nnzb,
                                  int32_t* tile, int* range) {
  const int64_t row0 = (int64_t)blk * MOBI_ROWS;
  const int nr = nrows - row0 < MOBI_ROWS ? (int)(nrows - row0) : MOBI_ROWS;
  const int64_t b = row0 / rows_ps;
  const uint32_t key0 = (uint32_t)((row0 - b * rows_ps) * 64);
  const int32_t* sidx = idx + b * nnzb;
  const int32_t* sv32 = v32 + b * (nnzb >> 1);
  for (int w = tid >> 5; w < 2; w += (STRIDE + 31) >> 5) {
    const int s = mobi_search32(sidx, nnzb, key0 + (uint32_t)(w * nr * 64), tid & 31);
    if ((tid & 31) == 0) range[w] = s;
  }
#pragma unroll 5
  for (int w = tid; w < MOBI_ROWS * MOBI_PITCH; w += STRIDE) tile[w] = 0;
  MOBI_SYNC();
  const int hi = range[1];
  for (int k = range[0] + tid; k < hi; k += STRIDE) {
    const uint32_t rel = (uint32_t)sidx[k] - key0;
    if (rel < (uint32_t)(nr * 64))
      tile[(rel >> 6) * MOBI_PITCH + (rel & 63)] = mobi_blob_value(sv32, k);
  }
  MOBI_SYNC();
  for (int t = tid; t < nr; t += STRIDE) {
    const int64_t r = row0 + t;
    mobi_residual_row(tile + t * MOBI_PITCH, mobi_row_size(sbits, r), tile + t * MOBI_PITCH);
    mobi_unpack_op3(ops3 + r * 3, ops + r * 4);
  }
  MOBI_SYNC();
  int32_t* dst = resid + row0 * 64;
#pragma unroll 8
  for (int w = tid; w < nr * 64; w += STRIDE) dst[w] = tile[(w >> 6) * MOBI_PITCH + (w & 63)];
}
