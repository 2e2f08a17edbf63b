"""Frame planner: entropy-scan a frame into a device-friendly *frame plan*.

This is the TPU-native architecture's central seam (SURVEY.md §7): the codec
splits into an inherently sequential bitstream scan (entropy + mode + MV
decode) and massively parallel pixel reconstruction.  ``PlanningDecoder``
subclasses the oracle (sharing its parse path verbatim — zero divergence risk)
but overrides the ``_exec_*`` hooks to *record* reconstruction ops instead of
performing them.  The result is a :class:`FramePlan` of flat numpy arrays that
the JAX/Pallas engine (models/pipeline.py) consumes.

Decode-order semantics
----------------------
The reference reconstructs macroblocks strictly sequentially into freshly
zeroed planes, and intra prediction reads *whatever is in the plane at that
moment* — including zeros from not-yet-decoded regions (e.g. vertical-left
modes tapping above-right of the current block, MobiclipDecoder.cs:2368-2471).
To reproduce this with parallel reconstruction, the planner emits:

* a per-4x4-cell **sequence map** ``s`` (which op finalizes each cell), so
  intra tap gathers can mask "future" pixels to the fresh-plane value (0);
* a per-intra-op **dependency level**: 1 + max level over tap cells that are
  genuinely decoded before it.  The engine runs all MC, then all inter
  residuals, then intra ops level by level — each level's ops are mutually
  independent and vectorize.

Coordinates: luma ops address the Y plane (H x S); chroma ops address the
packed UV plane (H/2 x S) with U in columns [0, S/2) and V in [S/2, S) —
preserving the reference's U/V boundary aliasing semantics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .oracle_video import OracleDecoder


@dataclasses.dataclass
class FramePlan:
    """All reconstruction work for one frame, as dense numpy arrays."""

    width: int
    height: int
    stride: int
    # --- motion compensation (phase 1): int32 (N, 7)
    # columns: y, x, w, h, ref(1..5), dx, dy   (luma coords, half-pel MVs)
    mc: np.ndarray
    # --- inter residuals (phase 2)
    # int32 (M, 4): plane(0=Y,1=UV), y, x, size(4|8); coefficients (M, 64)
    resid: np.ndarray
    resid_coef: np.ndarray
    # --- intra ops (phase 3), in decode order
    # int32 (K, 10): plane, y, x, size(4|8|16), mode, gradient, has_coef,
    #                avail_top, avail_left, level
    intra: np.ndarray
    intra_coef: np.ndarray  # (K, 64) int32, zeros when has_coef == 0
    # --- sequence maps at 4x4-cell granularity, -1 = never written.
    # Holds the FIRST op sequence writing each cell: a tap pixel is visible
    # to a reader at sequence q iff first_write < q (see mark() in plan()).
    seq_y: np.ndarray   # (H/4, S/4) int32
    seq_uv: np.ndarray  # (H/8, S/4) int32
    n_levels: int


NOP, OP_MC, OP_RESID, OP_INTRA = 0, 1, 2, 3
_SIZE_LOG = {2: 1, 4: 2, 8: 3, 16: 4}


def pack_unified(ops: list[tuple], stride: int, height: int,
                 mr: int = 8, mcol: int = 8) -> dict:
    """Pack a decode-order op list into the VMEM executor's flat arrays.

    The sequential VMEM engine (ops/vmem_engine.py) executes ops in the
    reference's exact decode order, so no sequence maps or dependency levels
    are needed — "read whatever is in the plane" semantics hold by
    construction.  Record (int32 x 4):

      w0 = type(2) | size_log(3)<<2 | mode(5)<<5 | has_coef<<10
           | avail_top<<11 | avail_left<<12 | ref(3)<<13 | w(5)<<16 | h(5)<<21
      w1 = row | col<<16           (buffer coords, margins included;
                                    chroma rows offset by height)
      w2 = (dx&0xFFFF)|(dy&0xFFFF)<<16  for MC; gradient for intra
      w3 = residual-coefficient row index (0 when unused)

    Residual ops come in three region forms (size_log in w0 bits 2..4):
      2/3 = plain 4x4/8x8 region (one coefficient row);
      4   = masked 16x16: up to four 8x8 quads of one MB applied in ONE
            op — w0 bits 5..8 are the quad mask, w3 the first of its
            consecutive rows (the batched form of a split-MB's luma
            residuals, which cannot ride a single leaf's MC op);
      5   = chroma U+V pair: both 8x8 chroma residuals of one MB in ONE
            op — w0 bits 5..6 = (U present, V present), w1's column is
            the U base (V sits at the static +S/2 offset).

    Intra ops also come in batched forms (size_log in w0 bits 2..4):
      2/3 = plain single 4x4/8x8 (mode@5, has@10, avt@11, avl@12, w2 =
            plane gradient);
      5/6 = luma quad batch: up to four consecutive 4x4 (sl 5) or 8x8
            (sl 6) directional intra ops of one parent 8x8/16x16 in ONE
            op.  w0 bits 5..20 = four 4-bit mode nibbles (mode-10 for
            sl 5; 0xF = slot absent), bits 21..24 = has bits; w1 is the
            parent base; w2 = parent avail_top | avail_left<<1; w3 the
            first of the consecutive coefficient rows.  In-batch
            sub-blocks read their neighbors' freshly predicted pixels
            (the kernel updates its local window between sub-blocks),
            reproducing the sequential plane semantics exactly.  Plane
            modes (2/12) and pass-throughs break a batch.
      7   = chroma U+V intra pair: both 8x8 chroma predictions of one MB
            (same mode by construction) in one op — mode@5..9,
            has_u@10, has_v@11; U and V halves are independent reads so
            one window + one placement serves both.

    Intra modes 9/19 (pass-through) are emitted as plain residual ops (their
    prediction is a no-op); without coefficients they are dropped entirely.
    """
    S, H = stride, height
    rows: list[tuple[int, int, int, int]] = []
    coefs: list[np.ndarray] = []
    sizes: list[int] = []
    # MC+residual fusion peephole: an unsplit inter MB is one 16x16 MC op
    # followed by its <=6 residual emissions (cbp bits 0..3 luma quads,
    # 4 U, 5 V) — the residual rows attach to the MC op (w0 bits 3..8 =
    # mask, w3 = first row; rows are consecutive by construction) and emit
    # NO op row of their own.  Exactness-safe: nothing reads the plane
    # between an MB's MC and its residuals, and the kernel's
    # clip(px + res) equals the two-op sequence pixel-for-pixel.
    fuse = {"idx": -1, "y": -1, "x": -1, "last": -1, "n": 0}

    def try_fuse(pid, ry, rx, k) -> bool:
        if fuse["idx"] < 0:
            return False
        fy, fx = fuse["y"], fuse["x"]
        if pid == 0:
            if ry not in (fy, fy + 8) or rx not in (fx, fx + 8):
                fuse["idx"] = -1
                return False
            bit = ((ry - fy) >> 3) * 2 + ((rx - fx) >> 3)
        else:
            if ry != fy >> 1:
                fuse["idx"] = -1
                return False
            if rx == fx >> 1:
                bit = 4
            elif rx == (fx >> 1) + S // 2:
                bit = 5
            else:
                fuse["idx"] = -1
                return False
        if bit <= fuse["last"]:
            fuse["idx"] = -1
            return False
        i = fuse["idx"]
        w0, w1, w2, w3 = rows[i]
        if fuse["n"] == 0:
            w3 = k
        elif k != w3 + fuse["n"]:
            fuse["idx"] = -1
            return False
        rows[i] = (w0 | (1 << (3 + bit)), w1, w2, w3)
        fuse["last"] = bit
        fuse["n"] += 1
        return True
    # quad-merge peephole state: consecutive 4x4 residuals of one 8x8
    # fold into a single size-8-region op whose coefficient row holds the
    # sub-blocks in quadrant slots [q0|q1|q2|q3] (the _residuals pre-pass
    # IDCTs each; absent quadrants are zero => untouched pixels).  Legal
    # because the sub-ops are emitted consecutively and write disjoint
    # pixels; cuts the dominant op type ~3x.  Mirrored bit-identically by
    # the C++ scanner (native/scanner.cpp u_resid).
    quad = {"key": None, "row": -1, "b": -1}
    # residual-batch peephole: 8x8-region residual rows that could NOT
    # ride an MC op (split-MB residuals, intra pass-through) accumulate
    # per MB into ONE masked-16x16 op (luma) / ONE U+V pair op (chroma).
    # Exactness-safe for the same reason as MC fusion: the batched rows
    # are consecutive in decode order and nothing reads their pixels in
    # between; clip(cur + res) per region equals the op-per-region
    # sequence pixel-for-pixel.
    pend = {"on": False, "pid": 0, "my": 0, "mx": 0,
            "mask": 0, "first": 0, "n": 0, "last": -1}
    # split-MB leaf deferral: a split MB's leaf MC ops buffer until its
    # luma residual section resolves, so residual quads can ATTACH to the
    # covering leaf (same mask/rows encoding as the 16x16 MC fusion — the
    # kernel's fold is leaf-size-agnostic).  Order is preserved: leaves
    # always append before any later op row.
    leaves: list[list] = []   # [w0, w1, w2, w3, ly, lx, w, h, nrows]
    leaf_mb = {"my": -1, "mx": -1}

    def flush_leaves():
        for lf in leaves:
            rows.append((lf[0], lf[1], lf[2], lf[3]))
        leaves.clear()

    def try_attach(first, mask):
        """Attach the luma pend's quads to covering leaves; True when ALL
        quads attach (each leaf's rows a contiguous ascending run)."""
        if not leaves:
            return False
        my, mx = pend["my"], pend["mx"]
        if (my, mx) != (leaf_mb["my"], leaf_mb["mx"]):
            return False
        # validation pass (no mutation): every quad must land in a
        # covering leaf, visiting leaves in non-decreasing order with
        # ascending bits — which makes each leaf's absorbed rows a
        # contiguous run of the pend's (already consecutive) rows
        plan_rows = []     # (leaf index, leaf-relative bit)
        li_last = -1
        bit_last = -1
        for b in range(4):
            if not (mask >> b) & 1:
                continue
            ry = my + 8 * (b >> 1)
            rx = mx + 8 * (b & 1)
            hit = -1
            for li, lf in enumerate(leaves):
                ly, lx, w, h = lf[4], lf[5], lf[6], lf[7]
                if (ly <= ry and ry + 8 <= ly + h
                        and lx <= rx and rx + 8 <= lx + w):
                    hit = li
                    break
            if hit < 0:
                return False
            bit = ((ry - leaves[hit][4]) >> 3) * 2 \
                + ((rx - leaves[hit][5]) >> 3)
            if hit < li_last:
                return False        # revisiting an earlier leaf would
                                    # split its row run
            if hit == li_last and bit <= bit_last:
                return False
            plan_rows.append((hit, bit))
            li_last = hit
            bit_last = bit
        k = first
        for hit, bit in plan_rows:
            lf = leaves[hit]
            if lf[8] == 0:
                lf[3] = k
            lf[0] |= 1 << (3 + bit)
            lf[8] += 1
            k += 1
        return True

    def flush_pend():
        if not pend["on"]:
            return
        pend["on"] = False
        pid, mask, first = pend["pid"], pend["mask"], pend["first"]
        if pid == 0 and try_attach(first, mask):
            flush_leaves()
            return
        flush_leaves()
        if pend["n"] == 1:
            # single region: the plain 8x8 form is cheaper in-kernel
            bit = mask.bit_length() - 1
            if pid == 0:
                ry = pend["my"] + 8 * (bit >> 1)
                rx = pend["mx"] + 8 * (bit & 1)
            else:
                ry = pend["my"]
                rx = pend["mx"] + (S // 2 if bit else 0)
            w0 = OP_RESID | (_SIZE_LOG[8] << 2)
            rr = mr + ry + (H if pid else 0)
            rows.append((w0, rr | ((mcol + rx) << 16), 0, first))
            return
        sl = 4 if pid == 0 else 5
        w0 = OP_RESID | (sl << 2) | (mask << 5)
        rr = mr + pend["my"] + (H if pid else 0)
        rows.append((w0, rr | ((mcol + pend["mx"]) << 16), 0, first))

    def pend_add(pid, y, x, k):
        """Accumulate an 8x8-region residual row; (y, x) are plane coords
        of the region base."""
        if pid == 0:
            my, mx = y & ~15, x & ~15
            bit = ((y - my) >> 3) * 2 + ((x - mx) >> 3)
        else:
            my = y
            mx, bit = (x - S // 2, 1) if x >= S // 2 else (x, 0)
        if (pend["on"] and pend["pid"] == pid and pend["my"] == my
                and pend["mx"] == mx and bit > pend["last"]
                and k == pend["first"] + pend["n"]):
            pend["mask"] |= 1 << bit
            pend["last"] = bit
            pend["n"] += 1
            return
        flush_pend()
        pend.update(on=True, pid=pid, my=my, mx=mx, mask=1 << bit,
                    first=k, n=1, last=bit)

    def coef_row(dense, size) -> int:
        co = np.zeros(64, np.int32)
        co[:size * size] = np.asarray(dense, np.int32).ravel()
        coefs.append(co)
        sizes.append(size)
        return len(coefs) - 1

    # intra-batch peepholes: consecutive directional luma intra ops of one
    # parent block fold into a quad-batch op; a chroma U+V intra pair of
    # one MB folds into one pair op.  Exactness: the batched ops are a
    # CONTIGUOUS subsequence of the stream (any other op flushes), and the
    # kernel applies them in q order against its locally-updated window,
    # so every tap sees exactly the pixels the plain sequence would.
    ibat = {"on": False, "size": 8, "by": 0, "bx": 0, "lastq": -1,
            "slots": []}       # slot: (q, y, x, mode, has, k)
    ivb = {"on": False, "y": 0, "x": 0, "mode": 0, "has": 0, "k": 0}

    def _plain_intra(pid, y, x, size, mode, has, k, grad=0):
        half = S // 2 if (pid == 1 and x >= S // 2) else 0
        avl = int((x - half) != 0)
        avt = int(y != 0)
        w0 = (OP_INTRA | (_SIZE_LOG[size] << 2) | (mode << 5)
              | (has << 10) | (avt << 11) | (avl << 12))
        rr = mr + y + (H if pid else 0)
        rows.append((w0, rr | ((mcol + x) << 16), grad, k))

    def flush_ibat():
        if not ibat["on"]:
            return
        ibat["on"] = False
        slots = ibat["slots"]
        size = ibat["size"]
        if len(slots) == 1:
            q, y, x, mode, has, k = slots[0]
            _plain_intra(0, y, x, size, mode, has, k)
            return
        nibs = [0xF] * 4
        hasbits = 0
        w3 = 0
        off = 10 if size == 4 else 0
        for q, _y, _x, mode, has, k in slots:
            nibs[q] = mode - off
            if has:
                if not hasbits:
                    w3 = k
                hasbits |= 1 << q
        sl = 5 if size == 4 else 6
        w0 = OP_INTRA | (sl << 2)
        for q in range(4):
            w0 |= nibs[q] << (5 + 4 * q)
        w0 |= hasbits << 21
        by, bx = ibat["by"], ibat["bx"]
        w2 = int(by != 0) | (int(bx != 0) << 1)
        rows.append((w0, (mr + by) | ((mcol + bx) << 16), w2, w3))

    def flush_ivb():
        if not ivb["on"]:
            return
        ivb["on"] = False
        _plain_intra(1, ivb["y"], ivb["x"], 8, ivb["mode"], ivb["has"],
                     ivb["k"])

    def emit_intra(pid, y, x, size, mode, grad, cf):
        flush_leaves()
        has = int(cf is not None)
        k = coef_row(cf[0], size) if has else 0
        if pid == 0 and size in (4, 8) and mode not in (2, 12):
            by = y & ~(2 * size - 1)
            bx = x & ~(2 * size - 1)
            q = ((y - by) // size) * 2 + ((x - bx) // size)
            if not (ibat["on"] and ibat["size"] == size
                    and ibat["by"] == by and ibat["bx"] == bx
                    and q > ibat["lastq"]):
                flush_ibat()
                flush_ivb()
                ibat.update(on=True, size=size, by=by, bx=bx, lastq=-1,
                            slots=[])
            ibat["slots"].append((q, y, x, mode, has, k))
            ibat["lastq"] = q
            return
        if pid == 1 and size == 8 and mode != 2:
            if (ivb["on"] and y == ivb["y"] and x == ivb["x"] + S // 2
                    and mode == ivb["mode"]):
                # complete U+V pair -> one op
                ivb["on"] = False
                w0 = (OP_INTRA | (7 << 2) | (mode << 5)
                      | (ivb["has"] << 10) | (has << 11))
                w3 = ivb["k"] if ivb["has"] else k
                rr = mr + H + y
                rows.append((w0, rr | ((mcol + ivb["x"]) << 16), 0, w3))
                return
            flush_ivb()
            flush_ibat()
            if x < S // 2:
                ivb.update(on=True, y=y, x=x, mode=mode, has=has, k=k)
                return
            _plain_intra(1, y, x, size, mode, has, k)
            return
        flush_ibat()
        flush_ivb()
        _plain_intra(pid, y, x, size, mode, has, k, int(grad or 0))

    def emit_resid(pid, y, x, size, dense):
        flush_ibat()
        flush_ivb()
        if size == 4:
            key = (pid, y >> 3, x >> 3)
            b = ((y >> 2) & 1) * 2 + ((x >> 2) & 1)
            if quad["key"] == key and b > quad["b"]:
                coefs[quad["row"]][16 * b:16 * b + 16] = \
                    np.asarray(dense, np.int32).ravel()
                quad["b"] = b
                return
            k = coef_row(np.zeros(16, np.int32), 4)
            coefs[k][16 * b:16 * b + 16] = \
                np.asarray(dense, np.int32).ravel()
            quad.update(key=key, row=k, b=b)
            if try_fuse(pid, y & ~7, x & ~7, k):
                return
            pend_add(pid, y & ~7, x & ~7, k)
            return
        quad["key"] = None
        k = coef_row(dense, size)
        # size is 8 here (the 4x4 branch above always returns)
        if try_fuse(pid, y, x, k):
            return
        pend_add(pid, y, x, k)

    for op in ops:
        kind = op[0]
        if kind == "mc":
            quad["key"] = None
            flush_pend()
            flush_ibat()
            flush_ivb()
            _, w, h, ref, dx, dy, off = op
            y, x = off // S, off % S
            w0 = (OP_MC | (ref << 13) | (w << 16) | (h << 21))
            w2 = (dx & 0xFFFF) | ((dy & 0xFFFF) << 16)
            if w2 >= 1 << 31:
                w2 -= 1 << 32
            if w == 16 and h == 16:
                flush_leaves()
                fuse.update(idx=len(rows), y=y, x=x, last=-1, n=0)
                rows.append((w0, (mr + y) | ((mcol + x) << 16), w2, 0))
            else:
                fuse["idx"] = -1
                my, mx = y & ~15, x & ~15
                if (my, mx) != (leaf_mb["my"], leaf_mb["mx"]):
                    flush_leaves()
                    leaf_mb.update(my=my, mx=mx)
                leaves.append([w0, (mr + y) | ((mcol + x) << 16), w2, 0,
                               y, x, w, h, 0])
        elif kind == "resid":
            _, pid, y, x, size, (dense, _last) = op
            emit_resid(pid, y, x, size, dense)
        else:  # intra
            fuse["idx"] = -1
            _, pid, y, x, size, mode, grad, cf = op
            if mode in (9, 19):
                if cf is not None:
                    emit_resid(pid, y, x, size, cf[0])
                continue
            quad["key"] = None
            flush_pend()
            emit_intra(pid, y, x, size, mode, grad, cf)

    flush_pend()
    flush_ibat()
    flush_ivb()
    flush_leaves()
    ops_arr = np.zeros((len(rows) + 1, 4), np.int32)
    ops_arr[0, 0] = len(rows)
    if rows:
        ops_arr[1:] = np.array(rows, np.int64).astype(np.int32)
    return dict(
        ops=ops_arr,
        coefs=(np.stack(coefs) if coefs else np.zeros((1, 64), np.int32)),
        sizes=(np.array(sizes, np.int32) if sizes
               else np.zeros((1,), np.int32)),
    )


class PlanningDecoder(OracleDecoder):
    """Oracle parse path + op recording (no pixel work).

    After ``decode_frame()`` (which returns zero planes — reconstruction is
    the engine's job), call :meth:`plan` for the FramePlan.  Ring-buffer
    bookkeeping still happens so multi-frame GOP planning works; the *engine*
    owns the actual reference pixels.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ops: list[tuple] = []

    # -- recording hooks ---------------------------------------------------
    def _exec_mc(self, w, h, ref, dx, dy, off):
        self._ops.append(("mc", w, h, ref, dx, dy, off))

    def _exec_intra(self, plane, off, size, mode, gradient, coefs):
        pid, y, x = self._locate(plane, off)
        self._ops.append(("intra", pid, y, x, size, mode,
                          0 if gradient is None else gradient,
                          coefs))

    def _exec_resid(self, plane, off, size, coefs):
        pid, y, x = self._locate(plane, off)
        self._ops.append(("resid", pid, y, x, size, coefs))

    def _exec_plane16(self, off, gradient):
        self._ops.append(("intra", 0, off // self.stride, off % self.stride,
                          16, 2, gradient, None))

    def _locate(self, plane, off):
        if plane is self.y_planes[0]:
            return 0, off // self.stride, off % self.stride
        return 1, off // self.stride, off % self.stride

    # -- plan assembly -----------------------------------------------------
    def decode_frame(self, rgb=False):
        self._ops = []
        return super().decode_frame(rgb=False)

    def unified_plan(self) -> dict:
        """Decode-order op stream for the sequential VMEM engine."""
        return pack_unified(self._ops, self.stride, self.height)

    def plan(self) -> FramePlan:
        S, H, W = self.stride, self.height, self.width
        cs = 4  # cell size
        seq_y = np.full((H // cs, S // cs), -1, dtype=np.int64)
        seq_uv = np.full((H // 2 // cs, S // cs), -1, dtype=np.int64)
        lvl_y = np.zeros_like(seq_y)
        lvl_uv = np.zeros_like(seq_uv)

        mc_rows, resid_rows, resid_coefs = [], [], []
        intra_rows, intra_coefs = [], []
        n_levels = 0

        def cells(seqmap, y, x, h, w):
            return seqmap[y // cs:(y + h + cs - 1) // cs,
                          x // cs:(x + w + cs - 1) // cs]

        def mark(seqmap, y, x, h, w, seq):
            """First-write sequence per cell: visibility for a reader at
            sequence q is 'exists a write before q', i.e. first_write < q.
            (Later rewrites of the same cell — residual-on-plane, pass-through
            modes — never straddle a foreign reader; same-MB ops are
            contiguous in decode order.)"""
            region = cells(seqmap, y, x, h, w)
            region[region == -1] = seq

        for seq, op in enumerate(self._ops):
            kind = op[0]
            if kind == "mc":
                _, w, h, ref, dx, dy, off = op
                y, x = off // S, off % S
                mc_rows.append((y, x, w, h, ref, dx, dy))
                mark(seq_y, y, x, h, w, seq)
                # chroma cells (U and V halves)
                cy, cxu = y // 2, x // 2
                cw, ch = max(w // 2, 1), max(h // 2, 1)
                mark(seq_uv, cy, cxu, ch, cw, seq)
                mark(seq_uv, cy, cxu + S // 2, ch, cw, seq)
            elif kind == "resid":
                _, pid, y, x, size, (dense, _last) = op
                resid_rows.append((pid, y, x, size))
                co = np.zeros(64, np.int32)
                co[:size * size] = dense.ravel()
                resid_coefs.append(co)
                smap = seq_y if pid == 0 else seq_uv
                mark(smap, y, x, size, size, seq)
            else:  # intra
                _, pid, y, x, size, mode, grad, coefs = op
                smap = seq_y if pid == 0 else seq_uv
                lmap = lvl_y if pid == 0 else lvl_uv
                ph = (H if pid == 0 else H // 2)
                # availability (mirrors the DC checks + general edge reads)
                half = (S // 2 if (pid == 1 and x >= S // 2) else 0)
                avail_left = (x - half) != 0
                avail_top = y != 0
                # tap cells: conservative superset of every mode's reads
                taps = []
                if y > 0:
                    x0 = max(x - cs, 0)
                    x1 = min(x + 2 * size, S)
                    taps.append((smap[(y - 1) // cs,
                                      x0 // cs:(x1 + cs - 1) // cs],
                                 lmap[(y - 1) // cs,
                                      x0 // cs:(x1 + cs - 1) // cs]))
                if x > 0:
                    y1 = min(y + size, ph)
                    taps.append((smap[y // cs:(y1 + cs - 1) // cs,
                                      (x - 1) // cs],
                                 lmap[y // cs:(y1 + cs - 1) // cs,
                                      (x - 1) // cs]))
                if mode in (9, 19):
                    # pass-through: residual applies onto earlier ops' output
                    taps.append((cells(smap, y, x, size, size).ravel(),
                                 cells(lmap, y, x, size, size).ravel()))
                level = 1
                for s_arr, l_arr in taps:
                    s_arr = np.atleast_1d(s_arr)
                    l_arr = np.atleast_1d(l_arr)
                    m = (s_arr >= 0) & (s_arr < seq)
                    if m.any():
                        level = max(level, int(l_arr[m].max()) + 1)
                idx = len(intra_rows)
                intra_rows.append((pid, y, x, size, mode, grad,
                                   0 if coefs is None else 1,
                                   int(avail_top), int(avail_left), level))
                co = np.zeros(64, np.int32)
                if coefs is not None:
                    dense, _last = coefs
                    co[:size * size] = dense.ravel()
                intra_coefs.append(co)
                mark(smap, y, x, size, size, seq)
                cells(lmap, y, x, size, size)[:] = level
                n_levels = max(n_levels, level)

        # Re-express seq maps in *intra-op index* terms for the engine: a tap
        # pixel is visible to intra op k iff its cell seq < op k's seq.  We
        # store per-cell the op-relative order directly: cells written by the
        # i-th recorded op get i; intra op k knows its own recorded seq.
        # (The engine compares against the recorded op seq of each intra op,
        # so we also need that: append it as a column.)
        intra = np.array(intra_rows, dtype=np.int64).reshape(-1, 10)
        # recorded op seqs of intra ops, in emission order:
        iseqs = [i for i, op in enumerate(self._ops) if op[0] == "intra"]
        intra_seq = np.array(iseqs, dtype=np.int64).reshape(-1)
        intra = np.concatenate([intra, intra_seq[:, None]], axis=1) \
            if len(intra) else np.zeros((0, 11), np.int64)

        return FramePlan(
            width=W, height=H, stride=S,
            mc=np.array(mc_rows, dtype=np.int64).reshape(-1, 7),
            resid=np.array(resid_rows, dtype=np.int64).reshape(-1, 4),
            resid_coef=(np.stack(resid_coefs) if resid_coefs
                        else np.zeros((0, 64), np.int32)),
            intra=intra,
            intra_coef=(np.stack(intra_coefs) if intra_coefs
                        else np.zeros((0, 64), np.int32)),
            seq_y=seq_y, seq_uv=seq_uv, n_levels=n_levels,
        )
