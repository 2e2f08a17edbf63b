"""Plain PyTorch version of the whole-GOP executor (the CUDA kernel in
csrc/gop_executor.cu, wrapped by ops/executor.py).

Same inputs and outputs as the kernel: it walks each stream's op chunks and
the ops inside them strictly in decode order, reading the reference ring
and writing each frame's working plane (``frames[f, b]``), and commits each
finished frame to ring slot ``(5 - f) mod 6``.  The semantics are those of
the Pallas kernel body ``_make_kernel`` in
``mobiclipdecoder_tpu/ops/vmem_engine.py``; the op encoding is
``models/plan.py pack_unified``.  Every value is an exact integer.

The executor wrapper uses this for tensors on the CPU; the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import torch

from .intra_tables import AVG2, AVG3
from .packing import CHUNK, MCOL, MR, _geom



def _halfpel(w: torch.Tensor, n: int, dx: int, dy: int) -> torch.Tensor:
    """CopyBlock's 4 filter cases on an (n+1, n+1) window (truncating >> 1
    on each operand)."""
    a = w[:n, :n]
    cs = (dx & 1) | ((dy & 1) << 1)
    if cs == 0:
        return a
    b = w[:n, 1:n + 1]
    c = w[1:n + 1, :n]
    if cs == 1:
        return (a >> 1) + (b >> 1)
    if cs == 2:
        return (a >> 1) + (c >> 1)
    d = w[1:n + 1, 1:n + 1]
    return (((a >> 1) + (b >> 1)) >> 1) + (((c >> 1) + (d >> 1)) >> 1)


def _row8(rz: torch.Tensor, row: int) -> torch.Tensor:
    """Residual row ``row`` of the chunk as (8, 8); clamped into the chunk
    (a chunk may close with w3 + n == CHUNK)."""
    return rz[min(row, CHUNK - 1)].view(8, 8)


def _res16(rz: torch.Tensor, w3: int, mask: int) -> torch.Tensor:
    """Masked 16x16 residual: quad q (8x8 at (8*(q>>1), 8*(q&1))) takes the
    next consecutive row when mask bit q is set, else adds 0."""
    res = torch.zeros((16, 16), dtype=torch.int32, device=rz.device)
    ri = w3
    for q in range(4):
        if (mask >> q) & 1:
            r0, c0 = 8 * (q >> 1), 8 * (q & 1)
            res[r0:r0 + 8, c0:c0 + 8] = _row8(rz, ri)
            ri += 1
    return res


class _Stream:
    """One stream's view of the executor's state for one GOP, on the
    ring's device."""

    def __init__(self, ring_b, tabs, H, S):
        self.ring = ring_b                       # (6, R, SP) uint8
        self.ar = torch.arange(48, device=ring_b.device)
        self.i16 = self.ar[:16].view(16, 1)
        self.j16 = self.ar[:16].view(1, 16)
        self.kind = tabs[..., 0].long()          # (20, 256)
        self.taps = tabs[..., 1:].long()         # (20, 256, 3)
        self.H, self.S = H, S
        _hh, self.G8, self.SP = _geom(H, S)
        self.R = self.G8 * 8

    # -------------------------------------------------------------- taps
    def taps48(self, plane, r: int, c: int) -> torch.Tensor:
        """[corner, t[0..30], l[0..15]] of a block at (r, c): the row above
        from column c - 1, and the column left of the block."""
        top = plane[r - 1, (c - 1 + self.ar[:32]) % self.SP]
        left = plane[r:r + 16, (c - 1) % self.SP]
        return torch.cat([top, left]).to(torch.int32)

    def pred_dir(self, tp, mode: int, npx: int, logn: int, avt: int,
                 avl: int) -> torch.Tensor:
        """(16, 16) directional or DC prediction (ops/intra_tables.py)."""
        if mode in (3, 13):
            st = int(tp[1:1 + npx].sum())
            sl = int(tp[32:32 + npx].sum())
            if avt and avl:
                dc = (st + sl + npx) >> (logn + 1)
            elif avt:
                dc = (st + (npx >> 1)) >> logn
            elif avl:
                dc = (sl + (npx >> 1)) >> logn
            else:
                dc = 0x80
            return torch.full((16, 16), dc, dtype=torch.int32,
                              device=tp.device)
        v = torch.cat([tp[:17], tp[32:48]])      # 33-entry tap vector
        tps = self.taps[mode]
        a, b, c = v[tps[:, 0]], v[tps[:, 1]], v[tps[:, 2]]
        k = self.kind[mode]
        p = torch.where(k == AVG2, (a + b + 1) >> 1,
                        torch.where(k == AVG3, (a + 2 * b + c + 2) >> 2, a))
        return p.view(16, 16)

    def pred_plane(self, tp, size: int, grad: int) -> torch.Tensor:
        """(16, 16) plane prediction (modes 2/12, plane16): the closed
        form, then the reference's u32 word composition, whose | lets an
        out-of-range value bleed into the neighbouring bytes."""
        t16 = tp[1:17].view(1, 16)
        l16 = tp[32:48].view(16, 1)
        n16 = int(size == 16)
        tr = int(tp[size])
        bl = int(tp[32 + size - 1])
        r5 = ((bl + tr + 1) >> 1) + 2 * grad
        r6 = r5 - bl + n16
        r9 = r5 - tr + n16
        tsc, asc, rsh = (4, 16, 5) if size == 4 else (8, 64, 7)
        i16, j16 = self.i16, self.j16
        r4i = bl * tsc + (j16 + 1) * ((r6 >> 1) if n16 else r6)
        bi = r4i - t16 * 8 + 1 if n16 else r4i - t16 * tsc
        bt = bi >> 1 if n16 else bi
        r10 = tr * tsc + (i16 + 1) * ((r9 >> 1) if n16 else r9)
        r7 = r10 - l16 * 8 + 1 if n16 else r10 - l16 * tsc
        r7t = r7 >> 1 if n16 else r7
        pout = (asc * t16 + (i16 + 1) * bt + asc * l16 + (j16 + 1) * r7t
                + asc) >> rsh
        p = pout.to(torch.int64).view(16, 4, 4)
        m32 = 0xFFFFFFFF
        word = ((p[..., 0] & m32) | ((p[..., 1] << 8) & m32)
                | ((p[..., 2] << 16) & m32) | ((p[..., 3] << 24) & m32))
        byte = (word[..., None] >> (8 * self.ar[:4])) & 0xFF
        return byte.view(16, 16).to(torch.int32)

    # ---------------------------------------------------------------- ops
    def mc(self, plane, rz, fm, w0, w1, w2, w3):
        H, S, G8, SP = self.H, self.S, self.G8, self.SP
        rr, cc = w1 & 0xFFFF, w1 >> 16
        bw, bh, ref = (w0 >> 16) & 0x1F, (w0 >> 21) & 0x1F, (w0 >> 13) & 7
        rmask = (w0 >> 3) & 0x3F
        dx = ((w2 & 0xFFFF) ^ 0x8000) - 0x8000
        dy = w2 >> 16
        src = self.ring[(5 - fm + ref) % 6]
        # luma: 24-row window at a clamped row group, rows rolled within
        # it, columns modulo SP
        yb, xb = rr + (dy >> 1), cc + (dx >> 1)
        gl = min(max(yb >> 3, 0), G8 - 3)
        rows = gl * 8 + (self.ar[:17] + (yb & 7)) % 24
        cols = (self.ar[:17] + xb) % SP
        win = src[rows[:, None], cols[None, :]].to(torch.int32)
        px = _halfpel(win, 16, dx, dy)
        if rmask & 0xF:
            px = (px + _res16(rz, w3, rmask & 0xF)).clamp(0, 255)
        plane[rr:rr + bh, cc:cc + bw] = px[:bh, :bw].to(torch.uint8)
        # chroma: U | V halves of the packed plane, MVs halved again
        cdx, cdy = dx >> 1, dy >> 1
        cy = MR + H + ((rr - MR) >> 1)
        ccu = MCOL + ((cc - MCOL) >> 1)
        cyb = cy + (cdy >> 1)
        gc = min(max(cyb >> 3, 0), G8 - 2)
        crows = gc * 8 + (self.ar[:9] + (cyb & 7)) % 16
        xu = ccu + (cdx >> 1)
        nl = w3 + bin(rmask & 0xF).count("1")
        bu, bv = (rmask >> 4) & 1, (rmask >> 5) & 1
        ch, cw = bh >> 1, bw >> 1
        for half in (0, 1):
            off = S // 2 if half else 0
            ccols = (self.ar[:9] + xu + off) % SP
            win = src[crows[:, None], ccols[None, :]].to(torch.int32)
            px = _halfpel(win, 8, cdx, cdy)
            if rmask >> 4:
                if bv if half else bu:
                    px = px + _row8(rz, nl + bu if half else nl)
                px = px.clamp(0, 255)
            plane[cy:cy + ch, ccu + off:ccu + off + cw] = \
                px[:ch, :cw].to(torch.uint8)

    def resid(self, plane, rz, w0, w1, w3):
        rr, cc = w1 & 0xFFFF, w1 >> 16
        sl = (w0 >> 2) & 7
        if sl < 4:
            n = 1 << sl
            cur = plane[rr:rr + n, cc:cc + n].to(torch.int32)
            out = (cur + _row8(rz, w3)[:n, :n]).clamp(0, 255)
            plane[rr:rr + n, cc:cc + n] = out.to(torch.uint8)
        elif sl == 4:
            cur = plane[rr:rr + 16, cc:cc + 16].to(torch.int32)
            out = (cur + _res16(rz, w3, (w0 >> 5) & 0xF)).clamp(0, 255)
            plane[rr:rr + 16, cc:cc + 16] = out.to(torch.uint8)
        elif sl == 5:
            bu, bv = (w0 >> 5) & 1, (w0 >> 6) & 1
            for half, bit, row in ((0, bu, w3), (1, bv, w3 + bu)):
                c = cc + (self.S // 2 if half else 0)
                cur = plane[rr:rr + 8, c:c + 8].to(torch.int32)
                if bit:
                    cur = cur + _row8(rz, row)
                plane[rr:rr + 8, c:c + 8] = cur.clamp(0, 255).to(torch.uint8)

    def intra(self, plane, rz, w0, w1, w2, w3):
        rr, cc = w1 & 0xFFFF, w1 >> 16
        isl = (w0 >> 2) & 7
        if isl in (5, 6):
            # luma quad batch: sub-blocks in q order, each reading what its
            # predecessors just wrote
            ssz = 4 if isl == 5 else 8
            hbits = (w0 >> 21) & 0xF
            ri = w3
            for q in range(4):
                ro, co = ssz * (q >> 1), ssz * (q & 1)
                nib = (w0 >> (5 + 4 * q)) & 0xF
                hasq = (hbits >> q) & 1
                if nib != 0xF:
                    tp = self.taps48(plane, rr + ro, cc + co)
                    mode = min(nib + (10 if ssz == 4 else 0), 19)
                    avt = (w2 & 1) if q < 2 else 1
                    avl = ((w2 >> 1) & 1) if (q & 1) == 0 else 1
                    p = self.pred_dir(tp, mode, ssz, 2 if ssz == 4 else 3,
                                      avt, avl)[:ssz, :ssz]
                    if hasq:
                        p = (p + _row8(rz, ri)[:ssz, :ssz]).clamp(0, 255)
                    plane[rr + ro:rr + ro + ssz, cc + co:cc + co + ssz] = \
                        p.to(torch.uint8)
                ri += hasq
        elif isl == 7:
            # chroma U+V pair: both from taps read before either write
            S = self.S
            mode = min((w0 >> 5) & 0x1F, 19)
            hasu, hasv = (w0 >> 10) & 1, (w0 >> 11) & 1
            avt, avl = int(rr != MR + self.H), int(cc != MCOL)
            tps = [self.taps48(plane, rr, cc + off) for off in (0, S // 2)]
            for half, (tp, has, row) in enumerate(
                    ((tps[0], hasu, w3), (tps[1], hasv, w3 + hasu))):
                p = self.pred_dir(tp, mode, 8, 3, avt, avl)[:8, :8]
                if has:
                    p = (p + _row8(rz, row)).clamp(0, 255)
                c = cc + (S // 2 if half else 0)
                plane[rr:rr + 8, c:c + 8] = p.to(torch.uint8)
        else:
            n = 1 << isl
            mode = min((w0 >> 5) & 0x1F, 19)
            has, avt, avl = (w0 >> 10) & 1, (w0 >> 11) & 1, (w0 >> 12) & 1
            tp = self.taps48(plane, rr, cc)
            if mode in (2, 12):
                p = self.pred_plane(tp, n, w2)
            else:
                p = self.pred_dir(tp, mode, 4 if n == 4 else 8,
                                  2 if n == 4 else 3, avt, avl)
            if has:
                res = torch.zeros((16, 16), dtype=torch.int32,
                                  device=rz.device)
                res[:8, :8] = _row8(rz, w3)
                p = (p + res).clamp(0, 255)
            plane[rr:rr + n, cc:cc + n] = p[:n, :n].to(torch.uint8)


def run_gop_ref(ops: torch.Tensor, resid: torch.Tensor, ring: torch.Tensor,
                frames: torch.Tensor, tabs: torch.Tensor, H: int,
                S: int) -> None:
    """Execute a packed GOP in place.

    ops (B, nct, CHUNK, 4) int32; resid (B, nct, CHUNK, 64) int32 spatial
    residual rows; ring (B, 6, R, SP) uint8, updated; frames (F, B, R, SP)
    uint8, written; tabs (20, 256, 4) uint8 (state.kernel_tables)."""
    B, nct = ops.shape[:2]
    F = frames.shape[0]
    for b in range(B):
        st = _Stream(ring[b], tabs, H, S)
        ops_b = ops[b].tolist()
        for c in range(nct):
            ck = ops_b[c]
            count, fid, first, last = ck[0]
            if not 0 <= fid < F:
                continue
            fm = fid % 6
            plane = frames[fid, b]
            if first:
                plane.zero_()
            rz = resid[b, c]
            for w0, w1, w2, w3 in ck[1:1 + min(count, CHUNK - 1)]:
                typ = w0 & 3
                if typ == 1:
                    st.mc(plane, rz, fm, w0, w1, w2, w3)
                elif typ == 2:
                    st.resid(plane, rz, w0, w1, w3)
                elif typ == 3:
                    st.intra(plane, rz, w0, w1, w2, w3)
            if last:
                st.ring[5 - fm].copy_(plane)
