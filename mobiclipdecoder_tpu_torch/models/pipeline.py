"""Wavefront reconstruction engine: executes FramePlans on the card with
one kernel per GOP, on the CPU with batched torch.

Port of ``mobiclipdecoder_tpu/models/pipeline.py`` (the JAX package's
``--engine tpu-xla``), the repository's second, independent decode
implementation beside the sequential executor.  Reconstruction is phased
for parallelism (models/plan.py says why this equals the reference's
sequential macroblock loop):

  phase 1 - motion compensation: every MC leaf gathers its (half-pel
            filtered) window from the reference ring; blocks are disjoint,
            so one batched gather + scatter.
  phase 2 - inter residuals: batched integer IDCT + add-saturate scatter.
  phase 3 - intra: ops grouped into dependency levels; each level is one
            batched tap-gather -> formula-select -> residual -> scatter.
            Tap gathers mask "not yet decoded" pixels to the fresh-plane
            value via the plan's sequence map, reproducing the reference's
            read-whatever-is-there semantics bit-for-bit.

Planes live in one (H + H/2, S) int32 buffer per frame: Y on top, packed UV
(U | V halves) below, as the reference's flat planes alias.  Every
function carries a leading stream axis B.  A frame is built in a flat
(B, HH*S + 1) buffer whose last element takes the masked scatter lanes
(the JAX engine's ``mode="drop"``) and is dropped at the end.  Only that
sentinel may repeat within one scatter: MC leaves are disjoint, and so
are the ops of one level.

``decode_gop`` takes the device from the ring: on the card it is one
launch of the hand-written kernel K6 (``ops/wavefront_kernels.py``,
``csrc/wavefront.cu``) for all of a GOP's frame rounds, the JAX package's
``decode_gop_jit``; on the CPU it is ``decode_gop_plain``, a loop of the
torch code below, which is also what K6 is held against.
``decode_frame_core`` is one frame round on a ring as given (K6 with F=1
on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import wavefront_kernels
from ..ops.idct import idct4, idct8
from ..ops.intra_tables import AVG2, AVG3, COPY, DC, KIND, PASS, TAPS
from ..utils.device import check_device, indexed
from .oracle_video import MobiclipVersion
from .plan import FramePlan, PlanningDecoder


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def prepare_plan(plan: FramePlan) -> dict:
    """Pack a FramePlan into dense int32 host arrays.

    Intra ops are grouped by dependency level into ``iops`` (L, K, 11) and
    ``icoef`` (L, K, 64), K the largest level, shorter levels padded with
    size-0 rows (which write nothing).  A frame without intra ops keeps one
    empty level, as the JAX engine's does."""
    mc = _pad_rows(plan.mc.astype(np.int32), max(plan.mc.shape[0], 1))
    nr = max(plan.resid.shape[0], 1)
    resid = _pad_rows(plan.resid.astype(np.int32), nr)
    resid_coef = _pad_rows(plan.resid_coef.astype(np.int32), nr)
    L = max(plan.n_levels, 1)
    # each op's level and its slot in the level, in emission order
    lv = plan.intra[:, 9].astype(np.int64) - 1
    order = np.argsort(lv, kind="stable")
    counts = np.bincount(lv, minlength=L)
    K = max(int(counts.max(initial=0)), 1)
    slot = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    iops = np.zeros((L, K, 11), np.int32)
    icoef = np.zeros((L, K, 64), np.int32)
    iops[lv[order], slot] = plan.intra[order]
    icoef[lv[order], slot] = plan.intra_coef[order]
    seqmap = np.concatenate([plan.seq_y, plan.seq_uv], axis=0).astype(np.int32)
    return dict(mc=mc, resid=resid, resid_coef=resid_coef,
                iops=iops, icoef=icoef, seqmap=seqmap, n_levels=L)


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(flat[b], idx[b], mode="clip")`` per stream: flat (B, N),
    idx (B, ...) -> (B, ...)."""
    B = flat.shape[0]
    i = idx.reshape(B, -1).long().clamp(0, flat.shape[1] - 1)
    return torch.gather(flat, 1, i).reshape(idx.shape)


def _scatter(buf: torch.Tensor, flat: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``buf[b].at[flat[b]].set(vals[b], mode="drop")`` into the flat
    (B, HH*S + 1) buffer: lanes outside [0, HH*S) go to the sentinel."""
    B, n = buf.shape
    f = flat.reshape(B, -1).long()
    f = torch.where((f >= 0) & (f < n - 1), f, n - 1)
    return buf.scatter(1, f, vals.reshape(B, -1).to(buf.dtype))


def _grid(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    a = torch.arange(n, device=device)
    return a[:, None], a[None, :]


# --------------------------------------------------------------------- MC
def _mc_kernel(ring, buf, mc, H, S):
    """Phase 1: batched half-pel MC (CopyBlock, MobiclipDecoder.cs:418-456).
    ring (B, 6, HH, S), buf (B, HH*S + 1), mc (B, M, 7)."""
    HH = H + H // 2
    B = ring.shape[0]
    y, x, w, h, ref, dx, dy = mc.unbind(-1)              # (B, M)
    valid = w > 0
    ring_flat = ring.reshape(B, -1)
    dev = ring.device

    def e(t):
        return t[..., None, None]

    def window(ybase, xbase, refi, n):
        ii, jj = _grid(n, dev)
        rows = (e(ybase) + ii).clamp(0, HH - 1)
        cols = (e(xbase) + jj).clamp(0, S - 1)
        return _take(ring_flat, e(refi) * (HH * S) + rows * S + cols)

    def halfpel(wnd, ddx, ddy, n):
        a = wnd[..., :n, :n]
        b = wnd[..., :n, 1:n + 1]
        cc = wnd[..., 1:n + 1, :n]
        d = wnd[..., 1:n + 1, 1:n + 1]
        c1 = (a >> 1) + (b >> 1)
        c2 = (a >> 1) + (cc >> 1)
        c3 = (((a >> 1) + (b >> 1)) >> 1) + (((cc >> 1) + (d >> 1)) >> 1)
        case = e((ddx & 1) | ((ddy & 1) << 1))
        return torch.where(case == 0, a,
                           torch.where(case == 1, c1,
                                       torch.where(case == 2, c2, c3)))

    def scatter(buf, px, ybase, xbase, bw, bh, n):
        ii, jj = _grid(n, dev)
        ok = e(valid) & (ii < e(bh)) & (jj < e(bw))
        flat = torch.where(ok, (e(ybase) + ii) * S + e(xbase) + jj, HH * S)
        return _scatter(buf, flat, px)

    # luma
    wnd = window(y + (dy >> 1), x + (dx >> 1), ref, 17)
    buf = scatter(buf, halfpel(wnd, dx, dy, 16), y, x, w, h, 16)
    # chroma (U and V halves; MVs re-halved like the reference)
    cdx, cdy = dx >> 1, dy >> 1
    cy = H + (y >> 1) + (cdy >> 1)
    for xoff in (0, S // 2):
        cx = (x >> 1) + xoff + (cdx >> 1)
        pxc = halfpel(window(cy, cx, ref, 9), cdx, cdy, 8)
        buf = scatter(buf, pxc, H + (y >> 1), (x >> 1) + xoff,
                      w >> 1, h >> 1, 8)
    return buf


# ----------------------------------------------------------------- resid
def _residual8(coef, eight):
    """Residuals of (..., 64) coefficient records as (..., 8, 8) int32: the
    8x8 IDCT where the bool ``eight`` holds, else the 4x4 IDCT of the first
    16 coefficients in the top-left corner.  The JAX engine's 16x16
    residual tiles are zero outside this corner."""
    lead = coef.shape[:-1]
    r8 = idct8(coef.reshape(*lead, 8, 8))
    r4 = torch.nn.functional.pad(idct4(coef[..., :16].reshape(*lead, 4, 4)),
                                 (0, 4, 0, 4))
    return torch.where(eight[..., None, None], r8, r4)


def _tile16(r8):
    """(..., 8, 8) -> (..., 16, 16), zero outside the top-left corner."""
    return torch.nn.functional.pad(r8, (0, 8, 0, 8))


def _resid_kernel(buf, resid, coef, H, S):
    """Phase 2: add-saturate inter residuals (MinMaxTable semantics).
    buf (B, HH*S + 1), resid (B, N, 4), coef (B, N, 64)."""
    HH = H + H // 2
    pid, y, x, size = (t[..., None, None] for t in resid.unbind(-1))
    row0 = y + pid * H
    res = _tile16(_residual8(coef, size[..., 0, 0] == 8))
    ii, jj = _grid(16, buf.device)
    rows = (row0 + ii).clamp(0, HH - 1)
    cols = (x + jj).clamp(0, S - 1)
    cur = _take(buf, rows * S + cols)
    out = (cur + res).clamp(0, 255)
    ok = (size > 0) & (ii < size) & (jj < size)
    flat = torch.where(ok, (row0 + ii) * S + x + jj, HH * S)
    return _scatter(buf, flat, out)


# ----------------------------------------------------------------- intra
_TABLES: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}


def _intra_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(KIND (20, 256), TAPS (20, 256, 3)) int64 on ``device`` (cached
    per indexed device)."""
    device = indexed(device)
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(KIND).long().to(device),
                        torch.from_numpy(TAPS).long().to(device))
    return _TABLES[key]


def _plane_pred_batch(taps, size, grad):
    """Vectorized closed-form plane predictor over a level batch.

    taps: (N, 33) int32; size, grad: (N,).  Returns (N, 16, 16) int32 with
    the reference's u32 word-composition byte aliasing
    (sub_1167BC/sub_116CCC/sub_117E98, MobiclipDecoder.cs:3017-3327)."""
    t = taps[:, 1:17]
    l = taps[:, 17:33]
    N = taps.shape[0]
    idx = torch.arange(16, device=taps.device, dtype=torch.int32)
    n16 = (size == 16)[:, None]
    n4 = (size == 4)[:, None]
    nm1 = (size - 1).clamp(0, 15).long()
    tr = torch.gather(t, 1, nm1[:, None])[:, 0]
    bl = torch.gather(l, 1, nm1[:, None])[:, 0]
    r5 = ((bl + tr + 1) >> 1) + 2 * grad
    r6 = torch.where(n16[:, 0], r5 - bl + 1, r5 - bl)
    r9 = torch.where(n16[:, 0], r5 - tr + 1, r5 - tr)
    tscale = torch.where(n4, 4, 8)
    ascale = torch.where(n4, 16, 64)
    rshift = torch.where(size == 4, 5, 7)[:, None, None]
    rnd = torch.where(n4, 16, 64)[:, :1, None]
    i1 = idx[None, :] + 1
    r4_i = bl[:, None] * tscale + i1 * torch.where(n16, r6[:, None] >> 1,
                                                   r6[:, None])
    Bv = torch.where(n16, r4_i - t * 8 + 1, r4_i - t * tscale)
    r10_r = tr[:, None] * tscale + i1 * torch.where(n16, r9[:, None] >> 1,
                                                    r9[:, None])
    r7_r = torch.where(n16, r10_r - l * 8 + 1, r10_r - l * tscale)
    Bt = torch.where(n16, Bv >> 1, Bv)
    r7t = torch.where(n16, r7_r >> 1, r7_r)
    rr = idx[:, None]
    jj = idx[None, :]
    acc = (ascale[:, :1, None] * t[:, None, :]
           + (rr + 1)[None] * Bt[:, None, :]
           + ascale[:, :1, None] * l[:, :, None]
           + (jj + 1)[None] * r7t[:, :, None] + rnd)
    out = (acc >> rshift).long()
    # the int32 word's low 32 bits, composed in int64 (no shift overflows);
    # each byte read back depends on those bits only
    w0, w1, w2, w3 = (out[:, :, k::4] for k in range(4))
    word = w0 | (w1 << 8) | (w2 << 16) | (w3 << 24)
    res = torch.stack([(word >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return res.reshape(N, 16, 16).to(torch.int32)


def _intra_level_kernel(buf, seqmap, ops, res8, H, S):
    """One dependency level of intra ops, batch-vectorized: bulk flat
    gathers (tap vectors, current content, visibility cells), formula select
    via the LUTs, one masked flat scatter.

    buf (B, HH*S + 1) int32; seqmap (B, HH/4, S/4); ops (B, K, 11);
    res8 (B, K, 8, 8) the ops' residuals, ``_residual8`` of their
    coefficients (the JAX engine's level takes the coefficients and
    transforms them per level; they depend on nothing else, so
    decode_frame_core transforms every level's at once)."""
    HH = H + H // 2
    B, K = ops.shape[:2]
    dev = buf.device
    sflat = seqmap.reshape(B, -1)
    Sc = S >> 2
    pid, y, x, size, mode, grad, has_coef = (ops[..., k] for k in range(7))
    av_t, av_l = ops[..., 7], ops[..., 8]
    seq = ops[..., 10]
    row0 = y + pid * H

    # ---- 33-tap neighbor vectors: corner, t[0..15], l[0..15]
    a16 = torch.arange(16, device=dev, dtype=torch.int32)
    tap_rows = torch.cat([(row0 - 1)[..., None].expand(B, K, 17),
                          row0[..., None] + a16], dim=-1)
    tap_cols = torch.cat([(x - 1)[..., None], x[..., None] + a16,
                          (x - 1)[..., None].expand(B, K, 16)], dim=-1)
    cr = tap_rows.clamp(0, HH - 1)
    cc = tap_cols.clamp(0, S - 1)
    vals = _take(buf, cr * S + cc)
    cell = _take(sflat, (cr >> 2) * Sc + (cc >> 2))
    taps = torch.where((cell >= 0) & (cell < seq[..., None]), vals, 0)

    # ---- current block content (PASS modes / mode-9 residual base)
    ii, jj = _grid(16, dev)
    r0e, xe, se = row0[..., None, None], x[..., None, None], \
        size[..., None, None]
    rows = (r0e + ii).clamp(0, HH - 1)
    cols = (xe + jj).clamp(0, S - 1)
    cur_cell = _take(sflat, (rows >> 2) * Sc + (cols >> 2))
    cur_v = _take(buf, rows * S + cols)
    cur = torch.where((cur_cell >= 0) & (cur_cell < seq[..., None, None]),
                      cur_v, 0)

    # ---- formula modes via LUT select
    kind_t, taps_t = _intra_tables(dev)
    m = mode.long().clamp(0, kind_t.shape[0] - 1)
    kind = kind_t[m]                                       # (B, K, 256)
    tsel = taps_t[m]                                       # (B, K, 256, 3)
    a, b, c = (torch.gather(taps, 2, tsel[..., k]) for k in range(3))

    # ---- DC values
    npx = torch.where(size == 4, 4, 8)
    lane = a16
    sum_t = torch.where(lane < npx[..., None], taps[..., 1:17], 0).sum(-1)
    sum_l = torch.where(lane < npx[..., None], taps[..., 17:33], 0).sum(-1)
    log_n = torch.where(size == 4, 2, 3)
    dc_both = (sum_t + sum_l + npx) >> (log_n + 1)
    dc_top = (sum_t + (npx >> 1)) >> log_n
    dc_left = (sum_l + (npx >> 1)) >> log_n
    dc = torch.where((av_t == 1) & (av_l == 0), dc_top,
                     torch.where((av_l == 1) & (av_t == 0), dc_left,
                                 torch.where((av_t == 1) & (av_l == 1),
                                             dc_both, 0x80)))
    px = torch.where(kind == COPY, a,
                     torch.where(kind == AVG2, (a + b + 1) >> 1,
                                 torch.where(kind == AVG3,
                                             (a + 2 * b + c + 2) >> 2,
                                             torch.where(kind == DC,
                                                         dc[..., None], 0))))
    pred = px.reshape(B, K, 16, 16)
    pred = torch.where(kind.reshape(B, K, 16, 16) == PASS, cur, pred)
    is_plane = ((mode == 2) | (mode == 12))[..., None, None]
    plane = _plane_pred_batch(taps.reshape(B * K, 33), size.reshape(-1),
                              grad.reshape(-1)).reshape(B, K, 16, 16)
    pred = torch.where(is_plane, plane, pred).to(torch.int32)

    # ---- residuals (full IDCT at block size, computed by the caller)
    res = _tile16(res8)
    out = torch.where((has_coef == 1)[..., None, None],
                      (pred + res).clamp(0, 255), pred)

    # ---- masked scatter
    ok = (se > 0) & (ii < se) & (jj < se)
    flat = torch.where(ok, (r0e + ii) * S + xe + jj, HH * S)
    return _scatter(buf, flat, out)


def decode_frame_core_plain(ring, mc, resid, resid_coef, iops, icoef,
                            seqmap, n_levels, H: int, S: int):
    """The plain torch version of ``decode_frame_core`` (the CPU's path,
    and the reference K6 is held against on the card): one torch op
    sequence per phase and per intra level."""
    HH = H + H // 2
    B = ring.shape[0]
    buf = torch.zeros((B, HH * S + 1), dtype=torch.int32, device=ring.device)
    buf = _mc_kernel(ring, buf, mc, H, S)
    buf = _resid_kernel(buf, resid, resid_coef, H, S)
    if isinstance(n_levels, torch.Tensor):
        n_levels = n_levels.cpu().numpy()
    L = min(int(np.max(n_levels)), iops.shape[1])
    res8 = _residual8(icoef[:, :L], iops[:, :L, :, 3] != 4)
    for lv in range(L):
        buf = _intra_level_kernel(buf, seqmap, iops[:, lv], res8[:, lv],
                                  H, S)
    return buf[:, :HH * S].reshape(B, HH, S)


def decode_frame_core(ring, mc, resid, resid_coef, iops, icoef, seqmap,
                      n_levels, H: int, S: int):
    """One frame of B streams: ring (B, 6, HH, S) int32 (slot 0 stale, slot
    r the frame r back), plan tensors with a leading B on the ring's
    device, ``n_levels`` the count of levels to run, on the host (an int or
    (B,) array) or a (B,) int32 tensor on the ring's device (levels past a
    stream's own are size-0 padding).  Returns (B, HH, S) int32.

    On CUDA tensors one launch of K6 (``ops/wavefront_kernels.py``), which
    runs each stream's own levels; on CPU tensors the plain torch
    ``decode_frame_core_plain``; any other device raises."""
    if ring.device.type == "cpu":
        return decode_frame_core_plain(ring, mc, resid, resid_coef, iops,
                                       icoef, seqmap, n_levels, H, S)
    if not isinstance(n_levels, torch.Tensor):
        n_levels = torch.from_numpy(np.array(np.broadcast_to(
            np.asarray(n_levels, np.int32), (ring.shape[0],)))).to(
                ring.device)
    return wavefront_kernels.wavefront_frame(
        ring, mc, resid, resid_coef, iops, icoef, seqmap, n_levels, H, S)


def decode_gop_plain(ring, head: int, rounds: list[dict], H: int, S: int):
    """The plain torch version of ``decode_gop``: each round on the ring in
    logical order (``torch.roll``) through ``decode_frame_core_plain``,
    its frame written into its physical slot."""
    outs = []
    for f, t in enumerate(rounds):
        hd = (head + 5 * (f + 1)) % 6
        buf = decode_frame_core_plain(
            torch.roll(ring, -hd, dims=1), t["mc"], t["resid"],
            t["resid_coef"], t["iops"], t["icoef"], t["seqmap"],
            t["n_levels"], H, S)
        ring[:, hd] = buf
        outs.append(buf.to(torch.uint8))
    return torch.stack(outs)


def decode_gop(ring, head: int, plans: wavefront_kernels.GopPlans, H: int,
               S: int) -> torch.Tensor:
    """A GOP of B streams: ring (B, 6, HH, S) int32 in physical slots,
    ``head`` the physical slot of its logical slot 0 (the last frame),
    ``plans`` the rounds uploaded to the ring's device
    (``wavefront_kernels.upload_gop``).  Round f's frame goes to physical
    slot (head + 5 (f + 1)) mod 6; the ring is updated in place.  Returns
    the frames (F, B, HH, S) uint8 on the ring's device.

    On a CUDA ring one launch of K6; on a CPU ring the plain
    ``decode_gop_plain``; any other device raises."""
    if ring.device.type == "cpu":
        return decode_gop_plain(ring, head, plans.rounds, H, S)
    return wavefront_kernels.wavefront_gop(ring, head, plans, H, S)


def upload_plan(arrays: dict, device) -> dict:
    """prepare_plan()/stack_plans() host arrays -> int32 tensors on
    ``device`` (``n_levels`` stays on the host)."""
    return {k: (v if k == "n_levels" else
                torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device))
            for k, v in arrays.items()}


class WavefrontVideoDecoder:
    """Video decoder on the wavefront engine: host scanner -> device
    reconstruction (the JAX package's ``JaxVideoDecoder``).

    Bit-exact with the oracle on YUV planes.  The sequential entropy scan
    runs on the host; reconstruction runs on ``device`` (required; a CUDA
    device that is not there raises)."""

    def __init__(self, width: int, height: int, version: MobiclipVersion,
                 *, device, native: bool | None = None):
        """``native`` selects the C++ scanner (default: use it if it
        builds; plans are bit-identical either way)."""
        self.device = check_device(device)
        self.planner = PlanningDecoder(width, height, version)
        self.native = None
        if native is not False:
            try:
                from ..utils.native import NativePlanner
                self.native = NativePlanner(width, height, int(version))
            except (OSError, AttributeError, RuntimeError):
                if native is True:
                    raise
        self.width, self.height = width, height
        self.stride = self.planner.stride
        HH = height + height // 2
        # physical slots; logical slot 0 (the last frame) is slot head
        self.rings = torch.zeros((1, 6, HH, self.stride), dtype=torch.int32,
                                 device=self.device)
        self.head = 0

    @property
    def ring(self) -> torch.Tensor:
        """The (6, HH, S) int32 ring in logical order (slot r the frame r
        back)."""
        return torch.roll(self.rings[0], -self.head, dims=0)

    @property
    def offset(self):
        return (self.native.offset if self.native is not None
                else self.planner.offset)

    def scan(self, packet: bytes) -> FramePlan:
        if self.native is not None:
            return self.native.scan(packet)
        self.planner.data = packet
        self.planner.offset = 0
        self.planner.decode_frame()
        return self.planner.plan()

    def decode_frame(self, packet: bytes) -> tuple[np.ndarray, np.ndarray]:
        """Decode one frame packet; returns (Y, UV) uint8 numpy planes of
        shapes (H, S) and (H/2, S)."""
        arrays = prepare_plan(self.scan(packet))
        plans = wavefront_kernels.upload_gop(
            [{k: np.asarray(v)[None] for k, v in arrays.items()}],
            self.device)
        H = self.height
        out = decode_gop(self.rings, self.head, plans, H, self.stride)
        self.head = (self.head + 5) % 6
        out = out[0, 0].cpu().numpy()
        return out[:H], out[H:]
