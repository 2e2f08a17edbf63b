"""Wrapper of the wavefront engine's kernel (csrc/wavefront.cu).

The JAX package decodes a GOP on its wavefront engine as one XLA program
(``decode_gop_jit`` in ``mobiclipdecoder_tpu/parallel/batch.py``, a
``lax.scan`` over frame rounds of ``decode_frame_core``); the port runs it
as one hand-written CUDA kernel, built with nvcc at first use:

* K6 ``wavefront_gop``: F frame rounds of B streams in one launch, each
  stream on a thread-block cluster of ``CLUSTER`` blocks: per round MC from
  the ring, the inter residuals, the stream's own intra levels (on the
  cluster's first block, each level staged in shared memory), then the
  frame into its ring slot and the uint8 output.  The ring keeps physical
  slots; ``head`` names the physical slot of its logical slot 0.

The rounds' operands are the views of one upload (``upload_gop``): a
descriptor table of their addresses and sizes, then the arrays.
``wavefront_frame`` is K6 with F=1 on separate tensors that leaves the
ring alone and returns the int32 frame (``decode_frame_core``'s contract).
Both take CUDA tensors only, launch on the current stream of the tensors'
device, and raise if the launch is refused; ``wavefront_launches`` counts
the launches.  The functions that pick the plain version for CPU tensors
are ``models/pipeline.py`` ``decode_gop`` and ``decode_frame_core``.

``wavefront_gop_host`` and ``wavefront_frame_host`` run the kernel's code
(csrc/wavefront_ops.cuh, K6's phases) built for the host with g++; they
exist for the CPU tests only.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import build
from ..utils.device import launch, on_one_card
from .intra_tables import KIND, TAPS

wavefront_launches = 0

# blocks of a stream's cluster (chip_smoke.py [wavefront] sweeps 1, 2, 4
# and 8 on the card and this is the fastest)
CLUSTER = 8

# a round's operands, in the order of its descriptor's addresses
KEYS = ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap", "n_levels")
DESC = 12       # int64 words of a round's descriptor: 7 addresses, M N L K SR
STAGE = 64 * 256    # a level's pixels K6 stages in shared memory
                    # (MOBI_WF_STAGE); the rest go to the overflow scratch

_lib = None
_host_lib = None
_TABLES: dict[str, torch.Tensor] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# ring, desc, [desc_host,] tables, fa, fb, ires, ires_stride, klev, lmax,
# ovf, ovf_stride, out8, out32, B, H, S, F, head, commit, C
_TAIL = [_P] * 4 + [_L, _P, _I, _P, _L, _P, _P, _L] + [_I] * 6

# KIND (20, 256) then TAPS (20, 256, 3), as K6 reads them
TABLES = np.concatenate([KIND.ravel(), TAPS.ravel()]).astype(np.uint8)


def _load():
    global _lib
    if _lib is None:
        lib = build.load("wavefront", ["wavefront.cu"], "nvcc")
        lib.mobi_wavefront_gop_launch.restype = _I
        lib.mobi_wavefront_gop_launch.argtypes = ([_P, _P, _P] + _TAIL
                                                  + [_I, _P])
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("wavefront_host", ["wavefront_host.cpp"], "g++",
                         "host")
        lib.mobi_wavefront_gop_host.restype = _I
        lib.mobi_wavefront_gop_host.argtypes = [_P, _P] + _TAIL
        _host_lib = lib
    return _host_lib


def _round_sizes(t: dict, B: int, H: int, S: int) -> tuple[int, ...]:
    """(M, N, L, K, SR) of one round's operands, or ValueError unless mc
    (B, M, 7), resid (B, N, 4), resid_coef (B, N, 64), iops (B, L, K, 11),
    icoef (B, L, K, 64), seqmap (B, SR, S / 4) and n_levels (B,)."""
    M = t["mc"].shape[1] if t["mc"].ndim == 3 else 0
    N = t["resid"].shape[1] if t["resid"].ndim == 3 else 0
    L, K = (t["iops"].shape[1:3] if t["iops"].ndim == 4 else (0, 0))
    SR = t["seqmap"].shape[1] if t["seqmap"].ndim == 3 else 0
    want = {"mc": (B, M, 7), "resid": (B, N, 4), "resid_coef": (B, N, 64),
            "iops": (B, L, K, 11), "icoef": (B, L, K, 64),
            "seqmap": (B, SR, S // 4), "n_levels": (B,)}
    bad = [k for k in KEYS if tuple(t[k].shape) != want[k]]
    if bad or min(B, M, N, L, K, SR) < 1 or S % 4 or H < 2:
        raise ValueError(
            "K6 operands: " + ", ".join(f"{k} {tuple(t[k].shape)}"
                                         for k in KEYS)
            + f", B={B}, H={H}, S={S}: expected ring (B, 6, H + H/2, S), mc "
            f"(B, M, 7), resid (B, N, 4), resid_coef (B, N, 64), iops (B, L, "
            f"K, 11), icoef (B, L, K, 64), seqmap (B, SR, S / 4), n_levels "
            f"(B,), every count at least 1")
    return M, N, L, K, SR


def _check_ring(ring, rounds: list[dict], H: int, S: int) -> int:
    """B, or ValueError unless ring (B, 6, H + H/2, S) and every round's
    arrays as ``_round_sizes`` takes them."""
    B = ring.shape[0] if ring.ndim == 4 else 0
    if tuple(ring.shape) != (B, 6, H + H // 2, S) or B < 1:
        raise ValueError(f"K6 operands: ring {tuple(ring.shape)}, H={H}, "
                         f"S={S}: expected ring (B, 6, H + H/2, S)")
    for t in rounds:
        _round_sizes(t, B, H, S)
    return B


def frame_sizes(ring, mc, resid, resid_coef, iops, icoef, seqmap, n_levels,
                H: int, S: int) -> tuple[int, ...]:
    """(B, M, N, L, K, SR) of one frame round's operands, or ValueError
    unless ring (B, 6, H + H/2, S) and the round's arrays as
    ``_round_sizes`` takes them."""
    t = dict(zip(KEYS, (mc, resid, resid_coef, iops, icoef, seqmap,
                        n_levels)))
    B = _check_ring(ring, [t], H, S)
    return (B, *_round_sizes(t, B, H, S))


@dataclass
class GopPlans:
    """A GOP's frame rounds on one device: ``rounds`` per round a dict of
    int32 tensors (KEYS), ``desc`` the (F, DESC) int64 descriptor table of
    their addresses and sizes on the host, ``desc_dev`` the same on the
    device (None on the CPU)."""
    rounds: list[dict]
    desc: np.ndarray
    desc_dev: torch.Tensor | None

    @property
    def F(self) -> int:
        return len(self.rounds)


def _desc(rounds: list[dict], addr) -> np.ndarray:
    """The descriptor table of rounds whose array ``k`` of round f lies at
    ``addr(f, k)``."""
    desc = np.zeros((len(rounds), DESC), np.int64)
    for f, t in enumerate(rounds):
        desc[f, :7] = [addr(f, k) for k in KEYS]
        desc[f, 7:] = (t["mc"].shape[1], t["resid"].shape[1],
                       *t["iops"].shape[1:3], t["seqmap"].shape[1])
    return desc


def upload_gop(rounds: list[dict], device) -> GopPlans:
    """Host arrays of a GOP's frame rounds (BatchVideoDecoder.scan_packets()
    outputs: KEYS, each with the stream axis first) -> GopPlans on
    ``device``: one upload of the descriptor table and every array."""
    dev = torch.device(device)
    F = len(rounds)
    lay, off = [], F * DESC * 2
    for t in rounds:
        lay.append({})
        for k in KEYS:
            a = np.ascontiguousarray(t[k], np.int32)
            lay[-1][k] = (off, a)
            off += -(-a.size // 4) * 4          # 16-byte aligned
    host = np.zeros(off, np.int32)
    blob = (torch.from_numpy(host) if dev.type == "cpu" else
            torch.empty(off, dtype=torch.int32, device=dev))
    for r in lay:
        for o, a in r.values():
            host[o:o + a.size] = a.ravel()
    base = blob.data_ptr()
    desc = _desc(rounds, lambda f, k: base + 4 * lay[f][k][0])
    host[:F * DESC * 2] = desc.view(np.int32).ravel()
    if dev.type != "cpu":
        blob.copy_(torch.from_numpy(host))
    views = [{k: blob[o:o + a.size].view(a.shape) for k, (o, a) in r.items()}
             for r in lay]
    desc_dev = (None if dev.type == "cpu"
                else blob[:F * DESC * 2].view(torch.int64).view(F, DESC))
    return GopPlans(views, desc, desc_dev)


def _tables(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(TABLES).to(dev)
    return _TABLES[key]


def _scratch_sizes(desc: np.ndarray) -> tuple[int, int, int]:
    """(lmax, ires_stride, ovf_stride): the largest L and L * K * 64 of the
    rounds, and the pixels a level may stage past STAGE (at least 1)."""
    L, K = desc[:, 9], desc[:, 10]
    return (int(L.max()), int((L * K).max()) * 64,
            max(int(K.max()) * 256 - STAGE, 1))


def _run(ring, head: int, desc_dev, desc: np.ndarray, H: int, S: int, *,
         commit: bool, out8: bool, out32: bool):
    """One launch of K6 over the rounds of ``desc``; (out8, out32), each
    (F, B, HH, S) or None."""
    global wavefront_launches
    dev = on_one_card(ring=ring)
    B, F, HH = ring.shape[0], desc.shape[0], H + H // 2
    lmax, stride, ovf = _scratch_sizes(desc)
    lib = _load()
    fa = torch.empty((B, HH, S), dtype=torch.int32, device=dev)
    fb = torch.empty_like(fa)
    ires = torch.empty((B, stride), dtype=torch.int32, device=dev)
    klev = torch.empty((B, lmax), dtype=torch.int32, device=dev)
    spill = torch.empty((B, 2 * ovf), dtype=torch.int32, device=dev)
    o8 = (torch.empty((F, B, HH, S), dtype=torch.uint8, device=dev)
          if out8 else None)
    o32 = (torch.empty((F, B, HH, S), dtype=torch.int32, device=dev)
           if out32 else None)
    launch(lib.mobi_wavefront_gop_launch, dev, ring.data_ptr(),
           desc_dev.data_ptr(), desc.ctypes.data, _tables(dev).data_ptr(),
           fa.data_ptr(), fb.data_ptr(), ires.data_ptr(), stride,
           klev.data_ptr(), lmax, spill.data_ptr(), ovf,
           0 if o8 is None else o8.data_ptr(),
           0 if o32 is None else o32.data_ptr(), B, H, S, F, head,
           int(commit), CLUSTER)
    wavefront_launches += 1
    return o8, o32


def wavefront_gop(ring: torch.Tensor, head: int, plans: GopPlans, H: int,
                  S: int, frames32: bool = False):
    """K6: the F rounds of ``plans`` (upload_gop() on the ring's card) for
    the B streams of ``ring`` (B, 6, H + H/2, S) int32, physical slots,
    ``head`` its logical slot 0's physical slot: round f's frame goes to
    physical slot (head + 5 (f + 1)) mod 6.  Returns the frames (F, B, HH,
    S) uint8 on the card, and with ``frames32`` the same as int32 beside
    them; the ring is updated in place."""
    _check_ring(ring, plans.rounds, H, S)
    where = None if plans.desc_dev is None else plans.desc_dev.device
    if where != ring.device:
        raise ValueError(f"K6: the plans are on {where}, the ring on "
                         f"{ring.device}")
    o8, o32 = _run(ring, head, plans.desc_dev, plans.desc, H, S,
                   commit=True, out8=True, out32=frames32)
    return (o8, o32) if frames32 else o8


def wavefront_frame(ring: torch.Tensor, mc: torch.Tensor,
                    resid: torch.Tensor, resid_coef: torch.Tensor,
                    iops: torch.Tensor, icoef: torch.Tensor,
                    seqmap: torch.Tensor, n_levels: torch.Tensor,
                    H: int, S: int) -> torch.Tensor:
    """K6 with F=1 on separate tensors: one frame round of B streams ->
    (B, H + H/2, S) int32 on the tensors' card.  Operands as
    ``decode_frame_core``'s (ring slot 0 stale, slot r the frame r back),
    every one a contiguous int32 CUDA tensor on one device, ``n_levels``
    (B,) too: stream b runs levels 0 to min(n_levels[b], L) - 1.  The ring
    is left alone."""
    tensors = dict(ring=ring, mc=mc, resid=resid, resid_coef=resid_coef,
                   iops=iops, icoef=icoef, seqmap=seqmap, n_levels=n_levels)
    dev = on_one_card(**tensors)
    frame_sizes(*tensors.values(), H, S)
    desc = _desc([tensors], lambda f, k: tensors[k].data_ptr())
    # head 1: the round's physical slot 0 is slot 0, the ring as given
    return _run(ring, 1, torch.from_numpy(desc).to(dev), desc, H, S,
                commit=False, out8=False, out32=True)[1][0]


def wavefront_gop_host(ring, head: int, rounds: list[dict], H: int, S: int,
                       clusters: int = CLUSTER):
    """K6's code on the host (g++ build), the cluster's ``clusters`` blocks
    taken in turn: numpy ring (B, 6, HH, S) as ``wavefront_gop``'s and
    rounds of numpy arrays (KEYS) -> (frames (F, B, HH, S) uint8, frames
    int32, the ring after the GOP)."""
    ring = np.array(ring, np.int32, order="C")
    arrs = [{k: np.ascontiguousarray(np.asarray(t[k]), np.int32)
             for k in KEYS} for t in rounds]
    _check_ring(ring, arrs, H, S)
    desc = _desc(arrs, lambda f, k: arrs[f][k].ctypes.data)
    return _run_host(ring, head, desc, H, S, clusters, commit=True) + (ring,)


def _run_host(ring, head, desc, H, S, clusters, commit):
    """K6's host build over the rounds of ``desc`` (host addresses); (out8,
    out32), each (F, B, HH, S)."""
    F, B, HH = desc.shape[0], ring.shape[0], H + H // 2
    lmax, stride, ovf = _scratch_sizes(desc)
    fa = np.empty((B, HH, S), np.int32)
    fb = np.empty_like(fa)
    ires = np.empty((B, stride), np.int32)
    klev = np.empty((B, lmax), np.int32)
    spill = np.empty((B, 2 * ovf), np.int32)
    o8 = np.empty((F, B, HH, S), np.uint8)
    o32 = np.empty((F, B, HH, S), np.int32)
    rc = _load_host().mobi_wavefront_gop_host(
        ring.ctypes.data, desc.ctypes.data, TABLES.ctypes.data,
        fa.ctypes.data, fb.ctypes.data, ires.ctypes.data, stride,
        klev.ctypes.data, lmax, spill.ctypes.data, ovf, o8.ctypes.data,
        o32.ctypes.data, B, H, S, F, head, int(commit), clusters)
    if rc != 0:
        raise ValueError(f"K6 refuses B={B}, H={H}, S={S}, F={F}, "
                         f"head={head}, C={clusters}, rounds "
                         f"{desc[:, 7:].tolist()}")
    return o8, o32


def wavefront_frame_host(ring, mc, resid, resid_coef, iops, icoef, seqmap,
                         n_levels, H: int, S: int,
                         clusters: int = CLUSTER) -> np.ndarray:
    """K6's code on the host with F=1 (g++ build): numpy operands as
    ``wavefront_frame``'s -> (B, H + H/2, S) int32; the ring is left
    alone."""
    arrs = [np.ascontiguousarray(np.asarray(a), np.int32)
            for a in (ring, mc, resid, resid_coef, iops, icoef, seqmap,
                      n_levels)]
    frame_sizes(*arrs, H, S)
    t = dict(zip(KEYS, arrs[1:]))
    desc = _desc([t], lambda f, k: t[k].ctypes.data)
    return _run_host(arrs[0], 1, desc, H, S, clusters, commit=False)[1][0]
