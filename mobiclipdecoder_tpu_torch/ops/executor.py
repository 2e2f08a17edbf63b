"""Wrapper of the whole-GOP executor kernel (csrc/gop_executor.cu).

``run_gop`` executes a packed GOP: for CUDA tensors it launches the
hand-written kernel on the current stream (building it with nvcc at first
use) or raises; for CPU tensors it runs the plain PyTorch version,
ops/executor_ref.py.  It serves every stride the codec has (256, 512 and
1024: DS, 3DS and Wii frame widths).  ``launches`` counts the kernel's
whole-GOP launches (F > 1, the JAX package's ``_build_gop_executor``);
``frame_launches`` counts its single-frame launches (F == 1, the form
that ``_build_executor`` computes there).

The kernel keeps the frame being decoded in shared memory where the block
fits the card's 227 KB (``plane_in_smem``: 256x192 and 400x240) and in
global memory otherwise (640x480); ``smem_plane_launches`` and
``global_plane_launches`` count the two forms.  The choice follows the
geometry alone; a launch the card refuses raises.

Where the card runs every stream's cluster of C blocks at once (B no more
than the clusters ``cudaOccupancyMaxActiveClusters`` gives: every file
the transcoder decodes, B = 1, and the CLI's ``batch`` of 8 streams), the
kernel takes its cluster form instead: each stream's frame is decoded by a
thread-block cluster of C blocks as a wavefront over macroblock rows, the
plane spread over the cluster's shared memory (``cluster_form``: C = 16
where the card runs all B clusters of 16 at once, else 8).
``cluster_launches`` counts those launches and ``cluster_size`` holds the
C of the last one; they count in neither plane form.  The choice follows
what the wrapper can observe (B, the geometry and how many clusters of
each size the card runs at once), and a cluster launch the card refuses
raises.

``run_gop_host`` runs the kernel's per-op code (csrc/exec_ops.cuh) built
for the host with g++, in either form; it exists for the CPU tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..state import kernel_tables
from ..utils import build
from .executor_ref import run_gop_ref
from .packing import CHUNK, _geom

launches = 0
frame_launches = 0
smem_plane_launches = 0
global_plane_launches = 0
cluster_launches = 0
cluster_size = 0

# stride policy of the codec (MobiclipDecoder.cs:50-52)
STRIDES = (256, 512, 1024)

# dynamic shared memory one block may use on the H100
SMEM_MAX = 232_448
# the kernel's MobiStage (csrc/exec_ops.cuh): two chunks of op rows and
# MOBI_K = 8 op slots of 2,656 bytes
STAGE_BYTES = 2 * CHUNK * 4 * 4 + 8 * 2656
# the cluster form's MobiClState: progress, last chunk, the width flag,
# the two words of corner flags, 65 row starts, 16-byte aligned
CL_STATE_BYTES = 288
# macroblock rows the cluster form serves
CL_MAXR = 64
# blocks per cluster in the cluster form: CLUSTER_WIDE where the card runs
# every stream's cluster of that size at once, else CLUSTER where it runs
# every one of those
CLUSTER = 8
CLUSTER_WIDE = 16

_lib = None
_host_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _load():
    global _lib
    if _lib is None:
        lib = build.load("gop_executor", ["gop_executor.cu"], "nvcc")
        lib.mobi_gop_executor_launch.restype = ctypes.c_int
        lib.mobi_gop_executor_launch.argtypes = [_P, _P, _P, _P, _P,
                                                 _I, _I, _I, _I, _I, _I, _I,
                                                 _P]
        lib.mobi_gop_executor_cluster_launch.restype = ctypes.c_int
        lib.mobi_gop_executor_cluster_launch.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.mobi_gop_executor_cluster_capacity.restype = ctypes.c_int
        lib.mobi_gop_executor_cluster_capacity.argtypes = [_I, _I, _I, _I]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("exec_host", ["exec_host.cpp"], "g++", "host")
        lib.mobi_gop_executor_host.restype = ctypes.c_int
        lib.mobi_gop_executor_host.argtypes = [_P, _P, _P, _P, _P,
                                               _I, _I, _I, _I, _I, _I]
        lib.mobi_gop_executor_host_smem_bytes.restype = ctypes.c_int
        lib.mobi_gop_executor_host_smem_bytes.argtypes = [_I, _I, _I]
        lib.mobi_gop_executor_host_cluster.restype = ctypes.c_int
        lib.mobi_gop_executor_host_cluster.argtypes = [_P, _P, _P, _P, _P,
                                                       _I, _I, _I, _I, _I,
                                                       _I, _I]
        lib.mobi_gop_executor_host_cluster_smem_bytes.restype = ctypes.c_int
        lib.mobi_gop_executor_host_cluster_smem_bytes.argtypes = [_I, _I, _I]
        _host_lib = lib
    return _host_lib


def smem_bytes(H: int, S: int, smem_plane: bool) -> int:
    """Dynamic shared memory of one block: the staging area, plus the plane
    region (rows MR .. MR + HH, S + 16 columns) when it is in shared
    memory."""
    return STAGE_BYTES + ((H + H // 2) * (S + 16) if smem_plane else 0)


def plane_in_smem(H: int, S: int) -> bool:
    """Whether the kernel keeps the working plane in shared memory."""
    return smem_bytes(H, S, True) <= SMEM_MAX


def cluster_smem_bytes(H: int, S: int, C: int) -> int:
    """Dynamic shared memory of one block of the cluster form: the staging
    area, the state, and a window of 26 lines for each macroblock row it
    owns (rank, rank + C, ...): its 16 luma and 8 U|V rows and the line
    above each part."""
    return STAGE_BYTES + CL_STATE_BYTES + -(-(H // 16) // C) * 26 * (S + 16)


def cluster_form(B: int, H: int, S: int, active: dict[int, int]) -> int:
    """The cluster size C the kernel takes for B streams at this geometry
    on a card that runs ``active[C]`` clusters of C blocks at once, or 0
    for the one-block form: the largest of CLUSTER_WIDE and CLUSTER whose
    B clusters all run at once and whose blocks fit."""
    if H // 16 > CL_MAXR:
        return 0
    for C in (CLUSTER_WIDE, CLUSTER):
        if B <= active.get(C, 0) and cluster_smem_bytes(H, S, C) <= SMEM_MAX:
            return C
    return 0


_active: dict[tuple, dict[int, int]] = {}


def _active_clusters(device: torch.device, H: int, S: int) -> dict[int, int]:
    """Clusters of CLUSTER_WIDE and of CLUSTER blocks the card runs at
    once at this geometry (``cudaOccupancyMaxActiveClusters``; 0 where it
    runs none)."""
    key = (device.index, H, S)
    if key not in _active:
        with torch.cuda.device(device):
            _active[key] = {C: max(_load().mobi_gop_executor_cluster_capacity(
                H, S, C, device.index), 0) for C in (CLUSTER_WIDE, CLUSTER)}
    return _active[key]


def _check(ops, resid, ring, F: int, H: int, S: int) -> None:
    if S not in STRIDES:
        raise ValueError(f"stride {S} is not one of the codec's strides "
                         f"{STRIDES}")
    _hh, G8, SP = _geom(H, S)
    B, nct = ops.shape[:2]
    want = {"ops": (ops, torch.int32, (B, nct, CHUNK, 4)),
            "resid": (resid, torch.int32, (B, nct, CHUNK, 64)),
            "ring": (ring, torch.uint8, (B, 6, G8 * 8, SP))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ops.device:
            raise ValueError(f"{name} is on {t.device}, ops on {ops.device}")
    if B < 1 or F < 1:
        raise ValueError("empty GOP")


def run_gop(ops: torch.Tensor, resid: torch.Tensor, ring: torch.Tensor,
            F: int, H: int, S: int) -> torch.Tensor:
    """Execute a packed GOP.  ops (B, nct, CHUNK, 4) int32, resid
    (B, nct, CHUNK, 64) int32 spatial residual rows, ring (B, 6, R, SP)
    uint8 (updated in place).  Returns frames (F, B, R, SP) uint8."""
    _check(ops, resid, ring, F, H, S)
    B, nct = ops.shape[:2]
    # every frame's plane is zeroed by the executor at its first chunk
    frames = torch.empty((F, B) + tuple(ring.shape[2:]), dtype=torch.uint8,
                         device=ops.device)
    tabs = kernel_tables(ops.device)
    if ops.device.type == "cpu":
        run_gop_ref(ops, resid, ring, frames, tabs, H, S)
        return frames
    if ops.device.type != "cuda":
        raise ValueError(f"no executor for device {ops.device}")
    _launch(ops, resid, ring, frames, tabs, F, H, S)
    return frames


def _launch(ops, resid, ring, frames, tabs, F: int, H: int, S: int) -> None:
    """Launch the kernel on ops.device in the form B and the card take."""
    global launches, frame_launches, smem_plane_launches
    global global_plane_launches, cluster_launches, cluster_size
    B, nct = ops.shape[:2]
    lib = _load()
    smem_plane = plane_in_smem(H, S)
    C = cluster_form(B, H, S, _active_clusters(ops.device, H, S))
    args = (ops.data_ptr(), resid.data_ptr(), ring.data_ptr(),
            frames.data_ptr(), tabs.data_ptr(), B, nct, F, H, S)
    # the library's runtime launches on the device current on this thread;
    # the launch checks that it is ops.device
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream(ops.device).cuda_stream
        if C:
            rc = lib.mobi_gop_executor_cluster_launch(
                *args, C, ops.device.index, stream)
        else:
            rc = lib.mobi_gop_executor_launch(
                *args, int(smem_plane), ops.device.index, stream)
    if rc != 0:
        form = (f"clusters of {C} blocks, {cluster_smem_bytes(H, S, C)} B"
                if C else f"{smem_bytes(H, S, smem_plane)} B")
        raise RuntimeError(f"gop executor launch on {ops.device} failed: "
                           f"CUDA error {rc} ({form} of shared memory per "
                           f"block)")
    if F == 1:
        frame_launches += 1
    else:
        launches += 1
    if C:
        cluster_launches += 1
        cluster_size = C
    elif smem_plane:
        smem_plane_launches += 1
    else:
        global_plane_launches += 1


def run_gop_host(ops: np.ndarray, resid: np.ndarray, ring: np.ndarray,
                 F: int, H: int, S: int, smem_plane: bool | None = None,
                 cluster: int = 0, order: int = 0) -> np.ndarray:
    """The kernel's per-op code built for the host (g++), on numpy arrays;
    updates ``ring`` in place and returns frames (F, B, R, SP) uint8.
    ``smem_plane`` forces the one-block form's plane (default: the
    kernel's choice for this geometry).  ``cluster`` = C runs the cluster
    form of C blocks instead, in wavefront order ``order`` (0: by level
    c + 2m, rows descending within a level; 1: ascending; 2: the lowest
    row whose waits hold first)."""
    if smem_plane is None:
        smem_plane = plane_in_smem(H, S)
    ops = np.ascontiguousarray(ops, np.int32)
    resid = np.ascontiguousarray(resid, np.int32)
    if not (ring.flags.c_contiguous and ring.dtype == np.uint8):
        raise ValueError("ring must be a contiguous uint8 array")
    _check(torch.from_numpy(ops), torch.from_numpy(resid),
           torch.from_numpy(ring), F, H, S)
    B, nct = ops.shape[:2]
    frames = np.empty((F, B) + ring.shape[2:], np.uint8)
    tabs = kernel_tables("cpu").numpy()
    args = (ops.ctypes.data, resid.ctypes.data, ring.ctypes.data,
            frames.ctypes.data, tabs.ctypes.data, B, nct, F, H, S)
    if cluster:
        rc = _load_host().mobi_gop_executor_host_cluster(*args, cluster,
                                                         order)
        if rc != 0:
            raise RuntimeError(f"host cluster form (C={cluster}) failed: "
                               f"{rc}")
    else:
        _load_host().mobi_gop_executor_host(*args, int(smem_plane))
    return frames


def host_smem_bytes(H: int, S: int, smem_plane: bool) -> int:
    """The kernel source's own count of a block's shared memory
    (``mobi_smem_bytes``), from the host build."""
    return _load_host().mobi_gop_executor_host_smem_bytes(H, S,
                                                          int(smem_plane))


def host_cluster_smem_bytes(H: int, S: int, C: int) -> int:
    """The kernel source's own count of a cluster-form block's shared
    memory (``mobi_cl_smem_bytes``), from the host build."""
    return _load_host().mobi_gop_executor_host_cluster_smem_bytes(H, S, C)
