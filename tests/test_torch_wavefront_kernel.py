"""The wavefront engine's kernel code (csrc/wavefront_ops.cuh, K6's
per-stream function, built for the host with g++ as
csrc/wavefront_host.cpp and run stream by stream) against the JAX package's
jitted ``decode_frame_core`` on the CPU and against the port's plain
version ``decode_frame_core_plain``: real plans of synthesized streams,
a batch of streams with different level counts, blocks at the frame's
right and bottom edges, and plane-predictor ops.  Exact equality
throughout.  Also the wrapper's input checks and its failed build.  The
kernel itself runs on the card only (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.models import pipeline as jp

from mobiclipdecoder_tpu_torch.models import pipeline as pp
from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.models.plan import PlanningDecoder
from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
from mobiclipdecoder_tpu_torch.parallel.batch import stack_plans
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer

DS, MF = MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS
KEYS = ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap")


def _plans(W, H, version, seed, n):
    """FramePlans of an I-frame and n - 1 P-frames from the planner."""
    synth = StreamSynthesizer(W, H, version, seed=seed)
    p = PlanningDecoder(W, H, version)
    out = []
    for i in range(n):
        p.data = synth.iframe(0x18) if i == 0 else synth.pframe()
        p.offset = 0
        p.decode_frame()
        out.append(p.plan())
    return out


def _three_ways(ring, arrays, H, S):
    """The host build of K6 and the plain version on the stacked arrays
    (B streams), asserted equal; returns K6's (B, HH, S) frames."""
    got = wk.wavefront_frame_host(ring, *(arrays[k] for k in KEYS),
                                  np.asarray(arrays["n_levels"]), H, S)
    plain = pp.decode_frame_core_plain(
        torch.from_numpy(ring), *(torch.from_numpy(arrays[k]) for k in KEYS),
        arrays["n_levels"], H, S)
    np.testing.assert_array_equal(got, plain.numpy())
    return got


def _jax_frame(ring1, plan, H, S):
    """The JAX package's jitted decode_frame_core of one stream's plan on
    its own bucketed arrays; ring1 (6, HH, S)."""
    j = jp.prepare_plan(plan)
    return np.asarray(jp._decode_frame_jit(
        jnp.asarray(ring1), j["mc"], j["resid"], j["resid_coef"], j["iops"],
        j["icoef"], j["seqmap"], j["n_levels"], H, S))


@pytest.mark.parametrize("version", [DS, MF], ids=["ds", "moflex"])
def test_host_kernel_matches_jax_on_a_gop(version):
    """An I-frame and 3 P-frames at 64x48 through K6's code with the ring
    carried (it starts from random pixels, so MC reads every slot): each
    frame equals the JAX engine's and the plain version's."""
    W, H = 64, 48
    plans = _plans(W, H, version, seed=11, n=4)
    S = plans[0].stride
    HH = H + H // 2
    ring = np.random.default_rng(3).integers(0, 256, (1, 6, HH, S)).astype(
        np.int32)
    for plan in plans:
        ring = np.roll(ring, 1, axis=1)
        got = _three_ways(ring, stack_plans([pp.prepare_plan(plan)]), H, S)
        np.testing.assert_array_equal(got[0], _jax_frame(ring[0], plan, H, S))
        ring[:, 0] = got
    assert plans[-1].mc.shape[0] > 0 and plans[0].n_levels > 10


def test_host_kernel_batch_of_streams_with_their_own_levels():
    """Three DS streams whose frames have different level counts, stacked
    with padding levels: each stream runs its own n_levels, and its frame
    equals the JAX engine's decode of that stream alone."""
    W, H = 64, 48
    streams = [_plans(W, H, DS, seed=s, n=3) for s in (30, 31, 32)]
    S = streams[0][0].stride
    HH = H + H // 2
    ring = np.random.default_rng(4).integers(0, 256, (3, 6, HH, S)).astype(
        np.int32)
    seen = set()
    for f in range(3):
        ring = np.roll(ring, 1, axis=1)
        plans = [s[f] for s in streams]
        arrays = stack_plans([pp.prepare_plan(p) for p in plans])
        seen.add(tuple(arrays["n_levels"]))
        got = _three_ways(ring, arrays, H, S)
        for b, plan in enumerate(plans):
            np.testing.assert_array_equal(
                got[b], _jax_frame(ring[b], plan, H, S), err_msg=f"{f} {b}")
        ring[:, 0] = got
    assert any(len(set(nl)) > 1 for nl in seen)


def _edge_case(H, S, seed):
    """Hand-made plan arrays of one stream: MC leaves and residual blocks
    and intra ops (one per level, every mode family) at the frame's right
    and bottom edges and past them, whose reads clip and whose writes wrap
    into the next row or fall past the frame and are dropped; a random
    sequence map."""
    HH = H + H // 2
    rng = np.random.default_rng(seed)
    mc = np.array([
        # y, x, w, h, ref, dx, dy
        (0, 32, 16, 16, 1, 3, 5),                 # interior, half-pel both
        (H - 16, S - 8, 16, 16, 2, 7, -3),        # right edge: wraps a row
        (HH - 8, 16, 16, 16, 3, -5, 9),           # past the bottom: dropped
        (16, S - 24, 8, 8, 5, 40, 2),             # reads past the right
        (0, 32, 0, 16, 1, 0, 0)], np.int32)       # w == 0: nothing
    resid = np.array([
        # plane, y, x, size
        (0, 4, 4, 8), (0, H - 4, S - 4, 8), (1, H // 2 - 4, 40, 4),
        (1, H // 2 - 2, S - 2, 8), (0, 8, 48, 0)], np.int32)
    rcoef = rng.integers(-300, 300, (5, 64)).astype(np.int32)
    ops = []
    for mode, size, y, x in ((3, 8, 8, S - 4), (8, 4, H - 4, S - 4),
                             (9, 8, HH - 4, 60), (2, 16, H - 8, S - 8),
                             (12, 4, 16, S - 2), (4, 8, 24, 24),
                             (5, 4, 0, 0), (7, 8, 8, 80), (17, 4, 12, 100)):
        pid = 0
        if y >= H:
            pid, y = 1, y - H
        ops.append((pid, y, x, size, mode, int(rng.integers(-40, 40)),
                    int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                    int(rng.integers(0, 2)), 0, int(rng.integers(2, 9))))
    iops = np.array(ops, np.int32)[:, None, :]
    icoef = rng.integers(-200, 200, (len(ops), 1, 64)).astype(np.int32)
    seqmap = rng.integers(-1, 9, (HH // 4, S // 4)).astype(np.int32)
    return dict(mc=mc, resid=resid, resid_coef=rcoef, iops=iops,
                icoef=icoef, seqmap=seqmap,
                n_levels=np.int32(len(ops)))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_kernel_clips_reads_and_drops_writes_at_the_edges(seed):
    W, H, S = 64, 48, 256
    HH = H + H // 2
    a = _edge_case(H, S, seed)
    ring = np.random.default_rng(seed).integers(0, 256, (6, HH, S)).astype(
        np.int32)
    arrays = {k: v[None] for k, v in a.items()}
    got = _three_ways(ring[None], arrays, H, S)
    ref = np.asarray(jp._decode_frame_jit(
        jnp.asarray(ring), *(jnp.asarray(a[k]) for k in KEYS),
        a["n_levels"], H, S))
    np.testing.assert_array_equal(got[0], ref)
    # the right-edge leaf's rows wrapped: it wrote row H - 15's first
    # pixels
    assert got[0, H - 15, :8].any()


@pytest.mark.parametrize("size", [4, 8, 16])
def test_host_kernel_plane_predictor(size):
    """Plane-mode ops (mode 2 at sizes 8 and 16, mode 12 at 4) over taps
    that MC copied from a random ring, with gradients large enough that the
    composed bytes wrap, some with residuals."""
    W, H, S = 64, 48, 256
    HH = H + H // 2
    rng = np.random.default_rng(100 + size)
    mc = np.array([(y, x, 16, 16, 1, 0, 0) for y in range(0, H, 16)
                   for x in range(0, W, 16)], np.int32)
    grads = [-2000, 2000, -1, 0, 127, -128, 900, int(rng.integers(-600, 600))]
    ops = []
    for k, g in enumerate(grads):
        y = 16 + (k // 4) * size if size < 16 else 16
        x = 16 + (k % 4) * size if size < 16 else 16 + (k % 2) * 16
        lv = k if size == 16 else 0
        ops.append((lv, (0, y, x, size, 12 if size == 4 else 2, g, k & 1,
                         1, 1, 0, 5)))
    L = max(lv for lv, _ in ops) + 1
    K = max(sum(1 for lv, _ in ops if lv == i) for i in range(L))
    iops = np.zeros((L, K, 11), np.int32)
    fill = [0] * L
    for lv, op in ops:
        iops[lv, fill[lv]] = op
        fill[lv] += 1
    icoef = rng.integers(-300, 300, (L, K, 64)).astype(np.int32)
    seqmap = np.zeros((HH // 4, S // 4), np.int32)
    a = dict(mc=mc, resid=np.zeros((1, 4), np.int32),
             resid_coef=np.zeros((1, 64), np.int32), iops=iops, icoef=icoef,
             seqmap=seqmap, n_levels=np.int32(L))
    ring = rng.integers(0, 256, (6, HH, S)).astype(np.int32)
    got = _three_ways(ring[None], {k: v[None] for k, v in a.items()}, H, S)
    ref = np.asarray(jp._decode_frame_jit(
        jnp.asarray(ring), *(jnp.asarray(a[k]) for k in KEYS), a["n_levels"],
        H, S))
    np.testing.assert_array_equal(got[0], ref)
    assert (got[0, 16:16 + size, 16:16 + size] != ring[1, 16:16 + size,
                                                       16:16 + size]).any()


def test_host_kernel_level_reads_before_its_writes():
    """One level of 80 ops, more than K6 gathers in shared memory at once
    (MOBI_WF_KC, 64): its last op takes its left taps from pixels that its
    first op writes, visible by the sequence map.  As in the functional
    engines, every op of a level reads the frame as it stood before the
    level: the taps must be MC's pixels, not the first op's."""
    W, H, S = 64, 48, 256
    HH = H + H // 2
    rng = np.random.default_rng(7)
    mc = np.array([(y, x, 16, 16, 1, 0, 0) for y in range(0, H, 16)
                   for x in range(0, W, 16)], np.int32)
    ops = np.zeros((1, 80, 11), np.int32)
    ops[0, 0] = (0, 8, 8, 4, 3, 0, 1, 0, 0, 1, 9)          # DC 0x80 + res
    for k in range(1, 79):                                # elsewhere
        ops[0, k] = (1, 4 * (k // 24), 4 * (k % 24) + 8, 4, 3, 0, 0, 1, 1,
                     1, 9)
    ops[0, 79] = (0, 8, 12, 4, 1, 0, 0, 1, 1, 1, 9)       # copies left taps
    a = dict(mc=mc, resid=np.zeros((1, 4), np.int32),
             resid_coef=np.zeros((1, 64), np.int32), iops=ops,
             icoef=rng.integers(-300, 300, (1, 80, 64)).astype(np.int32),
             seqmap=np.zeros((HH // 4, S // 4), np.int32),
             n_levels=np.int32(1))
    ring = rng.integers(0, 256, (6, HH, S)).astype(np.int32)
    got = _three_ways(ring[None], {k: v[None] for k, v in a.items()}, H, S)
    ref = np.asarray(jp._decode_frame_jit(
        jnp.asarray(ring), *(jnp.asarray(a[k]) for k in KEYS), a["n_levels"],
        H, S))
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(got[0, 8:12, 12:16],
                                  np.repeat(ring[1, 8:12, 11:12], 4, axis=1))
    assert (got[0, 8:12, 11] != ring[1, 8:12, 11]).any()


def test_host_kernel_matches_jax_on_a_128x96_iframe():
    W, H = 128, 96
    plan = _plans(W, H, DS, seed=6, n=1)[0]
    S = plan.stride
    HH = H + H // 2
    ring = np.zeros((1, 6, HH, S), np.int32)
    got = _three_ways(ring, stack_plans([pp.prepare_plan(plan)]), H, S)
    np.testing.assert_array_equal(got[0], _jax_frame(ring[0], plan, H, S))
    assert plan.n_levels > 40


def test_wrapper_checks_inputs_and_never_falls_back():
    """K6's wrapper takes contiguous int32 CUDA tensors of consistent
    shapes only: CPU tensors raise (decode_frame_core takes the plain
    version for them itself), and so does a tensor on any other device
    through decode_frame_core."""
    W, H = 64, 48
    plan = _plans(W, H, DS, seed=2, n=1)[0]
    a = stack_plans([pp.prepare_plan(plan)])
    S = plan.stride
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
         for k, v in a.items()}
    ring = torch.zeros((1, 6, H + H // 2, S), dtype=torch.int32)
    args = [ring, *(t[k] for k in KEYS), t["n_levels"]]
    before = wk.wavefront_launches
    with pytest.raises(ValueError, match="CUDA"):
        wk.wavefront_frame(*args, H, S)
    with pytest.raises(ValueError, match="int32"):
        wk.wavefront_frame(ring.long(), *args[1:], H, S)
    with pytest.raises(ValueError, match="meta"):
        pp.decode_frame_core(*(x.to("meta") for x in args), H, S)
    with pytest.raises(ValueError, match="expected ring"):
        wk.frame_sizes(*args[:7], torch.zeros(2, dtype=torch.int32), H, S)
    with pytest.raises(ValueError, match="expected ring"):
        wk.wavefront_frame_host(*(x.numpy() for x in args), H, S + 4)
    assert wk.wavefront_launches == before
    # the CPU path is the plain version, and equals K6's host build
    got = pp.decode_frame_core(*args[:7], a["n_levels"], H, S)
    np.testing.assert_array_equal(
        got.numpy(), wk.wavefront_frame_host(*(x.numpy() for x in args),
                                             H, S))


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """K6 that cannot be built raises from the wrapper's loader; no path
    falls back to the plain version for a CUDA tensor."""
    from mobiclipdecoder_tpu_torch.utils import build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(wk, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        wk._load()
    monkeypatch.setattr(build, "find_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="failed building"):
        wk._load()
    assert wk._lib is None and not list(tmp_path.rglob("*.so"))
