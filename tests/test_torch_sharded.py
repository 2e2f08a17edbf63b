"""The port's multi-device decode on the CPU: the whole-GOP and per-round
executor paths split over a device list (ops/vmem_engine.py), the
wavefront BatchVideoDecoder over several devices (parallel/batch.py), and
the device handling they rest on: each NCCL rank pinned to its own GPU
(parallel/distributed.py), the download event recorded on the decoder's
device, indexed device names.  Devices are ["cpu"] * n here; every
comparison is exact."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from mobiclipdecoder_tpu.ops import vmem_engine as jve

from mobiclipdecoder_tpu_torch import state
from mobiclipdecoder_tpu_torch.models.oracle_video import (MobiclipVersion,
                                                           OracleDecoder)
from mobiclipdecoder_tpu_torch.ops import executor
from mobiclipdecoder_tpu_torch.ops.packing import _pack_gop_chunks
from mobiclipdecoder_tpu_torch.ops.vmem_engine import (
    VmemBatchDecoder, _decode_gop_fused, decode_gop_fused_sharded,
    decode_round_sharded, gather_shards, sharded_rings)
from mobiclipdecoder_tpu_torch.parallel import distributed
from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu_torch.utils.device import check_device, indexed

W, H = 64, 48
DS = MobiclipVersion.MODS_DS


def _gop(seeds, F):
    synths = [StreamSynthesizer(W, H, DS, seed=s) for s in seeds]
    return [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
            for f in range(F)]


def _packed(seeds, F):
    """(ops, coefs, sizes) host arrays of one GOP, and the stride."""
    B = len(seeds)
    dec = VmemBatchDecoder(W, H, DS, batch=B, device="cpu", native=False)
    plans_fb = [dec._scan_all(fp) for fp in _gop(seeds, F)]
    return _pack_gop_chunks(plans_fb, B), dec.stride


def _unsharded(arrays, F, S):
    ring = torch.zeros(state.ring_shape(arrays[0].shape[0], H, S),
                       dtype=torch.uint8)
    return _decode_gop_fused(ring, *map(torch.from_numpy, arrays), F, H, S)


@pytest.mark.parametrize("n", [2, 4])
def test_gop_sharded_matches_unsharded(n):
    """B=8, F=3 (seeds 100-107, as the JAX package's sharded test): n
    shards, one executor call each, == one call on the whole batch."""
    (ops, coefs, sizes), S = _packed(range(100, 108), 3)
    before = executor.launches
    rings, yuvs = decode_gop_fused_sharded(
        ["cpu"] * n, sharded_rings(["cpu"] * n, 8, H, S), ops, coefs, sizes,
        3, H, S)
    assert len(rings) == len(yuvs) == n
    assert all(y.shape == (3, 8 // n, H + H // 2, S) for y in yuvs)
    assert executor.launches == before       # the CPU runs the plain version
    ring1, yuv1 = _unsharded((ops, coefs, sizes), 3, S)
    np.testing.assert_array_equal(gather_shards(yuvs), yuv1.numpy())
    np.testing.assert_array_equal(gather_shards(rings, 0), ring1.numpy())


def test_gop_sharded_matches_jax_sharded():
    """The port's sharded GOP over 4 devices == the JAX package's
    decode_gop_fused_sharded over a 4-device CPU mesh (interpret mode):
    frames and ring."""
    (ops, coefs, sizes), S = _packed(range(100, 108), 3)
    rings, yuvs = decode_gop_fused_sharded(
        ["cpu"] * 4, sharded_rings(["cpu"] * 4, 8, H, S), ops, coefs, sizes,
        3, H, S)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    jdec = jve.VmemBatchDecoder(W, H, DS, batch=8, interpret=True,
                                native=False)
    jring, jyuv = jve.decode_gop_fused_sharded(
        mesh, jnp.zeros_like(jdec.ring), jnp.asarray(ops), jnp.asarray(coefs),
        jnp.asarray(sizes), 3, H, S, True)
    np.testing.assert_array_equal(gather_shards(yuvs), np.asarray(jyuv))
    np.testing.assert_array_equal(
        gather_shards(rings, 0),
        state.ring_from_jax(np.asarray(jring), H, S).numpy())


def test_round_sharded_matches_unsharded_over_two_rounds():
    seeds = range(110, 114)
    dec = VmemBatchDecoder(W, H, DS, batch=4, device="cpu", native=False)
    S = dec.stride
    rings = sharded_rings(["cpu"] * 2, 4, H, S)
    ring1 = dec.ring
    for fp in _gop(seeds, 2):
        arrays = dec.scan_packets(fp)
        rings, yuvs = decode_round_sharded(["cpu", "cpu"], rings, *arrays, H,
                                           S)
        assert [tuple(y.shape) for y in yuvs] == [(2, H + H // 2, S)] * 2
        ring1, yuv1 = _decode_gop_fused(ring1, *map(torch.from_numpy, arrays),
                                        1, H, S)
        np.testing.assert_array_equal(gather_shards(yuvs, 0), yuv1[0].numpy())
    np.testing.assert_array_equal(gather_shards(rings, 0), ring1.numpy())


def test_uneven_split_and_wrong_rings_raise():
    (ops, coefs, sizes), S = _packed(range(120, 126), 1)
    with pytest.raises(ValueError, match="6 streams do not split over 4"):
        decode_gop_fused_sharded(["cpu"] * 4, [], ops, coefs, sizes, 1, H, S)
    with pytest.raises(ValueError, match="do not split"):
        sharded_rings(["cpu"] * 4, 6, H, S)
    with pytest.raises(ValueError, match="1 rings for 2 devices"):
        decode_gop_fused_sharded(["cpu"] * 2, sharded_rings(["cpu"], 3, H, S),
                                 ops, coefs, sizes, 1, H, S)
    with pytest.raises(ValueError, match="expected 3 streams"):
        decode_gop_fused_sharded(["cpu"] * 2, sharded_rings(["cpu"] * 3, 6, H,
                                                            S)[:2],
                                 ops, coefs, sizes, 1, H, S)


def _oracle_gop(seed, nframes):
    synth = StreamSynthesizer(W, H, DS, seed=seed)
    dec = OracleDecoder(W, H, DS)
    pkts, planes = [], []
    for i in range(nframes):
        pkt = synth.iframe(0x18) if i == 0 else synth.pframe()
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        pkts.append(pkt)
        planes.append(np.concatenate([dec.y_planes[0].reshape(H, -1),
                                      dec.uv_planes[0].reshape(H // 2, -1)]))
    return pkts, planes


@pytest.mark.parametrize("gop", [False, True])
def test_batch_decoder_over_devices_matches_oracle(gop):
    """BatchVideoDecoder(devices=["cpu"] * 2) on 4 streams x 2 frames
    (seeds 200-203, as the JAX package's mesh test) == the oracle, frame
    by frame and as one GOP; its ring == the one-device decoder's."""
    B, F = 4, 2
    data = [_oracle_gop(200 + b, F) for b in range(B)]
    bd = BatchVideoDecoder(W, H, DS, batch=B, devices=["cpu", "cpu"])
    one = BatchVideoDecoder(W, H, DS, batch=B, device="cpu")
    assert [r.shape[0] for r in bd.rings] == [2, 2]
    frames = [[data[b][0][f] for b in range(B)] for f in range(F)]
    if gop:
        out = bd.decode_gop(frames)
        np.testing.assert_array_equal(out, one.decode_gop(frames))
    else:
        out = np.stack([bd.decode_frames(fp) for fp in frames])
        for fp in frames:
            one.decode_frames(fp)
    for f in range(F):
        for b in range(B):
            np.testing.assert_array_equal(out[f, b], data[b][1][f])
    np.testing.assert_array_equal(bd.ring.numpy(), one.ring.numpy())


def test_batch_decoder_device_arguments():
    with pytest.raises(TypeError, match="exactly one"):
        BatchVideoDecoder(W, H, DS, batch=2)
    with pytest.raises(TypeError, match="exactly one"):
        BatchVideoDecoder(W, H, DS, batch=2, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="3 streams do not split over 2"):
        BatchVideoDecoder(W, H, DS, batch=3, devices=["cpu", "cpu"])


def _fake_nccl(monkeypatch, rank, world, ngpu):
    """torch.cuda with ``ngpu`` GPUs and a process group that records its
    arguments; returns the calls."""
    calls = {"set_device": [], "init": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: ngpu)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls["set_device"].append(d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls["init"].append((a, k)))
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    return calls


def test_init_distributed_pins_each_nccl_rank_to_its_gpu(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    calls = _fake_nccl(monkeypatch, 3, 4, 4)
    assert distributed.init_distributed("127.0.0.1:29500", 4, 3) == (3, 4)
    assert calls["init"][0][0] == ("nccl",)
    assert calls["init"][0][1]["init_method"] == "tcp://127.0.0.1:29500"
    assert calls["set_device"] == [3]
    # two hosts of 2 GPUs: rank 3 is the second process of its host
    calls = _fake_nccl(monkeypatch, 3, 4, 2)
    distributed.init_distributed("127.0.0.1:29500", 4, 3)
    assert calls["set_device"] == [1]


def test_init_distributed_honours_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "0")
    calls = _fake_nccl(monkeypatch, 3, 4, 4)
    distributed.init_distributed("127.0.0.1:29500", 4, 3)
    assert calls["set_device"] == [0]


def test_init_distributed_leaves_gloo_and_standalone_alone(monkeypatch):
    calls = _fake_nccl(monkeypatch, 1, 2, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.init_distributed("127.0.0.1:29500", 2, 1) == (1, 2)
    assert calls["init"][0][0] == ("gloo",)
    assert calls["set_device"] == []
    assert distributed.init_distributed() == (0, 1)
    assert calls["set_device"] == [] and len(calls["init"]) == 1


def test_download_event_is_recorded_on_the_tensors_device(monkeypatch):
    """decode_gops' non-blocking copy of a GOP on cuda:1 is enqueued on
    cuda:1's stream; its event must be recorded there, not on the current
    device's stream."""
    recorded, copies = [], []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    class Host:
        def copy_(self, src, non_blocking=False):
            copies.append((src, non_blocking))

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    monkeypatch.setattr(torch, "empty", lambda *a, **k: Host())
    yuv = SimpleNamespace(device=torch.device("cuda", 1), shape=(2, 3),
                          dtype=torch.uint8)
    host, ev = VmemBatchDecoder._start_download(None, yuv)
    assert isinstance(host, Host) and copies == [(yuv, True)]
    assert recorded == [("stream of", torch.device("cuda", 1))]


def test_cuda_device_names_are_indexed(monkeypatch):
    """A bare "cuda" resolves to the current device's index, so per-device
    caches keep naming one card after torch.cuda.set_device; an index past
    the visible GPUs raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert indexed("cuda") == torch.device("cuda", 1)
    assert indexed("cuda:0") == torch.device("cuda", 0)
    assert indexed("cpu") == torch.device("cpu")
    assert check_device("cuda") == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        check_device("cuda:2")
