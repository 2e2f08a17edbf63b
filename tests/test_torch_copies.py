"""The port's own copies of the codec's host modules against the JAX
package's originals, at 64x48 on seeds drawn with numpy: the tables'
arrays, the synthesizer's bytes, the oracle's frames and the native
scanner's packed GOP parts (the port builds the repository's scanner into
its own csrc/build/, the JAX package into native/build/)."""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (
    MobiclipVersion as JVersion, OracleDecoder as JOracle)
from mobiclipdecoder_tpu.tables import TABLES as JTABLES
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer as JSynth
from mobiclipdecoder_tpu.utils.native import NativePlanner as JNative

from mobiclipdecoder_tpu_torch.models.oracle_video import (MobiclipVersion,
                                                           OracleDecoder)
from mobiclipdecoder_tpu_torch.tables import TABLES
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu_torch.utils import build, native

W, H = 64, 48
VERSIONS = ["MODS_DS", "MOFLEX_3DS"]
SEEDS = [int(s) for s in np.random.default_rng(2024).integers(0, 10**6, 2)]


def _packets(synth_cls, version, seed, n=5):
    s = synth_cls(W, H, version, seed=seed)
    return [s.iframe(0x18) if i == 0 else s.pframe(dq=i % 3 - 1)
            for i in range(n)]


def _both(name, seed):
    return (_packets(StreamSynthesizer, MobiclipVersion[name], seed),
            _packets(JSynth, JVersion[name], seed))


def test_tables_equal():
    assert sorted(TABLES.keys()) == sorted(JTABLES.keys())
    for k in JTABLES.keys():
        np.testing.assert_array_equal(TABLES[k], JTABLES[k], err_msg=k)


@pytest.mark.parametrize("name", VERSIONS)
def test_synth_bytes_equal(name):
    for seed in SEEDS:
        port, jax_pkts = _both(name, seed)
        assert port == jax_pkts, (name, seed)


@pytest.mark.parametrize("name", VERSIONS)
def test_oracle_frames_equal(name):
    for seed in SEEDS:
        pkts, _ = _both(name, seed)
        po = OracleDecoder(W, H, MobiclipVersion[name])
        jo = JOracle(W, H, JVersion[name])
        for k, pkt in enumerate(pkts):
            for o in (po, jo):
                o.data = pkt
                o.offset = 0
                o.decode_frame()
            assert po.offset == jo.offset == len(pkt)
            np.testing.assert_array_equal(po.y_planes[0], jo.y_planes[0],
                                          err_msg=f"{name} {seed} {k} y")
            np.testing.assert_array_equal(po.uv_planes[0], jo.uv_planes[0],
                                          err_msg=f"{name} {seed} {k} uv")


@pytest.mark.parametrize("name", VERSIONS)
def test_native_scanner_parts_equal(name):
    for seed in SEEDS:
        pkts, _ = _both(name, seed)
        pr = native.NativePlanner(W, H, int(MobiclipVersion[name]))
        jr = JNative(W, H, int(JVersion[name]))
        a, b = pr.scan_gop_packed(pkts), jr.scan_gop_packed(pkts)
        assert (a["nct"], a["nnz"], a["done"], a["err"], a["val_overflow"]) \
            == (b["nct"], b["nnz"], b["done"], b["err"], b["val_overflow"])
        assert a["done"] == len(pkts) and a["nct"] > 0
        nct, nnz = a["nct"], a["nnz"]
        for k, n in (("ops3", nct), ("szw", nct * 8), ("idx", nnz),
                     ("val", nnz), ("frame_nct", None), ("frame_nnz", None),
                     ("consumed", None)):
            np.testing.assert_array_equal(a[k][:n], b[k][:n],
                                          err_msg=f"{name} {seed} {k}")
    lib = build.BUILD / "host" / "libmobiscan.so"
    assert lib.exists() and native._lib is not None
