"""The port's own copies of the codec's host modules against the JAX
package's originals, at 64x48 on seeds drawn with numpy: the tables'
arrays, the synthesizer's bytes, the oracle's frames, the native
scanner's packed GOP parts (the port builds the repository's scanner into
its own csrc/build/, the JAX package into native/build/) and the Majesco
stub's outputs."""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models import audio_majesco as jmj
from mobiclipdecoder_tpu.models.oracle_video import (
    MobiclipVersion as JVersion, OracleDecoder as JOracle)
from mobiclipdecoder_tpu.tables import TABLES as JTABLES
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer as JSynth
from mobiclipdecoder_tpu.utils.native import NativePlanner as JNative

from mobiclipdecoder_tpu_torch.models import audio_majesco as mj
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


def test_audio_majesco_outputs_equal():
    """The Majesco stub: its tables, header parse, null results, decode
    tables on random canonical codes, over-subscription and bit reader."""
    for k in ("CODE_LENGTH_ORDER", "DISTANCE_TABLE", "LENGTH_TABLE"):
        np.testing.assert_array_equal(getattr(mj, k), getattr(jmj, k))
    rng = np.random.default_rng(77)
    blob = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    for off in (0, 5, 20):
        assert mj.get_output_size(blob, off) == jmj.get_output_size(blob,
                                                                     off)
        assert mj.inflate(blob, off) is None and jmj.inflate(blob, off) is None
    assert mj.MajescoDecoder().decode(blob) is jmj.MajescoDecoder().decode(
        blob) is None
    for n, top in ((20, 8), (300, 15)):
        lengths = rng.integers(0, top + 1, n).astype(np.int32)
        try:
            want = jmj.build_decode_table(lengths)
        except ValueError:
            with pytest.raises(ValueError):
                mj.build_decode_table(lengths)
            continue
        got = mj.build_decode_table(lengths)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    lengths = np.array([1, 2, 3] + [10] * 4 + [0] * 5, np.int32)
    for a, b in zip(mj.build_decode_table(lengths),
                    jmj.build_decode_table(lengths)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        mj.build_decode_table(np.array([1, 1, 1], np.int32))
    br, jbr = mj.MajescoBitReader(blob, 2), jmj.MajescoBitReader(blob, 2)
    for nbits in rng.integers(1, 17, 40):
        assert br.read(int(nbits)) == jbr.read(int(nbits))
