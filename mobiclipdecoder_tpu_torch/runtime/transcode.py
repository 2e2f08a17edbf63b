"""Batch transcoder of the port: container file in -> raw YUV/PCM/RGB out.

The demuxing, audio decoding, per-frame containment and writers are the
JAX package's ``runtime/transcode.py``, which imports no JAX: this module
loads it through ``shared`` as ``mobiclipdecoder_tpu_torch.shared.runtime.
transcode`` (a module object of its own, distinct from
``mobiclipdecoder_tpu.runtime.transcode``) and binds the port's video
decoder factory into it.  Its ``decode_*`` functions look the factory up
as a module global at each call, so every one of them decodes through the
port.  The JAX package's module keeps its own factory.

Engines:
  ``"oracle"``  the sequential oracle (the spec);
  ``"cuda"``    ``VmemVideoDecoder`` on the GPU: the hand-written CUDA
                executor.  Raises where no CUDA device is present;
  ``"cpu"``     the same decoder on the CPU, where the executor is its
                plain PyTorch version.  For tests; never chosen on its own.

The JAX package's ``"tpu"`` and ``"tpu-xla"`` engines raise
``ValueError`` here: their decoders need JAX.
"""
from __future__ import annotations

from ..ops.vmem_engine import VmemVideoDecoder
from ..shared.models.oracle_video import OracleDecoder
from ..shared.runtime import transcode as _shared

ENGINES = ("oracle", "cuda", "cpu")


def _make_video_decoder(width: int, height: int, version, engine: str):
    if engine == "oracle":
        return OracleDecoder(width, height, version)
    if engine in ("cuda", "cpu"):
        # crop=True: results come back at frame width (U|V adjacent)
        return VmemVideoDecoder(width, height, version, device=engine,
                                native=True, crop=True)
    if engine in ("tpu", "tpu-xla"):
        raise ValueError(f"engine {engine!r} belongs to the JAX package; "
                         f"the port's engines are {ENGINES}")
    raise ValueError(f"unknown engine {engine!r}")


_shared._make_video_decoder = _make_video_decoder

DecodedFrame = _shared.DecodedFrame
decode_mods = _shared.decode_mods
decode_moflex = _shared.decode_moflex
decode_moc5 = _shared.decode_moc5
decode_vx2 = _shared.decode_vx2
transcode = _shared.transcode
probe_info = _shared.probe_info
width_stride = _shared.width_stride


def play(path, engine: str = "cuda", **kwargs) -> dict:
    """The player loop of the shared transcoder (``realtime``,
    ``dump_frame``, ``dump_path``, ``pipe_y4m``, ``pipe_wav``), with the
    port's default engine."""
    return _shared.play(path, engine=engine, **kwargs)
