"""mobiclipdecoder_tpu_torch: the Mobiclip decoder's whole-GOP decode path
ported to PyTorch, with its executor, its device prologue, the wavefront
engine, the encoder's SAD volume and the batched audio ops as hand-written
CUDA kernels for NVIDIA Hopper (sm_90a), at DS 256x192, 3DS 400x240 and
Wii 640x480.  On CPU tensors each kernel's wrapper takes its plain torch
version instead.

Kernels (csrc/, built with nvcc at first use, bound with ctypes):
  K1/K2 gop_executor.cu   the whole-GOP executor, F frames or one
  K4, K5 prologue.cu      the IDCT pre-pass of dense rows; the blob prologue
  K6 wavefront.cu         the wavefront engine's GOP (one launch per GOP)
  K7 sad.cu               the encoder's full-search SAD volume
  K8, K9 audio.cu         the FastAudio lattice; the IMA ADPCM scans

The JAX package ``mobiclipdecoder_tpu`` is the reference this port is held
against; the port imports nothing of it.  The codec's host modules (oracle
``models/oracle_video.py``, planner ``models/plan.py``, the ctypes bridge
to the repository's C++ scanner ``utils/native.py``, synthesizer
``testing/synth.py``, tables, containers, host audio decoders, writers,
GOP sharding, the encoder, the Majesco stub) are the port's own copies of
the JAX package's files, at the same relative paths;
``tests/test_torch_copies.py`` holds them equal.

Layers, from the entry point down:
  __main__.py          python -m mobiclipdecoder_tpu_torch
                       {decode,info,play,batch,encode}
  runtime/transcode.py the transcoder with the port's decoders (engines
                       oracle, cuda, cpu, wavefront, wavefront-cpu) and
                       encode_y4m_to_moflex
  graft_entry.py       entry() and dryrun_multichip(n): the port's
                       counterpart of the repository's __graft_entry__.py
  tools/warm_kernels.py  builds and first launches before serving
  parallel/distributed.py  corpus worker (GOP shards, lockstep batches),
                       one process per GPU (init_distributed pins it)
  ops/vmem_engine.py   VmemBatchDecoder / VmemVideoDecoder (host scan,
                       dispatch, download); decode_gop_fused_sharded /
                       decode_round_sharded over a device list
  ops/packing.py       numpy packing of scanned op streams into one blob
  ops/prologue.py      blob -> (ops, resid) on the device: the prologue
                       kernel's wrapper (ops/prologue_kernels.py,
                       csrc/prologue.cu K5: each block gathers its
                       nonzeros, runs the IDCT pre-pass and widens the op
                       rows) or, on the CPU, the plain versions
  ops/residuals.py     IDCT pre-pass of dense rows: K4's wrapper, and its
                       plain version _residuals
  ops/executor.py      the executor kernel's wrapper (csrc/gop_executor.cu);
                       ops/executor_ref.py is its plain PyTorch version
  state.py             reference-ring layout and the kernel's intra tables
  models/pipeline.py   the wavefront engine: WavefrontVideoDecoder, one
                       frame as MC, residuals and intra dependency levels,
                       decode_gop a GOP: on the card one launch of K6
                       (ops/wavefront_kernels.py, csrc/wavefront.cu), on
                       the CPU batched torch
                       (ops/idct.py: its IDCTs)
  parallel/batch.py    BatchVideoDecoder: B streams on the wavefront engine,
                       on one device or split over several
  models/encoder.py    MobiclipEncoder (host), whose motion search takes
                       its full-search SAD volume from ops/mesearch.py:
                       on the card one launch of K7
                       (ops/mesearch_kernels.py, csrc/sad.cu)
  ops/adpcm.py         IMA ADPCM as two scans of clamped-add maps: on the
                       card one launch of K9 (ops/audio_kernels.py,
                       csrc/audio.cu), on the CPU two log-step scans
  ops/audio_lpc.py     FastAudioBatchDecoder: the LPC lattice over channels,
                       on the card one launch of K8 per round
  utils/device.py      the device check every entry point makes (a bare
                       "cuda" resolved to the current device's index)
"""
__version__ = "0.1.0"
