"""The JAX package's JAX-free modules, imported without its top-level
``__init__``.

``mobiclipdecoder_tpu/__init__.py`` imports jax to set up its compile
cache, so ``import mobiclipdecoder_tpu.models.plan`` pulls jax in although
plan.py itself never touches it.  This package's search path is the JAX
package's directory: ``mobiclipdecoder_tpu_torch.shared.models.plan`` loads
``mobiclipdecoder_tpu/models/plan.py`` itself (its relative imports resolve
inside this package too), and of the JAX package's ``__init__`` files only
the empty sub-package ones run.  The port shares these modules this way,
and only these, since none of them imports jax:

    models.oracle_video, models.plan, models.coefvlc, utils.native,
    utils.bitio, ops.intra_tables, testing.synth, runtime.metrics, tables,
    containers.mods, containers.moflex, containers.moc5, containers.vx,
    models.audio_ima, models.audio_sx, models.audio_fastaudio,
    utils.rawio, utils.avi, runtime.transcode, parallel.gop,
    parallel.distributed

``runtime.transcode`` reaches the JAX engines only through its decoder
factory, which the port replaces (``mobiclipdecoder_tpu_torch/runtime/
transcode.py``); ``parallel.distributed`` imports jax only inside
``init_distributed``, which the port does not call.
``tests/test_torch_engine.py`` checks in a fresh interpreter that
importing the port leaves jax unimported.
"""
from pathlib import Path

__path__ = [str(Path(__file__).resolve().parents[2] / "mobiclipdecoder_tpu")]
