"""Codec constant tables.

All tables are extracted from the reference sources by tools/extract_tables.py
and stored as a compressed .npz (see that script for provenance and the exact
reference file:line of every table).  Access them via the module-level
``TABLES`` mapping or the ``get`` helper.
"""
from pathlib import Path
import numpy as np

_NPZ = Path(__file__).parent / "mobiclip_tables.npz"

_cache: dict[str, np.ndarray] | None = None


def _load() -> dict[str, np.ndarray]:
    global _cache
    if _cache is None:
        with np.load(_NPZ) as z:
            _cache = {k: z[k] for k in z.files}
    return _cache


def get(name: str) -> np.ndarray:
    """Return a codec table by semantic name (see tools/extract_tables.py)."""
    return _load()[name]


class _Tables:
    def __getattr__(self, name: str) -> np.ndarray:
        try:
            return _load()[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name: str) -> np.ndarray:
        return _load()[name]

    def keys(self):
        return _load().keys()


TABLES = _Tables()
