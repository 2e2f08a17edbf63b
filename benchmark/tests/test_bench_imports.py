"""No file of the benchmark loads JAX or the JAX package, and the frozen
generator and reference load nothing of the program either.  Top-level
module names are compared whole: the program's name begins with the JAX
package's."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mobiclipdecoder_tpu"}
PROGRAM = "mobiclipdecoder_tpu_torch"
FILES = sorted(HERE.rglob("*.py"))


def top_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_every_file_is_scanned():
    names = {p.relative_to(HERE).as_posix() for p in FILES}
    assert {"run.py", "reference/oracle_video.py", "gen/synth.py",
            "harness/work.py", "drivers/corpus.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.relative_to(HERE).parts[0]
             in ("gen", "reference")], ids=lambda p: str(p.relative_to(HERE)))
def test_frozen_code_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_names(path)
    assert "benchmark" not in top_names(path) or path.name == "decode.py"


def test_a_prefix_match_would_be_wrong():
    """The program's own name shares the JAX package's prefix; only a
    whole-name comparison keeps it out of the forbidden set."""
    assert PROGRAM.startswith("mobiclipdecoder_tpu")
    assert PROGRAM.split(".")[0] not in FORBIDDEN
