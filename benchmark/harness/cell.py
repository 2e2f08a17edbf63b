"""What the drivers share: the run's context, the sample of answers kept
for the check, and the compared numbers.

A driver (``benchmark/drivers/<name>.py``) is a module with

* ``prepare(ctx) -> state``: make the inputs from the seed, build the
  program and warm up every shape the window will use (set-up);
* ``window(ctx, state, seconds) -> Window``: drive the program for
  ``seconds`` of host time, a closed loop, and finish what it started;
* ``release(state)``: drop the program's state before the reference runs;
* ``reference(ctx, state) -> ref``: decode the same inputs with the plain
  reference, in the process pool, with the frozen work counts;
* ``checks(ctx, state, win, ref) -> list[Check]``: the compared numbers;
* ``work(ctx, state, win, ref) -> dict``: the frozen counts of what the
  window's program work had to move (``k1_bytes``, ``k5_bytes``).
"""
from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass
class Context:
    seed: int
    cell: object            # harness.spec.Cell
    device: str             # "cuda"; the CPU tests pass "cpu"
    pool: object            # a multiprocessing pool for inputs and reference

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Window:
    """What a window did: items are GOPs or files."""
    attempted: int = 0
    delivered: int = 0
    failed: int = 0
    frames: int = 0
    elapsed_s: float = 0.0
    latency_s: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)  # (index, answer)
    indices: list = dataclasses.field(default_factory=list)  # item -> input
    done: list = dataclasses.field(default_factory=list)  # inputs delivered
    finished_s: list = dataclasses.field(default_factory=list)  # since start


@dataclasses.dataclass
class Check:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Reservoir:
    """A uniform sample of at most ``k`` of the window's answers, drawn
    from the seed (reservoir sampling).  ``take(i)`` decides, when item i
    is sent, whether its answer is to be kept; ``keep(i, answer)`` keeps
    it when it comes, so answers not chosen are never held."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(int(seed) * 2 + 1)
        self.k = k
        self.kept: dict[int, tuple] = {}
        self.chosen: dict[int, int] = {}

    def take(self, i: int) -> bool:
        slot = i if i < self.k else self.rng.randrange(i + 1)
        if slot < self.k:
            self.chosen[i] = slot
        return slot < self.k

    def keep(self, i: int, answer) -> None:
        slot = self.chosen.pop(i, None)
        if slot is not None:
            self.kept[slot] = (i, answer)

    def items(self) -> list:
        return sorted(self.kept.values(), key=lambda ia: ia[0])


def differing(got, want) -> int:
    """Samples of ``want`` that ``got`` does not equal; all of them when
    the shapes differ or there is no answer."""
    import numpy as np
    if want is None:
        return 0 if got is None else int(np.asarray(got).size)
    if got is None or np.shape(got) != np.shape(want):
        return int(np.asarray(want).size)
    return int(np.count_nonzero(np.asarray(got) != np.asarray(want)))


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader reads: the window's trace and the
    frozen counts of its work (``frames``, ``k1_bytes``, ``k5_bytes``)."""
    trace: object           # harness.trace.Trace
    work: dict
