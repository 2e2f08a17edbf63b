"""Static formula LUTs for the directional intra prediction modes.

Every non-plane intra mode's output pixel is one of: a copy of a neighbor tap,
a 2-tap rounded average `(a+b+1)>>1`, a 3-tap filter `(a+2b+c+2)>>2`, the DC
value, or a pass-through.  This module bakes, for each (mode, pixel), the
formula kind and up to three tap indices into dense arrays, so the device
kernel is a branchless gather + select over a batch of blocks
(mirrors PredictIntra, MobiclipDecoder.cs:1883-2773; formulas derived and
oracle-verified in models/oracle_video.py).

Tap vector layout (33 entries, shared by 4x4 / 8x8 / 16x16 ops):
  [0]      corner (top-left neighbor pixel)
  [1..16]  t[0..15]: the row above the block, extending right (vertical-left
           modes legitimately read past the block edge)
  [17..32] l[0..15]: the column left of the block

Kinds: 0 COPY(i1) | 1 AVG2(i1,i2) | 2 AVG3(i1, mid=i2, i3) | 3 DC | 4 PASS.
Modes 2/12 (+ the 16x16 plane op) use the closed-form plane path instead.
"""
from __future__ import annotations

import numpy as np

COPY, AVG2, AVG3, DC, PASS = 0, 1, 2, 3, 4

C = 0


def T(k: int) -> int:
    assert 0 <= k <= 15
    return 1 + k


def L(k: int) -> int:
    assert 0 <= k <= 15
    return 17 + k


def _formula(m: int, n: int, y: int, x: int):
    """Return (kind, i1, i2, i3) for base mode m (0-9) at pixel (y, x)."""
    if m == 0:
        return (COPY, T(x), 0, 0)
    if m == 1:
        return (COPY, L(y), 0, 0)
    if m == 3:
        return (DC, 0, 0, 0)
    if m == 4:  # horizontal-up
        z = x + 2 * y
        if z >= 2 * n - 2:
            return (COPY, L(n - 1), 0, 0)
        k = z >> 1
        if z & 1:
            return (AVG3, L(k), L(k + 1), L(min(k + 2, n - 1)))
        return (AVG2, L(k), L(k + 1), 0)
    if m == 5:  # horizontal-down
        d = 2 * y - x

        def e(j):
            return C if j == 0 else L(j - 1)
        if d >= 0:
            if d & 1:
                if d >= 3:
                    k = (d - 1) >> 1
                    return (AVG3, e(k), e(k + 1), e(k + 2))
                return (AVG3, T(0), C, L(0))
            k = d >> 1
            return (AVG2, e(k), e(k + 1), 0)
        q = x - 2 * y

        def u(k):
            if k >= 0:
                return T(k)
            return C if k == -1 else L(0)
        return (AVG3, u(q - 3), u(q - 2), u(q - 1))
    if m == 6:  # vertical-right
        d = 2 * x - y

        def v(k):
            return T(k) if k >= 0 else C
        if d >= 0:
            k = x - (y >> 1)
            if d & 1:
                return (AVG3, v(k - 2), v(k - 1), v(k))
            return (AVG2, v(k - 1), v(k), 0)
        if d == -1:
            return (AVG3, L(0), C, T(0))
        mm = -d - 2
        lo = C if mm == 0 else L(mm - 1)
        return (AVG3, lo, L(mm), L(mm + 1))
    if m == 7:  # diagonal down-right
        d = x - y

        def tt(k):
            return T(k) if k >= 0 else C

        def ll(k):
            return L(k) if k >= 0 else C
        if d > 0:
            return (AVG3, tt(d - 2), tt(d - 1), tt(d))
        if d == 0:
            return (AVG3, L(0), C, T(0))
        return (AVG3, ll(-d - 2), ll(-d - 1), ll(-d))
    if m == 8:  # vertical-left
        if y & 1:
            k = x + ((y - 1) >> 1)
            return (AVG3, T(k), T(k + 1), T(k + 2))
        k = x + (y >> 1)
        return (AVG2, T(k), T(k + 1), 0)
    return (PASS, 0, 0, 0)  # modes 2 (plane, special-cased) and 9


def build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Return (kind, taps) of shapes (20, 256) and (20, 256, 3).

    Pixel index is r*16+c on a 16x16 tile; for modes with n < 16 only the
    top-left n x n entries are meaningful (the engine masks by size).
    """
    kind = np.full((20, 256), PASS, dtype=np.int32)
    taps = np.zeros((20, 256, 3), dtype=np.int32)
    for mode in range(20):
        n = 8 if mode < 10 else 4
        m = mode % 10
        if m == 2:
            continue  # plane: closed-form path
        for y in range(n):
            for x in range(n):
                k, i1, i2, i3 = _formula(m, n, y, x)
                kind[mode, y * 16 + x] = k
                taps[mode, y * 16 + x] = (i1, i2, i3)
    return kind, taps


KIND, TAPS = build_tables()
