"""Hand-built GOPs for the port's executor tests, made with the port's own
planner encoding (``pack_unified``) and no JAX, so that the GPU-only tests
can use them on a machine without it.

``edge_plans`` builds frames as wide as their stride, whose ops read and
write at the edges of the working plane: the top-left macroblock's intra
taps read the top and left margins; the top-right taps of the right-most
luma and V blocks run into the pad columns past MCOL + S; the left taps of
the bottom chroma blocks run into the slack rows below the plane; MC
windows sit at the clamped bottom row group, cross column 0 (wrapping to
the pad) and cross column SP (wrapping to the left margin).
"""
import numpy as np

from mobiclipdecoder_tpu_torch.models.plan import pack_unified

MODES8 = (0, 1, 3, 4, 5, 6, 7, 8)
MODES4 = (10, 11, 13, 14, 15, 16, 17, 18)
# (width, height, stride): frames as wide as their stride, at each stride
EDGE = {"edge_s256": (256, 48, 256), "edge_s512": (512, 32, 512),
        "edge_s1024": (1024, 32, 1024)}


def coef(rng, n):
    c = np.zeros((n, n), np.int32)
    k = rng.integers(1, 6)
    c.flat[rng.choice(n * n, k, replace=False)] = rng.integers(-90, 90, k)
    return c


def _maybe(rng, n, p=0.5):
    return (coef(rng, n), 0) if rng.random() < p else None


def edge_frame(rng, f, w, h, s):
    ops = []
    half = s // 2
    xs, ys = range(0, w, 16), range(0, h, 16)
    for my in ys:
        for mx in xs:
            cy, cx = my // 2, mx // 2
            if f > 0 and rng.random() < 0.6:
                dx, dy = (int(v) for v in rng.integers(-20, 20, 2))
                if my == ys[-1]:
                    dy = 4 * h + 1          # below the clamped row group
                if mx == 0:
                    dx = -2 * (mx + 24) - 1     # across column 0
                elif mx == xs[-1]:
                    dx = 2 * (s + 112 - mx) + 1     # across column SP
                ops.append(("mc", 16, 16, int(rng.integers(1, 6)), dx, dy,
                            my * s + mx))
                for q in range(4):
                    if rng.random() < 0.5:
                        ops.append(("resid", 0, my + 8 * (q >> 1),
                                    mx + 8 * (q & 1), 8, (coef(rng, 8), 0)))
                for x in (cx, cx + half):
                    if rng.random() < 0.6:
                        ops.append(("resid", 1, cy, x, 8, (coef(rng, 8), 0)))
                continue
            kind = int(rng.integers(0, 3))
            if kind == 0:                       # 8x8 quad batch
                for q in range(4):
                    ops.append(("intra", 0, my + 8 * (q >> 1),
                                mx + 8 * (q & 1), 8,
                                int(rng.choice(MODES8)), 0, _maybe(rng, 8)))
            elif kind == 1:                     # 4x4 quad batches
                for q8 in range(4):
                    by, bx = my + 8 * (q8 >> 1), mx + 8 * (q8 & 1)
                    for q in range(4):
                        ops.append(("intra", 0, by + 4 * (q >> 1),
                                    bx + 4 * (q & 1), 4,
                                    int(rng.choice(MODES4)), 0,
                                    _maybe(rng, 4)))
            else:                               # plane16
                ops.append(("intra", 0, my, mx, 16, 2,
                            int(rng.integers(-120, 120)), None))
            mode = int(rng.choice(MODES8))      # chroma U+V intra pair
            for x in (cx, cx + half):
                ops.append(("intra", 1, cy, x, 8, mode, 0, _maybe(rng, 8)))
    return pack_unified(ops, s, h)


def edge_plans(seed, w, h, s, nstreams, nframes):
    """plans[f][b] of hand-built edge frames (frame 0 all intra)."""
    rngs = [np.random.default_rng(seed * 10 + b) for b in range(nstreams)]
    return [[edge_frame(rngs[b], f, w, h, s) for b in range(nstreams)]
            for f in range(nframes)]
