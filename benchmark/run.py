"""The benchmark of mobiclipdecoder_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs``) and a traffic mix (``benchmark/traffic/<name>.json``), whose
driver (``benchmark/drivers/<driver>.py``) runs the program.  One run:

1. set-up: the inputs are made from ``--seed`` in a process pool, the
   program is built and every shape the window uses is warmed up;
2. the window: the driver drives the program for ``--seconds`` (under
   torch.profiler with ``--trace 1``);
3. the check: the plain reference (``benchmark/reference``) decodes the same
   inputs in the pool, and a sample of the window's answers drawn from the
   seed is compared with it;
4. the result: with ``--trace 0`` the cell's end-to-end metrics, taken on
   the host's clock; with ``--trace 1`` its per-layer metrics, read from the
   trace by ``benchmark/metrics/<name>.py``.  The last line of standard
   output is one JSON object; the numbers compared stand beside their
   limits in its last key and in the last lines of standard error.  An
   earlier line, ``[content]``, says what the traffic's frames hold: bytes
   per I- and P-frame, the bit rate, coded blocks per macroblock.

Exits with 2, printing no result, where no CUDA card is visible or fewer
than the cell asks for; with 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded (compared whole: the
#: program's own name begins with the last of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "mobiclipdecoder_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             workers: int | None = None, log=_log) -> dict:
    """One run of ``cell`` on ``device``; returns the result object (with
    its ``timings`` beside it).  ``device`` is "cuda" on the card; the CPU
    tests pass "cpu", where the program runs its plain versions."""
    import multiprocessing

    import torch

    from benchmark.harness import device as hw
    from benchmark.harness import trace as tr
    from benchmark.harness.cell import Context

    age = hw.process_age_s()
    t0 = time.perf_counter()
    on_card = device == "cuda"
    spawn = multiprocessing.get_context("spawn")
    pool = spawn.Pool(workers or os.cpu_count())
    try:
        ctx = Context(seed, cell, device, pool)
        drv = cell.driver
        state = drv.prepare(ctx)
        # no process of the harness's runs beside the window
        pool.close()
        pool.join()
        if on_card:
            torch.cuda.synchronize()
        setup_s = age + time.perf_counter() - t0
        log(f"[setup] {setup_s:.3f} s")
        cpu0, w0 = hw.process_cpu_s(), time.perf_counter()
        if trace:
            from torch.profiler import ProfilerActivity, profile
            from torch.profiler import record_function
            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(tr.WINDOW):
                    win = drv.window(ctx, state, seconds)
                    if on_card:
                        torch.cuda.synchronize()
        else:
            win = drv.window(ctx, state, seconds)
        cores = (hw.process_cpu_s() - cpu0) / (time.perf_counter() - w0)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        drv.release(state)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        trc = tr.reduce(prof.events()) if trace else None
        log(f"[window] {win.delivered} of {win.attempted} delivered, "
            f"{win.frames} frames in {win.elapsed_s:.3f} s; reference ...")
        t_ref = time.perf_counter()
        pool = ctx.pool = spawn.Pool(workers or os.cpu_count())
        ref = drv.reference(ctx, state)
        checks = drv.checks(ctx, state, win, ref)
        log(f"[reference] {time.perf_counter() - t_ref:.3f} s, "
            f"{len(win.samples)} answers compared")
        content = drv.content(ctx, state, ref)
        result = {"correct": bool(win.delivered and win.samples
                                  and all(c.ok for c in checks)),
                  "attempted": win.attempted, "failed": win.failed}
        units = {m["name"]: m["unit"] for m in
                 cell.end_to_end + cell.per_layer}
        if trace:
            from benchmark.harness.cell import MetricContext
            mctx = MetricContext(trc, drv.work(ctx, state, win, ref))
            vals = {}
            for m in cell.per_layer:
                v = cell.reader(m["name"]).read(mctx)
                if v is not None:
                    vals[m["name"]] = v
        else:
            vals = {"setup_s": setup_s, **drv.end_to_end(win)}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in vals.items() if k in units}
        dev = (hw.describe(cell.chips) if on_card else
               {"platform": "cpu", "kind": "cpu", "count": 0})
        dev["memory_peak_bytes"] = int(peak)
        if trace:
            dev["busy_s"] = trc.busy_us() / 1e6
            dev["window_s"] = trc.window_us / 1e6
            result["breakdown"] = tr.breakdown(trc)
        result["device"] = dev
        result["timings"] = drv.timings(win)
        result["content"] = content
        result["timeline"] = _timeline(win, seconds)
        result["process_cores"] = cores
        result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                            for c in checks}
        return result
    finally:
        pool.close()
        pool.join()


def _timeline(win, seconds: float, parts: int = 10) -> list[int]:
    """Items finished in each tenth of the window: where in the window a
    run went slow."""
    out = [0] * parts
    for t in win.finished_s:
        out[min(parts - 1, int(t / seconds * parts))] += 1
    return out


def main(argv=None) -> int:
    args = _parse(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark.harness import spec
    from benchmark.harness.stats import summary
    cell = spec.load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        _log(f"loaded in this process: {', '.join(found)}")
        return 3
    print(f"[timeline] items finished per tenth of the window: "
          f"{result.pop('timeline')}; cores used by this process "
          f"{result.pop('process_cores'):.3f}", flush=True)
    print("[content] the traffic's frames: " + ", ".join(
        f"{k} {v!r}" for k, v in result.pop("content").items()), flush=True)
    for name, vals in result.pop("timings").items():
        if vals:
            s = summary(vals)
            print(f"[timing] {name}: median {s['median']!r} p95 "
                  f"{s['p95']!r} over {s['n']} samples", flush=True)
    for k, v in result["checks"].items():
        _log(f"[check] {k} {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
