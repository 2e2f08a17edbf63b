"""CLI of the port:

    python -m mobiclipdecoder_tpu_torch decode <in> <out_prefix> [--engine E]
    python -m mobiclipdecoder_tpu_torch info <in>
    python -m mobiclipdecoder_tpu_torch play <in> [--no-pacing]
    python -m mobiclipdecoder_tpu_torch batch <inputs...> <out_dir>
    python -m mobiclipdecoder_tpu_torch encode <in.y4m> <out.moflex>

The flags and the JSON stats are those of ``python -m mobiclipdecoder_tpu``.
The engines of ``decode`` and ``play`` are ``cuda`` (the default: the CUDA
executor, which needs a GPU and raises without one), ``cpu`` (the same
decoder with the plain PyTorch executor), ``wavefront`` (the wavefront
engine on the GPU, the JAX package's ``tpu-xla``; raises without one),
``wavefront-cpu`` (the same on the CPU) and ``oracle``; ``batch`` takes
``cuda``, ``cpu`` and ``oracle``.  ``encode`` runs its motion search's SAD
volume on ``--device`` (``cuda`` by default, which raises without a GPU).
"""
import argparse
import json
import sys
import time

from .parallel.distributed import run_worker
from .runtime.transcode import (BATCH_ENGINES, ENGINES, encode_y4m_to_moflex,
                                play, probe_info, transcode)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mobiclipdecoder_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode a container file to raw A/V")
    d.add_argument("input")
    d.add_argument("out_prefix")
    d.add_argument("--engine", choices=ENGINES, default="cuda")
    d.add_argument("--format", choices=["y4m", "avi"], default="y4m",
                   help="avi = uncompressed RGB AVI like the reference "
                        "converter; y4m = raw codec-native YUV + wav")
    i = sub.add_parser("info", help="probe a container header (no decode)")
    i.add_argument("input")
    pl = sub.add_parser("play", help="headless paced playback with timing "
                                     "stats (the GUI player's decode loop)")
    pl.add_argument("input")
    pl.add_argument("--engine", choices=ENGINES, default="cuda")
    pl.add_argument("--no-pacing", action="store_true",
                    help="decode as fast as possible (benchmark mode)")
    pl.add_argument("--dump-frame", type=int, default=None,
                    help="write RGB frame N as PPM")
    pl.add_argument("--dump-path", default=None)
    pl.add_argument("--pipe-y4m", default=None, metavar="DEST",
                    help="stream paced display frames as YUV4MPEG2 to a "
                         "path/FIFO or '-' (stdout)")
    pl.add_argument("--pipe-wav", default=None, metavar="DEST",
                    help="stream decoded PCM as WAV alongside")
    b = sub.add_parser("batch", help="corpus decode: shard files into GOPs"
                                     " and decode them lockstep-batched; "
                                     "idempotent (ledger-resumable)")
    b.add_argument("inputs", nargs="+",
                   help="MODS/Moflex/MOC5 container files")
    b.add_argument("out_dir")
    b.add_argument("--engine", choices=BATCH_ENGINES, default="cuda")
    b.add_argument("--worker-id", type=int, default=0)
    b.add_argument("--n-workers", type=int, default=1)
    b.add_argument("--batch", type=int, default=8,
                   help="streams decoded per executor launch")
    e = sub.add_parser("encode", help="encode a .y4m file to a .moflex")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--qp", type=int, default=0x16)
    e.add_argument("--gop", type=int, default=30)
    e.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the motion search's SAD volume runs")
    args = p.parse_args(argv)
    if args.cmd == "decode":
        t0 = time.perf_counter()
        stats = transcode(args.input, args.out_prefix, engine=args.engine,
                          fmt=args.format)
        stats["seconds"] = round(time.perf_counter() - t0, 3)
        stats["fps"] = round(stats["frames"] / max(stats["seconds"], 1e-9), 2)
        print(json.dumps(stats))
    elif args.cmd == "info":
        print(json.dumps(probe_info(args.input)))
    elif args.cmd == "play":
        if args.pipe_y4m == "-" and args.pipe_wav == "-":
            p.error("--pipe-y4m and --pipe-wav cannot both be '-': "
                    "the interleaved streams would corrupt each other")
        stats = play(args.input, engine=args.engine,
                     realtime=not args.no_pacing,
                     dump_frame=args.dump_frame, dump_path=args.dump_path,
                     pipe_y4m=args.pipe_y4m, pipe_wav=args.pipe_wav)
        # keep stdout clean when either A/V stream rides it
        out = (sys.stderr if "-" in (args.pipe_y4m, args.pipe_wav)
               else sys.stdout)
        print(json.dumps(stats), file=out)
    elif args.cmd == "batch":
        t0 = time.perf_counter()
        stats = run_worker(args.inputs, args.out_dir,
                           worker_id=args.worker_id,
                           n_workers=args.n_workers,
                           engine=args.engine, batch=args.batch)
        stats["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(stats))
    elif args.cmd == "encode":
        t0 = time.perf_counter()
        stats = encode_y4m_to_moflex(args.input, args.output, qp=args.qp,
                                     gop=args.gop, device=args.device)
        stats["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
