"""The readings that a cell's limits are set from: the numbers that decide
`correct`, from sound runs of the program on many seeds, beside the
control's and the planted faults' readings on the same runs.

    python3 -m slam_bench.readings --workload <cell> --seeds 11,12,13 --seconds 20 \
        [--out <file.jsonl>]

The system is built and warmed up once; each seed is then a session of its
own (`Slam._restart`, the seed's stream, a window of `--seconds` at the
cell's load, the checks with `--control`). One JSON line a seed goes to
standard output (and to `--out`): the sound numbers, each control's and
fault's readings with the verdict they get beside the run's other numbers,
and the window's counts. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    ctx = run.setup(args.workload, "cuda:0")
    slam = ctx.slam
    out = open(args.out, "a") if args.out else None
    for seed in (int(x) for x in args.seeds.split(",")):
        slam._restart()
        ctx.slam = slam
        t0 = time.monotonic()
        res = run.session_run(ctx, seed, args.seconds, False, control=True, free=False)
        verdicts = {name: check.decide(dict(res["_numbers"], **readings), ctx.limits)[0]
                    for name, readings in res["_control"].items()}
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "numbers": res["_numbers"], "controls": res["_control"],
                "control_correct": verdicts, "counts": res["counts"],
                "session_s": time.monotonic() - t0}
        text = json.dumps(run._finite(line))
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        for ln in res["_lines"]:
            print(ln, file=sys.stderr)
    if out:
        out.close()
    bad = run.forbidden_modules()
    if bad:
        print(f"modules that the run may not load were loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
