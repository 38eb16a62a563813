"""The benchmark's command:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout that holds blazeseq_tpu_torch. It needs a
CUDA card (and as many as the cell asks for): without one it exits with
code 2 and prints no result. The last line of standard output is the
result's JSON object; standard error ends with each number compared
beside its limit. A run that finds a JAX module or the JAX package loaded
once the window has closed exits with code 3 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from bench_port import harness

    cell = harness.Cell.load(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("no result: the cell needs %d CUDA card(s), this machine has "
              "%d" % (cell.chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    barred = harness.barred_modules()
    if barred:
        print("no result: modules of JAX or the JAX package are loaded: %s"
              % ", ".join(barred), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
