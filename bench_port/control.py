"""The readings that the limits of `correct` are set from, at a cell's own
size (not run by the benchmark's runs):

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's corpus, runs the cell's entry once (the
program), computes the exact reference, and the control: the reference put
in the program's place in the nearest precision below the one the
configuration states. The configurations state exact counts (int64); the
control for the QC routes adds each block's counts into float32 totals,
and for the trim command sums each window's raw quality bytes in 8-bit
lanes, as a byte-wise kernel that never widens would. It prints one JSON
line a seed with each compared number, the program's and the control's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch


def readings(cell_name: str, seed: int, device, reads=None) -> dict:
    from bench_port import harness

    cell = harness.Cell.load(cell_name)
    gen = harness.load_module("gen", cell.config["name"])
    ref = harness.load_module("reference", cell.route)
    corpus = gen.generate(cell.config, seed, device, reads=reads)
    route = harness.load_module("routes", cell.route).Route(
        cell, corpus, device, seed)
    route.setup()
    # the request whose output a route keeps (the CLI's is drawn)
    route.request(getattr(route, "kept_index", 1), keep=True)
    answers = route.answers()
    route.close()
    del route
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.expected(corpus, cell.config, cell.params, device)
    program = ref.judge(answers, want)
    control = ref.judge(control_answers(cell, corpus, device, ref), want)
    corpus.file.close()
    return dict(seed=seed, program={k: v for k, (v, _) in program.items()},
                control={k: v for k, (v, _) in control.items()})


def control_answers(cell, corpus, device, ref) -> list:
    """The control's answers, in the form the route's answers take."""
    if cell.route == "cli":
        low = ref.expected(corpus, cell.config, cell.params, device,
                           raw_uint8=True)
        r, k, b_in, b_out = low["counts"]
        line = "x\treads %d -> kept %d\tbases %d -> %d\n" % (r, k, b_in, b_out)
        return [dict(stdout=line, output=low["bytes"])]
    low = ref.expected(corpus, cell.config, cell.params, device,
                       dtype=torch.float32)
    return [Report(low)]


class Report:
    """A reference dict read as the port's report (its attributes)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)
        ads = d.get("adapters")
        if ads is not None:
            self.adapter_stats = {a: _Stats(*v) for a, v in ads.items()}


class _Stats:
    def __init__(self, first, hits, scanned):
        self.first_occurrence = first
        self.reads_with_adapter = hits
        self.reads_scanned = scanned


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for s in args.seeds.split(","):
        t = time.time()
        r = readings(args.workload, int(s), dev)
        r["seconds"] = time.time() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
