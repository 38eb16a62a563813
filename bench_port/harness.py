"""One run of one cell: corpus, set-up, window, trace, check, result line.

Names lead to files (all under bench_port/):

* a cell `<cell>`: workloads/<cell>.json, naming its configuration and
  traffic mix (and mirrored in BENCHMARK.json's `workloads`);
* a configuration `<config>`: configs/<config>.json (its sizes, source,
  `assumed` and `reduced`) and its generator gen/<config>.py;
* a traffic mix `<traffic>`: traffic/<traffic>.json, naming the route and
  its parameters;
* a route `<route>`: routes/<route>.py (the entry driven) and its plain
  reference reference/<route>.py;
* a metric `<name>`: end_to_end/<name>.py or metrics/<name>.py, each with
  `read(ctx)`; BENCHMARK.json says which cells report it.

The window is a closed loop of one client: whole requests back to back on
the warm corpus file, from the first timed request's start to the first
completion at or after `seconds`; a rate is the work completed over that
time. With `trace`, the window's first two requests run under
torch.profiler (the traced stretch), and the process's CPU time is taken
over the others.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no run may load
BARRED = ("jax", "jaxlib", "flax", "blazeseq_tpu")
TRACED_REQUESTS = 2


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """bench_port/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(ROOT, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    key = "bench_port.%s.%s" % (kind, name.replace(".", "__"))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: str
    route: str
    params: dict
    chips: int

    @classmethod
    def load(cls, name: str) -> "Cell":
        w = load_json("workloads", name + ".json")
        t = load_json("traffic", w["traffic"] + ".json")
        return cls(name=name, config=load_json("configs", w["config"] + ".json"),
                   traffic=w["traffic"], route=t["route"], params=t["params"],
                   chips=int(w["chips"]))


def metrics_of(cell: str, section: str) -> list:
    """BENCHMARK.json's metrics of `section` that this cell reports."""
    return [m for m in benchmark()[section]
            if "workloads" not in m or cell in m["workloads"]]


def barred_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BARRED)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    """The card's name, power limit and largest SM clock, as nvidia-smi
    reads them (empty without it)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


@dataclass
class Window:
    """What the timed requests did."""

    t0: float = 0.0
    t1: float = 0.0
    walls: list = field(default_factory=list)
    work: list = field(default_factory=list)  # a dict a request
    info: list = field(default_factory=list)  # the route's, a request

    def total(self, key: str) -> float:
        return float(sum(w[key] for w in self.work))

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Context:
    """What a metric reader may read."""

    cell: Cell
    corpus: object
    device: object
    setup_s: float
    window: Window
    trace: object = None  # devtrace.Summary of the traced stretch
    traced: list = field(default_factory=list)  # its requests' indices
    launches: dict = field(default_factory=dict)  # deltas over it
    rusage: dict = field(default_factory=dict)  # over the other requests
    cache: dict = field(default_factory=dict)  # for readers to share

    def traced_work(self, key: str) -> float:
        return float(sum(self.window.work[i][key] for i in self.traced))


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start=None, reads=None, log=None) -> dict:
    """One run; returns the result line's object. `reads` (tests only)
    cuts the corpus; `log` takes the earlier stderr lines."""
    t_start = time.time() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = Cell.load(cell_name)
    dev = torch.device(device)
    t_context = time.time()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the context, in set-up
    phases = [("imports", t_context - t_start),
              ("CUDA context", time.time() - t_context)]
    gen = load_module("gen", cell.config["name"])
    t = time.time()
    corpus = gen.generate(cell.config, seed, dev, reads=reads)
    sync(dev)
    gen_s = time.time() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log("corpus: %d reads, %d bytes, made in %.3f s (not in setup_s); "
        "planted %s" % (corpus.reads, corpus.nbytes, gen_s,
                        json.dumps(corpus.planted)))

    try:
        return _measure(cell, corpus, dev, seed, seconds, trace,
                        t_start, gen_s, phases, log)
    finally:
        corpus.file.close()


def _measure(cell, corpus, dev, seed, seconds, trace, t_start, gen_s,
             phases, log) -> dict:
    from . import devtrace

    t0 = time.time()
    route = load_module("routes", cell.route).Route(cell, corpus, dev, seed)
    route.setup()
    t1 = time.time()
    route.request(0, keep=False)  # the warm-up: every shape the window uses
    sync(dev)
    t_first = time.time()
    setup_s = t_first - t_start - gen_s
    phases += [("entry set-up", t1 - t0), ("warm-up request", t_first - t1)]
    log("setup_s %.3f: %s" % (setup_s, ", ".join(
        "%s %.3f" % p for p in phases)))

    win = Window()
    ctx = Context(cell=cell, corpus=corpus, device=dev, setup_s=setup_s,
                  window=win)
    prof = devtrace.Stretch() if trace else None
    before = cpu0 = None
    win.t0 = time.time()
    i = 0
    while True:
        if prof is not None and i == 0:
            before = route.launches()
            prof.start()
        if prof is not None and i == TRACED_REQUESTS:
            cpu0 = _cpu_seconds()
        r0 = time.time()
        with torch.profiler.record_function("bench.request"):
            work, info = route.request(i + 1, keep=True)
        r1 = time.time()
        win.walls.append(r1 - r0)
        win.work.append(work)
        win.info.append(info)
        i += 1
        if prof is not None and i == TRACED_REQUESTS:
            prof.stop()
            after = route.launches()
            ctx.launches = {k: after[k] - before.get(k, 0) for k in after}
            ctx.traced = list(range(TRACED_REQUESTS))
        if (r1 - win.t0 >= seconds and i >= route.min_requests
                and (prof is None or i > TRACED_REQUESTS)):
            break
    win.t1 = time.time()
    if prof is not None:
        untraced = range(TRACED_REQUESTS, i)
        ctx.rusage = dict(cpu_s=_cpu_seconds() - cpu0,
                          requests=len(untraced),
                          bytes=sum(win.work[k]["bytes"] for k in untraced),
                          reads=sum(win.work[k]["reads"] for k in untraced))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    answers = route.answers()
    route.close()
    del route
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log("window: %d requests in %.3f s; request wall median %.4f s, max "
        "%.4f s; walls %s; per request %s" % (
            len(win.walls), win.seconds, statistics.median(win.walls),
            max(win.walls), " ".join("%.3f" % w for w in win.walls),
            json.dumps(win.info[:1] + (
                [] if all(x == win.info[0] for x in win.info)
                else win.info[1:]))))
    if prof is not None:
        ctx.trace = prof.summary()
        log("traced stretch: %d requests, %.3f s, device busy %.3f s; "
            "launches %s" % (len(ctx.traced), ctx.trace.window_s,
                             ctx.trace.busy_s, json.dumps(
                                 {k: v for k, v in ctx.launches.items()
                                  if v})))
    t = time.time()
    ref = load_module("reference", cell.route)
    want = ref.expected(corpus, cell.config, cell.params, dev)
    compared = ref.judge(answers, want)
    log("reference: %.3f s (not in setup_s)" % (time.time() - t))

    section = "per_layer" if trace else "end_to_end"
    readers = "metrics" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(cell.name, section):
        v = load_module(readers, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(v <= lim for v, lim in compared.values())
    failed = int(compared["requests_wrong"][0])
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=cell.chips, memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=len(win.walls),
                  failed=failed, metrics=metrics, device=device_info)
    if trace and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    if dev.type == "cuda":
        log("card: %s" % card_line())
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log("compared %s %s limit %s" % (k, v, lim))
    return result
