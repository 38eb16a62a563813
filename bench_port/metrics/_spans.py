"""What the span and counter readers share: the program tracer's records
of the traced requests (blazeseq_tpu_torch.tracing, whose spans and
counters record only while the profiler runs, so only the traced
requests are there). A program without them gives None."""

from __future__ import annotations


def requests(ctx):
    """The last len(ctx.traced) requests the program's tracer kept, each
    {"spans": {name: {"total_s", "self_s", "calls"}}, "counters": {...}},
    or None when it kept fewer or keeps none."""
    if not ctx.traced:
        return None
    from blazeseq_tpu_torch import tracing

    read = getattr(tracing.global_tracer(), "requests", None)
    if read is None:
        return None
    reqs = read(last=len(ctx.traced))
    return reqs if len(reqs) == len(ctx.traced) else None


def seconds(reqs, *names) -> float:
    """Summed total time of the spans named, over the requests."""
    return float(sum(r["spans"][n]["total_s"] for r in reqs for n in names
                     if n in r["spans"]))


def counted(reqs, name) -> int:
    """Summed counter `name` over the requests."""
    return int(sum(r["counters"].get(name, 0) for r in reqs))


def span_per(ctx, names, per: str, scale: float):
    """The summed time of spans `names` over the traced requests, per unit
    of their work (`per`: "bytes" or "reads"), times `scale`."""
    reqs = requests(ctx)
    work = ctx.traced_work(per) if reqs is not None else 0
    if not work:
        return None
    return seconds(reqs, *names) / work * scale
