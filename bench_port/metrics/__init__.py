"""Per-layer metric readers, one module a metric (metrics/<name>.py), each
with `read(ctx) -> float | None`; None leaves the metric out of the line."""
