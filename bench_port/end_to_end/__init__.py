"""End-to-end metric readers, one module a metric (end_to_end/<name>.py),
each with `read(ctx) -> float | None` over the window's host clock."""
