"""Share of the traced stretch in which no kernel, copy or fill ran on
the card (%). Moves qc_gbps."""

from ._lib import idle_pct


def read(ctx):
    return idle_pct(ctx)
