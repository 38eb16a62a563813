"""Share of the traced stretch in which no kernel, copy or fill ran on
the card (%). Moves cli_reads_per_s."""

from ._lib import idle_pct


def read(ctx):
    return idle_pct(ctx)
