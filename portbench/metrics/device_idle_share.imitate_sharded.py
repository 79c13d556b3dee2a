"""Percent of the traced window in which no operation ran on a card, the mean
over the cell's cards of each card's own share (the gaps in the union of its
kernels' intervals)."""
from portbench.lib.trace import idle_share


def read(run):
    return idle_share(run)
