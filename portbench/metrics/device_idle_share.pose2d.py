"""Percent of the traced window in which no operation ran on the device:
the gaps in the union of the kernels' intervals."""
from portbench.lib.trace import idle_share


def read(run):
    return idle_share(run)
