"""Percent of the profiled dispatches' wall time in which no operation ran on
the device."""

from portbench.core import readers


def read(r):
    return readers.idle_share(r)
