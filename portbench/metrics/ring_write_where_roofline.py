"""Percent of the HBM roofline of ops.ring_write_where (kernel B7) in the
profiled dispatches."""

from portbench.core import readers


def read(r):
    return readers.roofline(r, "ring_write_where")
