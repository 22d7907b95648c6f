"""Percent of the HBM roofline of ops.masked_scale_fence4 (kernel B6b) in the
profiled dispatches."""

from portbench.core import readers


def read(r):
    return readers.roofline(r, "masked_scale_fence4")
