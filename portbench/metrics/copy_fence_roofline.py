"""Percent of the HBM roofline of ops.copy_fence (kernel B3) in the profiled
dispatches."""

from portbench.core import readers


def read(r):
    return readers.roofline(r, "copy_fence")
