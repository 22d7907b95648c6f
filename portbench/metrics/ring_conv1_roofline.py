"""Percent of the roofline of ops.ring_conv1 (kernel B5) in the profiled
dispatches."""

from portbench.core import readers


def read(r):
    return readers.roofline(r, "ring_conv1")
