"""Percent of the HBM roofline of ops.synthetic_frames (the env's frames of
a vector step) in the profiled dispatches."""

from portbench.core import readers


def read(r):
    return readers.roofline(r, "synthetic_frames")
