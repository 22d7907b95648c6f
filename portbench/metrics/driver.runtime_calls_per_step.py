"""CUDA runtime calls that put work on the device (kernel and graph launches,
copies, sets), per vector step of the profiled dispatches."""

from portbench.core import readers


def read(r):
    return readers.runtime_calls_per_step(r)
