"""Device ms of what PearlAgent.observe launched, per vector step of the
profiled dispatches."""

from portbench.core import readers


def read(r):
    return readers.device_ms(r, "observe")
