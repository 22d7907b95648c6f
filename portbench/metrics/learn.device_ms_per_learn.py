"""Device ms of what PearlAgent.learn launched, per learn of the profiled
dispatches."""

from portbench.core import readers


def read(r):
    return readers.device_ms(r, "learn", per="learn")
