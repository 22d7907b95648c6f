"""Host ms inside VectorEnv.step per vector step, over the window."""

from portbench.core import readers


def read(r):
    return readers.host_ms(r, "env")
