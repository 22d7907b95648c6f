"""Host ms inside PearlAgent.observe (frame ring and replay push) per vector
step, over the window."""

from portbench.core import readers


def read(r):
    return readers.host_ms(r, "observe")
