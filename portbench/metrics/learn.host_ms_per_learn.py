"""Host ms inside PearlAgent.learn (replay sample and DQN update) per learn,
over the window."""

from portbench.core import readers


def read(r):
    return readers.host_ms(r, "learn", per="learn")
