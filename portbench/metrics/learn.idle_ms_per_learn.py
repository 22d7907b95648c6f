"""Device-idle ms of the traced phase's device-only profile while the host
was in `agent.learn` (replay sample and update), per learn."""

from portbench.core import program


def read(r):
    return program.idle_ms(r, "learn", "learn")
