"""Device-idle ms of the traced phase's device-only profile while the host
was in `agent.observe` (history and replay), per vector step."""

from portbench.core import program


def read(r):
    return program.idle_ms(r, "observe", "step")
