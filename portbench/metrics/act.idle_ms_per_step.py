"""Device-idle ms of the traced phase's device-only profile while the host
was in `agent.act`, per vector step."""

from portbench.core import program


def read(r):
    return program.idle_ms(r, "act", "step")
