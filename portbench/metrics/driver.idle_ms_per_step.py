"""Device-idle ms of the traced phase's device-only profile while the host
was in the driver's own spans, per vector step."""

from portbench.core import program


def read(r):
    return program.idle_ms(r, "driver", "step")
