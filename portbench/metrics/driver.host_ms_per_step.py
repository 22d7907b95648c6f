"""The driver's own host ms per vector step in the traced phase: `driver.call`
and `driver.dispatch` with their children's time taken out (episode
accounting, the call's set-up, the loop)."""

from portbench.core import program


def read(r):
    return program.driver_self_ms_per_step(r)
