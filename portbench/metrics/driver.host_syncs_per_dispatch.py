"""The program's blocking device-to-host reads per dispatch of the traced
phase (`driver.host_syncs`): the statistics fetch, and any other sync the
program makes inside its spans."""

from portbench.core import program


def read(r):
    return program.host_syncs_per_dispatch(r)
