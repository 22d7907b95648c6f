"""Host ms in `driver.fetch` per dispatch of the traced phase: the host
blocked on the card for a dispatch's statistics."""

from portbench.core import program


def read(r):
    return program.span_ms(r, "driver.fetch", "dispatch")
