"""Host ms in `replay.sample` (the replay's sample and gather) per learn of
the traced phase."""

from portbench.core import program


def read(r):
    return program.span_ms(r, "replay.sample", "learn")
