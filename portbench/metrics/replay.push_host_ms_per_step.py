"""Host ms in `replay.push` (the replay's column and frame writes) per
vector step of the traced phase."""

from portbench.core import program


def read(r):
    return program.span_ms(r, "replay.push", "step")
