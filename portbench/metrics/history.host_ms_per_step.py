"""Host ms in `history.advance` (the acting frame's fence and the frame
ring's advance) per vector step of the traced phase."""

from portbench.core import program


def read(r):
    return program.span_ms(r, "history.advance", "step")
