"""Percent of the chip's peak: the networks' operations of every act and learn
in the window over the window (readers.mfu)."""

from portbench.core import readers


def read(r):
    return readers.mfu(r)
