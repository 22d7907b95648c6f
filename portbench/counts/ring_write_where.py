"""Bytes of `ring_write_where(ring, obs, reset, done, cursor)`: per env the
one source row its `done` selects is read and one ring row written, and
`done` is read (a byte an env)."""


def nbytes(args, kwargs) -> int:
    ring, obs = args[0], args[1]
    B, _, F = ring.shape
    return 2 * B * F * ring.element_size() + B
