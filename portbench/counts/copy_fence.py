"""Bytes of `copy_fence(x)`: x (B, F) read once, its copy written once."""


def nbytes(args, kwargs) -> int:
    x = args[0]
    return 2 * x.numel() * x.element_size()
