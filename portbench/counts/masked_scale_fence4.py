"""Bytes of `masked_scale_fence4(ring, valid, H=, W=)`: the (B, T, F) ring
and the (B, T) mask read once, the (B, T, H, W) output written once in the
ring's dtype."""


def nbytes(args, kwargs) -> int:
    ring, valid = args[0], args[1]
    return 2 * ring.numel() * ring.element_size() + valid.numel() * valid.element_size()
