from pearl_tpu_torch.utils.device import make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import (
    compare,
    soft_update,
    synced_cast,
    tree_allclose,
    tree_map,
    tree_select,
)

__all__ = [
    "compare",
    "make_generator",
    "resolve_device",
    "soft_update",
    "synced_cast",
    "tree_allclose",
    "tree_map",
    "tree_select",
]
