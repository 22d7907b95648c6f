from pearl_tpu_torch.utils.device import make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import soft_update, synced_cast, tree_map, tree_select

__all__ = [
    "make_generator",
    "resolve_device",
    "soft_update",
    "synced_cast",
    "tree_map",
    "tree_select",
]
