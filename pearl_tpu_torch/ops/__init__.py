"""Kernels written by hand for Hopper, each beside its plain PyTorch version."""

from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_from_module, fused_mlp_reference
from pearl_tpu_torch.ops.layout_fence import (
    copy_fence,
    copy_fence_reference,
    masked_scale_fence,
    masked_scale_fence4,
    masked_scale_fence4_reference,
    masked_scale_fence_reference,
)
from pearl_tpu_torch.ops.ring_write import (
    ring_write,
    ring_write_reference,
    ring_write_where,
    ring_write_where_reference,
)

__all__ = [
    "copy_fence",
    "copy_fence_reference",
    "fused_mlp",
    "fused_mlp_from_module",
    "fused_mlp_reference",
    "masked_scale_fence",
    "masked_scale_fence4",
    "masked_scale_fence4_reference",
    "masked_scale_fence_reference",
    "ring_write",
    "ring_write_reference",
    "ring_write_where",
    "ring_write_where_reference",
]
