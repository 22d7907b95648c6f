"""Kernels written by hand for Hopper, each beside its plain PyTorch version."""

from pearl_tpu_torch.ops.conv_cache import cache_write, cache_write_reference, gather_sum
from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_from_module, fused_mlp_reference
from pearl_tpu_torch.ops.layout_fence import (
    copy_fence,
    copy_fence_reference,
    masked_scale_fence,
    masked_scale_fence4,
    masked_scale_fence4_reference,
    masked_scale_fence_reference,
)
from pearl_tpu_torch.ops.ring_conv import ring_conv1, ring_conv1_reference, ring_conv_applicable
from pearl_tpu_torch.ops.ring_write import (
    ring_write,
    ring_write_reference,
    ring_write_where,
    ring_write_where_reference,
)
from pearl_tpu_torch.ops.synthetic_frames import synthetic_frames, synthetic_frames_reference

__all__ = [
    "cache_write",
    "cache_write_reference",
    "copy_fence",
    "copy_fence_reference",
    "fused_mlp",
    "fused_mlp_from_module",
    "fused_mlp_reference",
    "gather_sum",
    "masked_scale_fence",
    "masked_scale_fence4",
    "masked_scale_fence4_reference",
    "masked_scale_fence_reference",
    "ring_conv1",
    "ring_conv1_reference",
    "ring_conv_applicable",
    "ring_write",
    "ring_write_reference",
    "ring_write_where",
    "ring_write_where_reference",
    "synthetic_frames",
    "synthetic_frames_reference",
]
