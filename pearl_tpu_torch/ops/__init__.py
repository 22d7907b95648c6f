"""Kernels written by hand for Hopper, each beside its plain PyTorch version."""

from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_from_module, fused_mlp_reference

__all__ = ["fused_mlp", "fused_mlp_from_module", "fused_mlp_reference"]
