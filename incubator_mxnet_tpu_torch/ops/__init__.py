"""Operators of the PyTorch port."""
import torch

__all__ = ["matmul_promoted"]


def matmul_promoted(a, b):
    """``a @ b`` in the promotion of both types, as ``jnp.matmul`` computes
    it (torch.matmul refuses mixed types): in a bf16 model, the float32
    output of an MoE layer meets the bf16 weights after it. Casts nothing
    when the types already agree."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
