"""Operators of the PyTorch port."""
import torch

__all__ = ["device_vector", "matmul_promoted"]


def device_vector(values, dtype, device):
    """``torch.tensor(values, dtype=dtype, device=device)`` for a flat list
    of Python numbers, made by fills on the device: no copy from host
    memory, so a CUDA graph capture may run it (``cuda_graph``)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i:i + 1].fill_(v)
    return out


def matmul_promoted(a, b):
    """``a @ b`` in the promotion of both types, as ``jnp.matmul`` computes
    it (torch.matmul refuses mixed types): in a bf16 model, the float32
    output of an MoE layer meets the bf16 weights after it. Casts nothing
    when the types already agree."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
