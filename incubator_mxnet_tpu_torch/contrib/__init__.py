"""Contrib namespace (ref: python/mxnet/contrib/). The port has
``quantization``; the reference's other contrib modules are ROADMAP.md
A4/A5/A11."""
from . import quantization

__all__ = ["quantization"]
