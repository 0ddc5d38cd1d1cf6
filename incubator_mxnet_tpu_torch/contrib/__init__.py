"""Contrib namespace (ref: python/mxnet/contrib/). The port has
``quantization`` and ``text``; the reference's other contrib modules are
ROADMAP.md A item 2 (A4/A5) and A11."""
from . import quantization
from . import text

__all__ = ["quantization", "text"]
