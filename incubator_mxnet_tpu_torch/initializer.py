"""Parameter initializers.

Counterpart of ``incubator_mxnet_tpu/initializer.py``: Zero / One /
Constant / Uniform / Normal / Orthogonal / Xavier / MSRAPrelu / Bilinear /
LSTMBias, the string registry, name-convention dispatch, ``Mixed`` and
``Load``. Random draws come from the array's device generator in
``random`` (the reference seeds a host numpy generator from its JAX key),
so ``mx.random.seed`` makes initialisation repeat; the numbers differ from
the reference's.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

from . import random as _random
from .base import registry_get
from .ndarray.ndarray import NDArray

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "Load", "InitDesc", "register", "create", "init"]

_REG = registry_get("initializer")
register = _REG.register
create = _REG.create


class InitDesc(str):
    """Parameter name + attrs used for pattern dispatch."""
    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _draw(kind: str, shape, arr: NDArray) -> torch.Tensor:
    """float32 uniform [0, 1) or standard normal draws on arr's device."""
    dev = arr._data.device
    g = _random.generator(dev)
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(tuple(shape), generator=g, device=dev, dtype=torch.float32)


class Initializer:
    """Base initializer."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr: NDArray) -> None:
        if not isinstance(desc, str):
            desc = str(desc)
        self.init_array(desc, arr)

    # name-convention dispatch (ref: Initializer.__call__ legacy paths)
    def init_array(self, name: str, arr: NDArray) -> None:
        if name.endswith("gamma"):
            self._init_one(arr)
        elif name.endswith("beta") or name.endswith("bias"):
            self._init_zero(arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(arr)
        else:
            self._init_weight(name, arr)

    @staticmethod
    def _set_const(arr, fill):
        arr._set_data(torch.full(arr.shape, fill, dtype=arr._data.dtype,
                                 device=arr._data.device))

    def _init_zero(self, arr):
        self._set_const(arr, 0)

    def _init_one(self, arr):
        self._set_const(arr, 1)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(arr)


_REG.register(Zero, "zeros")


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(arr)


_REG.register(One, "ones")


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        self._set_const(arr, self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr._set_data((_draw("uniform", arr.shape, arr) * 2 - 1) * self.scale)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr._set_data(_draw("normal", arr.shape, arr) * self.sigma)


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = _draw("uniform", (nout, nin), arr) * 2 - 1
        else:
            tmp = _draw("normal", (nout, nin), arr)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr._set_data((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Factor types avg / in / out; rnd types uniform / gaussian."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2 param, got "
                             f"{name}:{shape}")
        if len(shape) > 2:
            hw_scale = float(_np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            val = (_draw("uniform", shape, arr) * 2 - 1) * scale
        else:
            val = _draw("normal", shape, arr) * scale
        arr._set_data(val)


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = _np.zeros(int(_np.prod(shape)), dtype=_np.float32)
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr._set_data(torch.from_numpy(weight.reshape(shape)))


@register
class LSTMBias(Initializer):
    """Forget-gate bias init."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr._set_data(b)


@register
class FusedRNN(Initializer):
    """Initializes a FusedRNNCell's packed parameters. The reference
    unpacks them through the symbolic ``rnn.rnn_cell.FusedRNNCell``, and
    the symbolic API is ``ROADMAP.md`` A11, so calling it raises; the gluon
    ``rnn`` layers (A7) keep their weights unpacked and need no such
    initializer."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__(init=init if isinstance(init, str) or init is None
                         else init.dumps(), num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)

    def init_array(self, name, arr):
        self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError(
            "FusedRNN initializer: it unpacks through the symbolic "
            "FusedRNNCell, which is the symbolic API (ROADMAP.md A11)")


class Mixed:
    """Pattern -> initializer dispatch."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers length mismatch")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for pat, initf in self.map:
            if pat.match(str(name)):
                initf(name, arr)
                return
        raise ValueError(f"Parameter {name} did not match any pattern")


class Load:
    """Init from a saved dict (or a file ``nd.save`` wrote)."""

    def __init__(self, param, default_init=None, verbose=False):
        from .ndarray.ndarray import load as nd_load
        if isinstance(param, str):
            param = nd_load(param)
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            arr._set_data(self.param[name]._data)
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(f"Cannot init {name}: not found and no default")


class init:
    """Namespace alias so ``mx.init.Xavier()`` works."""
    Initializer = Initializer
    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    FusedRNN = FusedRNN
    Mixed = Mixed
    Load = Load
    InitDesc = InitDesc
    register = staticmethod(register)
    create = staticmethod(create)
