"""Convolution & pooling Gluon layers.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/conv_layers.py`` (ref:
python/mxnet/gluon/nn/conv_layers.py — Conv1D/2D/3D, Conv1DTranspose/2D/3D,
MaxPool1D/2D/3D, AvgPool1D/2D/3D, GlobalMaxPool, GlobalAvgPool,
ReflectionPad2D), over the port's ``nd.Convolution`` / ``nd.Pooling``, in
both layouts (NCHW, and NHWC with (O, kH, kW, I) weights).
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuple(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """Base N-d conv (ref: conv_layers.py:_Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        nd = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._act_type = activation
        with self.name_scope():
            if op_name == "Convolution":
                ic = in_channels // groups if in_channels else 0
                if layout == "NHWC":
                    # reference NHWC weight convention: (O, kH, kW, I)
                    wshape = (channels,) + tuple(kernel_size) + (ic,)
                else:
                    wshape = (channels, ic) + tuple(kernel_size)
            else:  # Deconvolution: (in, out/g, k...)
                wshape = (in_channels if in_channels else 0,
                          channels // groups) + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        nhwc = self._kwargs.get("layout") == "NHWC"
        in_c = x.shape[-1] if nhwc else x.shape[1]
        w = list(self.weight.shape)
        if self._op_name == "Convolution":
            if nhwc:
                w[-1] = in_c // self._kwargs["num_group"]
            else:
                w[1] = in_c // self._kwargs["num_group"]
        else:
            w[0] = in_c
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, **self._kwargs)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


class Conv1D(_Conv):
    """(ref: conv_layers.py:Conv1D) NCW layout."""

    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class Conv2D(_Conv):
    """(ref: conv_layers.py:Conv2D) NCHW layout."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class Conv3D(_Conv):
    """(ref: conv_layers.py:Conv3D) NCDHW layout."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class Conv1DTranspose(_Conv):
    """(ref: conv_layers.py:Conv1DTranspose)"""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 1), prefix=prefix,
                         params=params)


class Conv2DTranspose(_Conv):
    """(ref: conv_layers.py:Conv2DTranspose)"""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 2), prefix=prefix,
                         params=params)


class Conv3DTranspose(_Conv):
    """(ref: conv_layers.py:Conv3DTranspose)"""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 3), prefix=prefix,
                         params=params)


class _Pooling(HybridBlock):
    """(ref: conv_layers.py:_Pooling)"""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "max",
                         layout=layout, prefix=prefix, params=params)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None, params=None):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "max",
                         layout=layout, prefix=prefix, params=params)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, prefix=None, params=None):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "max",
                         layout=layout, prefix=prefix, params=params)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, prefix=None,
                 params=None):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "avg",
                         count_include_pad, layout=layout,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, layout=layout,
                         prefix=prefix, params=params)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "avg",
                         count_include_pad, layout=layout,
                         prefix=prefix, params=params)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__((1,), None, (0,), True, True, "max",
                         layout=layout, prefix=prefix, params=params)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, prefix=prefix, params=params)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout=layout, prefix=prefix, params=params)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__((1,), None, (0,), True, True, "avg",
                         layout=layout, prefix=prefix, params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, prefix=prefix, params=params)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout=layout, prefix=prefix, params=params)


class ReflectionPad2D(HybridBlock):
    """(ref: conv_layers.py:ReflectionPad2D)"""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
