"""The port's ``nd`` API (``incubator_mxnet_tpu_torch.nd``) against the JAX
package's ``nd``, on the CPU.

One parametrised case per operator: the same numpy inputs (from a seed) go
through both packages' ``nd`` op, and the outputs must agree in value
(float32: 1e-5, relative above 1; the JAX side runs under
``jax.default_matmul_precision("highest")``) and in dtype. Differentiable
cases also compare the inputs' gradients of sum(out * w) under
``autograd.record()`` (1e-4). Beside the sweep: the dtypes of the creation
paths, the aliasing rule (a write never reaches another array's view),
``save``/``load`` across the packages, the context rules, the update ops,
the samplers and the initializers.
"""
import numpy as np
import pytest

import jax
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _f(*shape, lo=None, hi=None, seed=0):
    g = np.random.default_rng(seed)
    if lo is None:
        return g.standard_normal(shape).astype(np.float32)
    return g.uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, hi=4, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.int32)


X = _f(3, 4)                      # any real
P = _f(3, 4, lo=0.5, hi=2.0)      # positive
U = _f(3, 4, lo=-0.9, hi=0.9)     # inside (-1, 1)
G = _f(3, 4, lo=1.1, hi=3.0)      # above 1
X4 = _f(2, 3, 6, 6, seed=1)       # NCHW
W4 = _f(4, 3, 3, 3, seed=2)       # OIHW
B4 = _f(4, seed=3)
Y = _f(1, 4, seed=4)              # broadcasts against X

UNARY = {
    "abs": X, "sign": X, "round": X * 3, "rint": X * 3, "ceil": X, "floor": X,
    "trunc": X, "fix": X, "square": X, "sqrt": P, "rsqrt": P, "cbrt": X,
    "rcbrt": P, "exp": X, "log": P, "log10": P, "log2": P, "log1p": P,
    "expm1": X, "sin": X, "cos": X, "tan": U, "arcsin": U, "arccos": U,
    "arctan": X, "sinh": X, "cosh": X, "tanh": X, "arcsinh": X,
    "arccosh": G, "arctanh": U, "degrees": X, "radians": X, "sigmoid": X,
    "relu": X, "softsign": X, "reciprocal": P, "negative": X, "erf": X,
    "erfinv": U, "gamma": P, "gammaln": P, "logical_not": np.round(X),
    "zeros_like": X, "ones_like": X, "identity": X,
}
NO_GRAD_UNARY = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix",
                 "logical_not", "zeros_like", "ones_like", "erfinv"}

BINARY = {
    "add": (X, Y), "subtract": (X, Y), "multiply": (X, Y), "divide": (X, P),
    "modulo": (X * 3, P), "power": (P, X), "maximum": (X, Y),
    "minimum": (X, Y), "hypot": (X, Y), "arctan2": (X, Y),
    "equal": (np.round(X), np.round(Y)), "not_equal": (np.round(X), np.round(Y)),
    "greater": (X, Y), "greater_equal": (X, Y), "lesser": (X, Y),
    "lesser_equal": (X, Y), "logical_and": (np.round(X), np.round(Y)),
    "logical_or": (np.round(X), np.round(Y)),
    "logical_xor": (np.round(X), np.round(Y)),
}
CMP = {"equal", "not_equal", "greater", "greater_equal", "lesser",
       "lesser_equal", "logical_and", "logical_or", "logical_xor"}

# name -> (inputs, fn(nd, *arrays), differentiable)
CASES = {}
for _n, _x in UNARY.items():
    CASES[f"unary_{_n}"] = ([_x], (lambda n: lambda nd, a: getattr(nd, n)(a))(
        _n), _n not in NO_GRAD_UNARY)
for _n, (_a, _b) in BINARY.items():
    CASES[f"binary_{_n}"] = ([_a, _b], (lambda n: lambda nd, a, b: getattr(
        nd, n)(a, b))(_n), _n not in CMP and _n != "modulo")
    CASES[f"binary_broadcast_{_n}"] = ([_a, _b], (
        lambda n: lambda nd, a, b: getattr(nd, "broadcast_" + n)(a, b))(_n),
        False)

XR = _f(2, 3, 4, seed=5)
IDX = _i(3, hi=4, seed=6)
SEQ = _f(5, 3, 4, seed=7)
LENS = np.array([2, 5, 3], np.int32)


def _case(name, inputs, fn, grad=True):
    CASES[name] = (inputs, fn, grad)


for _red in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
    _case(f"reduce_{_red}_axis", [XR], (lambda r: lambda nd, a: getattr(
        nd, r)(a, axis=1))(_red), _red not in ("nansum", "nanprod"))
    _case(f"reduce_{_red}_keep_exclude", [XR], (lambda r: lambda nd, a:
          getattr(nd, r)(a, axis=(0, 2), keepdims=True, exclude=True))(_red),
          False)
    _case(f"reduce_{_red}_all", [XR], (lambda r: lambda nd, a: getattr(
        nd, r)(a))(_red), False)
_case("sum_axis", [XR], lambda nd, a: nd.sum_axis(a, axis=2))
_case("norm_2", [XR], lambda nd, a: nd.norm(a, axis=1))
_case("norm_1", [XR], lambda nd, a: nd.norm(a, ord=1, axis=-1,
                                             keepdims=True))
_case("argmax", [XR], lambda nd, a: nd.argmax(a, axis=1), False)
_case("argmin_keep", [XR], lambda nd, a: nd.argmin(a, axis=2,
                                                    keepdims=True), False)
_case("topk_indices", [XR], lambda nd, a: nd.topk(a, k=2), False)
_case("topk_value", [XR], lambda nd, a: nd.topk(a, axis=1, k=2,
                                                 ret_typ="value"))
_case("topk_both_ascend", [XR], lambda nd, a: nd.topk(
    a, k=3, ret_typ="both", is_ascend=True), False)
_case("sort", [XR], lambda nd, a: nd.sort(a, axis=1))
_case("sort_descend", [XR], lambda nd, a: nd.sort(a, is_ascend=False))
_case("argsort", [XR], lambda nd, a: nd.argsort(a, axis=0), False)
_case("argsort_descend", [XR], lambda nd, a: nd.argsort(a, is_ascend=False),
      False)
# axis=None sorts the flattened array, stably (ties from the rounding)
_case("sort_axis_none", [np.round(XR)], lambda nd, a: nd.sort(a, axis=None))
_case("sort_axis_none_descend", [XR], lambda nd, a: nd.sort(
    a, axis=None, is_ascend=False))
_case("argsort_axis_none", [np.round(XR)], lambda nd, a: nd.argsort(
    a, axis=None), False)
_case("argsort_axis_none_descend", [np.round(XR)], lambda nd, a: nd.argsort(
    a, axis=None, is_ascend=False), False)
_case("method_argsort_axis_none", [np.round(XR)], lambda nd, a: a.argsort(
    axis=None), False)
_case("pick", [X, IDX], lambda nd, a, i: nd.pick(a, i))
_case("pick_keepdims_axis0", [X, _i(4, hi=3)], lambda nd, a, i: nd.pick(
    a, i, axis=0, keepdims=True))
_case("reshape_codes", [XR], lambda nd, a: nd.reshape(a, (0, -1)))
_case("Reshape", [XR], lambda nd, a: nd.Reshape(a, shape=(4, 6)))
_case("reshape_like", [XR, X4[:1, :1, :4, :6]], lambda nd, a, b:
      nd.reshape_like(a, b), False)
_case("flatten", [X4], lambda nd, a: nd.flatten(a))
_case("Flatten", [X4], lambda nd, a: nd.Flatten(a))
_case("transpose", [XR], lambda nd, a: nd.transpose(a, axes=(2, 0, 1)))
_case("transpose_default", [XR], lambda nd, a: nd.transpose(a))
_case("expand_dims", [X], lambda nd, a: nd.expand_dims(a, 1))
_case("squeeze", [X[:, :1]], lambda nd, a: nd.squeeze(a, axis=1))
_case("broadcast_to", [Y], lambda nd, a: nd.broadcast_to(a, (3, 4)))
_case("broadcast_like", [Y, X], lambda nd, a, b: nd.broadcast_like(a, b),
      False)
_case("broadcast_axis", [Y], lambda nd, a: nd.broadcast_axis(a, 0, 5))
_case("tile", [X], lambda nd, a: nd.tile(a, (2, 1, 3)))
_case("repeat", [X], lambda nd, a: nd.repeat(a, 2, axis=1))
_case("repeat_flat", [X], lambda nd, a: nd.repeat(a, 3))
_case("pad_constant", [X4], lambda nd, a: nd.pad(
    a, mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
    constant_value=0.5))
_case("pad_edge", [X4], lambda nd, a: nd.pad(
    a, mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 2)))
_case("Pad_reflect", [X4], lambda nd, a: nd.Pad(
    a, mode="reflect", pad_width=(0, 0, 0, 0, 2, 2, 1, 3)))
_case("flip", [XR], lambda nd, a: nd.flip(a, 1))
_case("reverse", [XR], lambda nd, a: nd.reverse(a, 2))
_case("clip", [X], lambda nd, a: nd.clip(a, -0.5, 0.7))
_case("where", [np.round(X), X, Y.repeat(3, 0)], lambda nd, c, a, b:
      nd.where(c, a, b))
_case("take_clip", [X, np.array([[0, 5], [-1, 2]], np.int32)],
      lambda nd, a, i: nd.take(a, i))
_case("take_wrap_axis1", [X, np.array([0, 5, -1], np.int32)],
      lambda nd, a, i: nd.take(a, i, axis=1, mode="wrap"))
_case("batch_take", [X, IDX], lambda nd, a, i: nd.batch_take(a, i))
_case("gather_nd", [XR, np.array([[0, 1, 1], [2, 0, 1]], np.int32)],
      lambda nd, a, i: nd.gather_nd(a, i))
_case("scatter_nd", [_f(3), np.array([[0, 1, 1], [2, 0, 3]], np.int32)],
      lambda nd, a, i: nd.scatter_nd(a, i, (2, 4)))
_case("slice", [XR], lambda nd, a: nd.slice(a, (0, 1), (2, 3)))
_case("slice_step", [XR], lambda nd, a: nd.slice(a, (0, 0, 0), (2, 3, 4),
                                                  (1, 2, 2)))
_case("slice_negative_step", [XR], lambda nd, a: nd.slice(
    a, (None, None, 3), (None, 0, None), (None, -1, -2)))
_case("slice_axis", [XR], lambda nd, a: nd.slice_axis(a, 2, 1, 3))
# negative-step reads: whole reversal, a stop short of 0, with an int, an
# ellipsis, a new axis and an empty selection
_case("getitem_reversed", [XR], lambda nd, a: a[::-1])
_case("getitem_negative_step_mixed", [XR], lambda nd, a: a[:, -1:0:-1])
_case("getitem_negative_step_int", [XR], lambda nd, a: a[1, ::-2, 2])
_case("getitem_negative_step_ellipsis", [XR], lambda nd, a: a[
    None, ..., 3:0:-2])
_case("getitem_negative_step_empty", [XR], lambda nd, a: a[:, 0:2:-1])
_case("slice_like", [XR, X], lambda nd, a, b: nd.slice_like(a, b, axes=(1,)),
      False)
_case("diag", [X], lambda nd, a: nd.diag(a, k=1))
_case("diag_3d", [XR], lambda nd, a: nd.diag(a))
_case("shape_array", [XR], lambda nd, a: nd.shape_array(a), False)
_case("size_array", [XR], lambda nd, a: nd.size_array(a), False)
_case("cast", [X], lambda nd, a: nd.cast(a, "int32"), False)
_case("Cast", [X], lambda nd, a: nd.Cast(a, dtype="float16"), False)
_case("one_hot", [np.array([0, 3, 1, 7], np.int32)], lambda nd, i:
      nd.one_hot(i, 5, on_value=2.0, off_value=-1.0), False)
_case("swapaxes", [XR], lambda nd, a: nd.swapaxes(a, 0, 2))
_case("SwapAxis", [XR], lambda nd, a: nd.SwapAxis(a, 1, 2))
_case("sequence_mask", [SEQ, LENS], lambda nd, a, l: nd.sequence_mask(
    a, l, use_sequence_length=True, value=-1.0))
_case("SequenceMask_axis1", [SEQ.transpose(1, 0, 2).copy(), LENS],
      lambda nd, a, l: nd.SequenceMask(a, l, use_sequence_length=True,
                                       axis=1))
_case("sequence_last", [SEQ, LENS], lambda nd, a, l: nd.sequence_last(
    a, l, use_sequence_length=True))
_case("SequenceLast_full", [SEQ], lambda nd, a: nd.SequenceLast(a))
_case("sequence_reverse", [SEQ, LENS], lambda nd, a, l: nd.sequence_reverse(
    a, l, use_sequence_length=True))
_case("SequenceReverse_full", [SEQ], lambda nd, a: nd.SequenceReverse(a))

# NN ops
_case("FullyConnected", [XR, _f(5, 12, seed=8), _f(5, seed=9)],
      lambda nd, x, w, b: nd.FullyConnected(x, w, b, num_hidden=5))
_case("FullyConnected_noflatten", [XR, _f(5, 4, seed=8)],
      lambda nd, x, w: nd.FullyConnected(x, w, num_hidden=5, no_bias=True,
                                         flatten=False))
_case("fully_connected", [X, _f(2, 4, seed=8)], lambda nd, x, w:
      nd.fully_connected(x, w, None, num_hidden=2, no_bias=True))
_case("Convolution", [X4, W4, B4], lambda nd, x, w, b: nd.Convolution(
    x, w, b, kernel=(3, 3), stride=(1, 2), pad=(1, 1), num_filter=4))
_case("Convolution_dilate_group", [_f(2, 4, 7, 7, seed=10),
                                   _f(4, 2, 3, 3, seed=11)],
      lambda nd, x, w: nd.Convolution(x, w, kernel=(3, 3), dilate=(2, 2),
                                      num_filter=4, num_group=2,
                                      no_bias=True))
_case("Convolution_1d", [_f(2, 3, 9, seed=12), _f(4, 3, 3, seed=13),
                         _f(4, seed=14)],
      lambda nd, x, w, b: nd.Convolution(x, w, b, kernel=(3,), pad=(1,),
                                         num_filter=4))
_case("convolution_nhwc", [X4.transpose(0, 2, 3, 1).copy(),
                           W4.transpose(0, 2, 3, 1).copy(), B4],
      lambda nd, x, w, b: nd.convolution(x, w, b, kernel=(3, 3),
                                         num_filter=4, layout="NHWC"))
_case("Deconvolution", [X4, _f(3, 2, 3, 3, seed=15)], lambda nd, x, w:
      nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       num_filter=2))
_case("Deconvolution_bias_group", [_f(1, 4, 4, 4, seed=16),
                                   _f(4, 1, 2, 2, seed=17), _f(2, seed=18)],
      lambda nd, x, w, b: nd.Deconvolution(x, w, b, kernel=(2, 2),
                                           num_filter=2, num_group=2,
                                           no_bias=False))
for _pt in ("max", "avg", "sum", "lp"):
    _case(f"Pooling_{_pt}", [X4], (lambda pt: lambda nd, x: nd.Pooling(
        x, kernel=(3, 3), pool_type=pt, stride=(2, 2), pad=(1, 1)))(_pt))
_case("Pooling_full_nopad_count", [X4], lambda nd, x: nd.Pooling(
    x, kernel=(4, 4), pool_type="avg", stride=(3, 3), pad=(1, 1),
    pooling_convention="full", count_include_pad=False))
_case("Pooling_global", [X4], lambda nd, x: nd.Pooling(x, pool_type="max",
                                                       global_pool=True))
_case("pooling_nhwc", [X4.transpose(0, 2, 3, 1).copy()], lambda nd, x:
      nd.pooling(x, kernel=(2, 2), pool_type="avg", layout="NHWC"))
for _act in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
             "silu"):
    _case(f"Activation_{_act}", [X], (lambda t: lambda nd, x: nd.Activation(
        x, act_type=t))(_act))
for _act in ("leaky", "elu", "selu", "gelu", "rrelu"):
    _case(f"LeakyReLU_{_act}", [X], (lambda t: lambda nd, x: nd.LeakyReLU(
        x, act_type=t, slope=0.1))(_act))
_case("LeakyReLU_prelu", [X4, _f(3, seed=19)], lambda nd, x, g:
      nd.LeakyReLU(x, g, act_type="prelu"))
_case("BatchNorm_inference", [X4, _f(3, seed=20), _f(3, seed=21),
                              _f(3, seed=22), _f(3, lo=0.5, hi=2, seed=23)],
      lambda nd, x, g, b, m, v: nd.BatchNorm(x, g, b, m, v, fix_gamma=False))
_case("BatchNorm_v1", [X4, _f(3, seed=20), _f(3, seed=21), _f(3, seed=22),
                       _f(3, lo=0.5, hi=2, seed=23)],
      lambda nd, x, g, b, m, v: nd.BatchNorm_v1(x, g, b, m, v))
_case("batch_norm_train_stats", [X4, _f(3, seed=20), _f(3, seed=21),
                                 _f(3, seed=22), _f(3, lo=0.5, hi=2,
                                                    seed=23)],
      lambda nd, x, g, b, m, v: _bn_train(nd, x, g, b, m, v))
_case("LayerNorm", [XR, _f(4, seed=24), _f(4, seed=25)],
      lambda nd, x, g, b: nd.LayerNorm(x, g, b))
_case("layer_norm_axis1", [XR, _f(3, seed=24), _f(3, seed=25)],
      lambda nd, x, g, b: nd.layer_norm(x, g, b, axis=1, eps=1e-3))
_case("InstanceNorm", [X4, _f(3, seed=26), _f(3, seed=27)],
      lambda nd, x, g, b: nd.InstanceNorm(x, g, b))
for _m in ("instance", "channel", "spatial"):
    _case(f"L2Normalization_{_m}", [X4], (lambda m: lambda nd, x:
                                          nd.L2Normalization(x, mode=m))(_m))
_case("LRN", [X4], lambda nd, x: nd.LRN(x, nsize=3))
_case("Embedding", [_i(2, 5, hi=6, seed=28), _f(6, 3, seed=29)],
      lambda nd, i, w: nd.Embedding(i, w, input_dim=6, output_dim=3))
_case("embedding", [_i(7, hi=6, seed=28), _f(6, 3, seed=29)],
      lambda nd, i, w: nd.embedding(i, w))
_case("softmax", [XR], lambda nd, x: nd.softmax(x))
_case("softmax_axis0_temperature", [XR], lambda nd, x: nd.softmax(
    x, axis=0, temperature=0.5))
_case("softmax_length", [_f(16, 8, seed=30),
                         np.array([1, 8, 3, 5] * 4, np.int32)],
      lambda nd, x, l: nd.softmax(x, length=l))
_case("log_softmax", [XR], lambda nd, x: nd.log_softmax(x, temperature=2.0))
_case("softmax_cross_entropy", [X, IDX], lambda nd, x, l:
      nd.softmax_cross_entropy(x, l))
_case("SoftmaxOutput", [X, IDX], lambda nd, x, l: nd.SoftmaxOutput(x, l),
      False)
_case("SoftmaxActivation_channel", [X4], lambda nd, x:
      nd.SoftmaxActivation(x, mode="channel"))
_case("smooth_l1", [X], lambda nd, x: nd.smooth_l1(x, scalar=2.0))
_case("MakeLoss", [X], lambda nd, x: nd.MakeLoss(x, grad_scale=2.0))
_case("BlockGrad", [X], lambda nd, x: nd.BlockGrad(x) * 2, False)
_case("stop_gradient", [X], lambda nd, x: nd.stop_gradient(x) + x)
_case("UpSampling", [X4], lambda nd, x: nd.UpSampling(x, scale=2))
_case("Concat", [X, P], lambda nd, a, b: nd.Concat(a, b, dim=0))
_case("concat", [X, P], lambda nd, a, b: nd.concat(a, b, dim=1))
_case("concatenate", [X, P], lambda nd, a, b: nd.concatenate([a, b]))
_case("stack", [X, P], lambda nd, a, b: nd.stack(a, b, axis=1))
_case("split", [XR], lambda nd, a: nd.split(a, 2, axis=2))
_case("split_squeeze", [XR], lambda nd, a: nd.split(a, 3, axis=1,
                                                     squeeze_axis=True))
_case("SliceChannel", [XR], lambda nd, a: nd.SliceChannel(a, 2, axis=0))
_case("slice_channel_one", [XR], lambda nd, a: nd.slice_channel(a, 1))
_case("add_n", [X, P, Y.repeat(3, 0)], lambda nd, a, b, c: nd.add_n(a, b, c))
_case("ElementWiseSum", [X, P], lambda nd, a, b: nd.ElementWiseSum([a, b]))
_case("dot", [X, _f(4, 5, seed=31)], lambda nd, a, b: nd.dot(a, b))
_case("dot_transposes", [X, _f(5, 3, seed=31)], lambda nd, a, b: nd.dot(
    a, b, transpose_a=True, transpose_b=True))
_case("dot_3d_2d", [XR, _f(4, 2, seed=32)], lambda nd, a, b: nd.dot(a, b))
_case("dot_3d_3d", [XR, _f(5, 4, 2, seed=32)], lambda nd, a, b: nd.dot(a, b))
_case("dot_vec", [_f(4, seed=33), _f(4, seed=34)], lambda nd, a, b:
      nd.dot(a, b))
_case("dot_op", [X, _f(4, 5, seed=31)], lambda nd, a, b: nd.dot_op(a, b))
_case("batch_dot", [XR, _f(2, 4, 5, seed=35)], lambda nd, a, b:
      nd.batch_dot(a, b))
_case("batch_dot_transposes", [XR, _f(2, 5, 3, seed=35)], lambda nd, a, b:
      nd.batch_dot(a, b, transpose_a=True, transpose_b=True))
_case("linalg_gemm2", [XR, _f(2, 4, 5, seed=35)], lambda nd, a, b:
      nd.linalg_gemm2(a, b))
_case("moveaxis", [XR], lambda nd, a: nd.moveaxis(a, 0, 2))
_case("_flash_attention", [_f(2, 64, 32, seed=36), _f(2, 64, 32, seed=37),
                           _f(2, 64, 32, seed=38)],
      lambda nd, q, k, v: nd._flash_attention(q, k, v, scale=0.2,
                                              causal=True))
_case("LinearRegressionOutput", [X, P], lambda nd, x, l:
      nd.LinearRegressionOutput(x, l), False)
_case("MAERegressionOutput", [X], lambda nd, x: nd.MAERegressionOutput(x))
_case("LogisticRegressionOutput", [X, P], lambda nd, x, l:
      nd.LogisticRegressionOutput(x, l), False)
_case("histogram", [_f(50, seed=39)], lambda nd, x: nd.histogram(x, bins=5),
      False)
_case("histogram_range", [_f(50, seed=39)], lambda nd, x: nd.histogram(
    x, bins=4, range=(-1.0, 1.0)), False)
_case("ravel_multi_index", [np.array([[0, 1, 2], [3, 0, 1]], np.float32)],
      lambda nd, x: nd.ravel_multi_index(x, shape=(3, 4)), False)
_case("unravel_index", [np.array([0, 5, 11], np.float32)], lambda nd, x:
      nd.unravel_index(x, shape=(3, 4)), False)
_case("depth_to_space", [_f(1, 8, 2, 3, seed=40)], lambda nd, x:
      nd.depth_to_space(x, 2))
_case("space_to_depth", [_f(1, 2, 4, 6, seed=41)], lambda nd, x:
      nd.space_to_depth(x, 2))
_case("GridGenerator", [_f(2, 6, seed=42)], lambda nd, t:
      nd.GridGenerator(t, target_shape=(3, 4)))
_case("BilinearSampler", [X4, _f(2, 2, 4, 5, lo=-1.2, hi=1.2, seed=43)],
      lambda nd, x, g: nd.BilinearSampler(x, g))
_case("SpatialTransformer", [X4, np.tile(np.array(
    [[0.9, 0.1, 0.05, -0.1, 0.8, 0.0]], np.float32), (2, 1))],
    lambda nd, x, t: nd.SpatialTransformer(x, t, target_shape=(4, 4)))
_case("ROIPooling", [X4, np.array([[0, 0, 0, 4, 4], [1, 1, 2, 5, 5]],
                                  np.float32)],
      lambda nd, x, r: nd.ROIPooling(x, r, pooled_size=(2, 2),
                                     spatial_scale=1.0), False)
_case("make_loss", [X], lambda nd, x: nd.make_loss(x * 2))
_case("Correlation", [_f(1, 2, 6, 6, seed=44), _f(1, 2, 6, 6, seed=45)],
      lambda nd, a, b: nd.Correlation(a, b, kernel_size=1,
                                      max_displacement=1, pad_size=1))
_case("Correlation_abs_k3", [_f(1, 2, 7, 7, seed=44), _f(1, 2, 7, 7,
                                                         seed=45)],
      lambda nd, a, b: nd.Correlation(a, b, kernel_size=3,
                                      max_displacement=1, pad_size=2,
                                      is_multiply=False))
_case("Crop", [X4], lambda nd, x: nd.Crop(x, h_w=(3, 4), offset=(1, 2)))
_case("Crop_center_like", [X4, _f(1, 1, 2, 4, seed=46)], lambda nd, x, l:
      nd.Crop(x, l, center_crop=True), False)
_case("hard_sigmoid", [X * 3], lambda nd, x: nd.hard_sigmoid(x))
_case("softmin", [XR], lambda nd, x: nd.softmin(x, axis=1))
_case("argmax_channel", [X4], lambda nd, x: nd.argmax_channel(x), False)
_case("khatri_rao", [_f(2, 3, seed=47), _f(4, 3, seed=48)], lambda nd, a, b:
      nd.khatri_rao(a, b))
_case("ctc_loss", [_f(6, 2, 5, seed=49), np.array([[1, 2], [3, 0]],
                                                  np.int32)],
      lambda nd, x, l: nd.ctc_loss(x, l))
_case("CTCLoss_lengths_last", [_f(6, 2, 5, seed=49),
                               np.array([[1, 2, 0], [3, 1, 1]], np.int32),
                               np.array([5, 6], np.int32),
                               np.array([2, 3], np.int32)],
      lambda nd, x, l, dl, ll: nd.CTCLoss(
          x, l, dl, ll, use_data_lengths=True, use_label_lengths=True,
          blank_label="last"))
_case("IdentityAttachKLSparseReg", [_f(4, 3, lo=0.1, hi=0.9, seed=50)],
      lambda nd, x: nd.IdentityAttachKLSparseReg(x))
_case("ndarray_methods", [XR], lambda nd, x: [
    x.T, x.flatten(), x.ravel(), x.expand_dims(0), x.swapaxes(0, 1),
    x.max(axis=1), x.min(), x.mean(axis=(0, 2)), x.prod(axis=2),
    x.norm(), x.abs(), x.exp(), x.square(), x.sign(), x.tanh(),
    x.sigmoid(), x.relu(), x.softmax(), x.log_softmax(axis=1),
    x.clip(-0.3, 0.3), x.repeat(2, axis=0), x.tile((1, 2, 1)),
    x.slice_axis(2, 1, None), x[1, :, 2:], x[:, 1], x.reshape((6, 4)),
    x.broadcast_to((3, 2, 3, 4)), -x, abs(x), x + 1, 2 - x, x * x,
    x / 3, 3 / (x * x + 1), x ** 2, 2 ** x, (x * 3) % 2, x @ x.T[:, :, 0],
    x.take(x.argmax(axis=2)[0])],
    False)
_case("ndarray_compare_methods", [X, Y], lambda nd, a, b: [
    a == b, a != 0.5, a < b, a <= b, a > b, a >= 0.0, a.argmax(axis=1),
    a.argsort(), (a > 0).one_hot(2), a.round(), a.floor(), a.ceil(),
    a.zeros_like(), a.ones_like(), a.astype("int32")], False)
_case("ndarray_pad_method", [X4], lambda nd, x: x.pad(
    ((0, 0), (0, 0), (1, 1), (2, 0))), False)


def _bn_train(nd, x, g, b, m, v):
    mx = jmx if nd is jmx.nd else tmx
    with mx.autograd.train_mode():
        y, bm, bv = nd.BatchNorm(x, g, b, m, v, fix_gamma=False,
                                 output_mean_var=True)
    return [y, bm, bv, m, v]


def _run(mx, inputs, fn, grad, w_seed=100):
    """Outputs (numpy, dtype name) and the float inputs' gradients."""
    arrs = [mx.nd.array(a) for a in inputs]
    if grad:
        for a in arrs:
            if np.dtype(a.dtype).kind == "f":
                a.attach_grad()
        with mx.autograd.record():
            out = fn(mx.nd, *arrs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = None
            for i, o in enumerate(outs):
                w = mx.nd.array(np.random.default_rng(w_seed + i)
                                .standard_normal(o.shape).astype(np.float32))
                t = (o * w).sum()
                loss = t if loss is None else loss + t
        loss.backward()
        grads = [a.grad.asnumpy() for a in arrs
                 if np.dtype(a.dtype).kind == "f"]
    else:
        out = fn(mx.nd, *arrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        grads = []
    return ([(o.asnumpy(), str(np.dtype(o.dtype))) for o in outs], grads)


def _assert_close(got, want, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    lim = atol * np.maximum(1.0, np.abs(want))
    bad = ~(np.abs(got - want) <= lim) & ~(np.isnan(got) & np.isnan(want))
    bad &= ~(np.isinf(got) & np.isinf(want) & (np.sign(got) == np.sign(want)))
    assert not bad.any(), (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    inputs, fn, grad = CASES[name]
    with jax.default_matmul_precision("highest"):
        jouts, jgrads = _run(jmx, inputs, fn, grad)
    touts, tgrads = _run(tmx, inputs, fn, grad)
    assert len(touts) == len(jouts)
    for (t, tdt), (j, jdt) in zip(touts, jouts):
        assert tdt == jdt, (tdt, jdt)
        _assert_close(t, j, 1e-5)
    assert len(tgrads) == len(jgrads)
    for t, j in zip(tgrads, jgrads):
        _assert_close(t, j, 1e-4)


def test_topk_mask_marks_the_top_entries():
    """The port's mask is the input's shape with ones at the top-k entries
    (the reference's mask output is not: see ROADMAP.md section C)."""
    x = tmx.nd.array(XR)
    got = tmx.nd.topk(x, axis=-1, k=2, ret_typ="mask").asnumpy()
    want = np.zeros_like(XR)
    np.put_along_axis(want, np.argsort(-XR, axis=-1)[..., :2], 1.0, axis=-1)
    np.testing.assert_array_equal(got, want)


def test_unported_ops_name_their_roadmap_item():
    x = tmx.nd.array(X)
    # nd.Custom is ported (tests/test_torch_operator.py): an op type that
    # was never registered is unknown in both packages
    for mx in (jmx, tmx):
        with pytest.raises(KeyError, match="sqr"):
            mx.nd.Custom(mx.nd.array(X), op_type="sqr")
    # sparse storage is ported (tests/test_torch_sparse.py): tostype
    # converts in both packages
    for mx, arr in ((jmx, jmx.nd.array(X)), (tmx, x)):
        csr = arr.tostype("csr")
        assert csr.stype == "csr"
        np.testing.assert_array_equal(csr.asnumpy(), X)


def test_unknown_keyword_raises_in_both():
    for mx in (jmx, tmx):
        with pytest.raises(mx.base.MXTPUError, match="unknown argument"):
            mx.nd.Activation(mx.nd.array(X), act_type="relu", bogus=1)
        mx.nd.Activation(mx.nd.array(X), act_type="relu", cudnn_off=True)


# ---------------------------------------------------------------- dtypes
DTYPE_PATHS = {
    "list_int": lambda mx: mx.nd.array([1, 2]),
    "list_float": lambda mx: mx.nd.array([1.0, 2.0]),
    "np_float64": lambda mx: mx.nd.array(np.array([1.0, 2.0])),
    "np_int64": lambda mx: mx.nd.array(np.array([1, 2], np.int64)),
    "np_float16": lambda mx: mx.nd.array(np.array([1, 2], np.float16)),
    "np_uint8": lambda mx: mx.nd.array(np.array([1, 2], np.uint8)),
    "np_bool": lambda mx: mx.nd.array(np.array([True, False])),
    "scalar_int": lambda mx: mx.nd.array(3),
    "scalar_float": lambda mx: mx.nd.array(3.5),
    "dtype_float64": lambda mx: mx.nd.array([1, 2], dtype="float64"),
    "dtype_int64": lambda mx: mx.nd.array([1.5, 2], dtype=np.int64),
    "dtype_float16": lambda mx: mx.nd.array([1, 2], dtype="float16"),
    "zeros": lambda mx: mx.nd.zeros((2, 3)),
    "ones_int32": lambda mx: mx.nd.ones((2,), dtype="int32"),
    "full": lambda mx: mx.nd.full((2,), 7),
    "empty": lambda mx: mx.nd.empty((2,)),
    "arange": lambda mx: mx.nd.arange(5),
    "arange_int": lambda mx: mx.nd.arange(1, 7, 2, dtype="int32"),
    "arange_repeat": lambda mx: mx.nd.arange(0, 2, 0.5, repeat=2),
    "eye": lambda mx: mx.nd.eye(3, 4, k=1),
    "linspace": lambda mx: mx.nd.linspace(0, 1, 5, endpoint=False),
    "astype_float64": lambda mx: mx.nd.array([1.0]).astype("float64"),
    "astype_int64": lambda mx: mx.nd.array([1.7]).astype(np.int64),
    "sum_int": lambda mx: mx.nd.array([1, 2]).sum(),
    "mean_int": lambda mx: mx.nd.mean(mx.nd.array([1, 2])),
    "prod_int": lambda mx: mx.nd.prod(mx.nd.array([[1, 2], [3, 4]]), axis=0),
    "int_div": lambda mx: mx.nd.array([1, 2]) / 2,
    "int_plus_float": lambda mx: mx.nd.array([1, 2]) + 0.5,
    "int_plus_int_array": lambda mx: mx.nd.add(mx.nd.array([1, 2]),
                                               mx.nd.array([3, 4])),
    "int_times_float_array": lambda mx: mx.nd.multiply(
        mx.nd.array([1, 2]), mx.nd.array([0.5, 1.5])),
    "f16_plus_f32": lambda mx: mx.nd.add(
        mx.nd.array([1, 2], dtype="float16"), mx.nd.array([0.5, 1.5])),
    "argmax": lambda mx: mx.nd.array([1, 5, 2]).argmax(),
    "compare": lambda mx: mx.nd.array([1.0, 5.0]) > 2,
    "int_sqrt": lambda mx: mx.nd.sqrt(mx.nd.array([1, 4])),
    "copy": lambda mx: mx.nd.array([1, 2], dtype="uint8").copy(),
}


@pytest.mark.parametrize("path", sorted(DTYPE_PATHS))
def test_creation_dtypes_match_jax(path):
    fn = DTYPE_PATHS[path]
    j, t = fn(jmx), fn(tmx)
    assert str(np.dtype(t.dtype)) == str(np.dtype(j.dtype))
    assert t.shape == j.shape
    _assert_close(t.asnumpy(), j.asnumpy(), 1e-6)


def test_bfloat16_dtype():
    t = tmx.nd.array([1.0, 2.0], dtype="bfloat16")
    assert t.dtype == torch.bfloat16 and t.tensor.dtype == torch.bfloat16
    assert t.asnumpy().dtype == np.float32


# -------------------------------------------------------------- aliasing
def test_writes_never_reach_another_arrays_view():
    """b = a.reshape(...) then a[:] = 0 leaves b as the reference leaves
    it: every write rebinds the written array."""
    for mx in (jmx, tmx):
        a = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        snap = a.asnumpy().copy()
        makers = {"reshape": lambda v: v.reshape((4, 3)),
                  "row": lambda v: v[1], "T": lambda v: v.T,
                  "slice": lambda v: v[:, 1:3],
                  "flatten": lambda v: v.reshape((12,)),
                  "expand": lambda v: v.reshape((1, 3, 4))}
        views = {k: f(a) for k, f in makers.items()}
        views["detach"] = a.detach()
        makers["detach"] = lambda v: v
        a[:] = 0
        a[1] = 5
        a[0, 2] = -1
        a += 1
        a *= 2
        mx.nd.exp(a, out=a)
        for name, v in views.items():
            np.testing.assert_array_equal(v.asnumpy(), makers[name](snap),
                                          err_msg=name)
        c = a.copy()
        a[:] = 3
        assert c.asnumpy().max() != 3
        w = mx.nd.array(np.ones((2, 3), np.float32))
        wv = w.reshape((6,))
        mx.nd.sgd_update(w, mx.nd.array(np.ones((2, 3), np.float32)),
                         lr=0.5)
        np.testing.assert_array_equal(wv.asnumpy(), np.ones(6))
        np.testing.assert_array_equal(w.asnumpy(), np.full((2, 3), 0.5))


def test_setitem_matches_jax():
    outs = []
    for mx in (jmx, tmx):
        a = mx.nd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        a[0, 1] = mx.nd.array(np.array([9, 8, 7, 6], np.float32))
        a[1, :, 2] = 0.5
        a[1] = a[0] * 2
        a[:, 0, :] = np.ones((2, 4), np.float32)
        outs.append(a.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_setitem_negative_step_matches_jax():
    outs = []
    for mx in (jmx, tmx):
        a = mx.nd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        a[::-1] = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        a[:, -1:0:-1, ::-2] = -5.0
        a[1, ::-1] = np.array([7, 8, 9, 10], np.float32)
        a[..., 3:0:-2] = mx.nd.array(np.full((2, 3, 2), 0.25, np.float32))
        outs.append(a.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_list_key_selects_rows_as_mxnet_does():
    """``x[[1, 0]]`` takes rows 1 and 0 in the port, as MXNet does; the JAX
    package raises, since jax refuses a non-tuple sequence as an index
    (ROADMAP.md section C: a reference fault the port does not copy)."""
    x = np.arange(24, dtype=np.float32).reshape(3, 2, 4)
    got = tmx.nd.array(x)[[1, 0]]
    np.testing.assert_array_equal(got.asnumpy(), x[[1, 0]])
    assert got.shape == (2, 2, 4)
    np.testing.assert_array_equal(tmx.nd.array(x)[[2, 2, 0]].asnumpy(),
                                  x[[2, 2, 0]])
    np.testing.assert_array_equal(
        tmx.nd.array(x)[[1, 0]].asnumpy(),
        jmx.nd.array(x)[jmx.nd.array(np.array([1, 0], np.int32))].asnumpy())
    with pytest.raises(TypeError, match="non-tuple sequence"):
        jmx.nd.array(x)[[1, 0]]


# ------------------------------------------------------------ save / load
def test_load_reads_what_the_jax_package_saved(tmp_path):
    single = _f(2, 3)
    lst = [_f(4), np.arange(3, dtype=np.int32)]
    dct = {"w": _f(3, 2), "b": np.array([1, 0], np.int32)}
    jmx.nd.save(str(tmp_path / "s"), jmx.nd.array(single))
    jmx.nd.save(str(tmp_path / "l"), [jmx.nd.array(a) for a in lst])
    jmx.nd.save(str(tmp_path / "d"), {k: jmx.nd.array(v)
                                      for k, v in dct.items()})
    s = tmx.nd.load(str(tmp_path / "s"))
    np.testing.assert_array_equal(s.asnumpy(), single)
    got = tmx.nd.load(str(tmp_path / "l"))
    assert [str(g.dtype) for g in got] == ["float32", "int32"]
    for g, a in zip(got, lst):
        np.testing.assert_array_equal(g.asnumpy(), a)
    got = tmx.nd.load(str(tmp_path / "d"))
    assert sorted(got) == sorted(dct)
    for k in dct:
        np.testing.assert_array_equal(got[k].asnumpy(), dct[k])
        assert got[k].context == tmx.cpu()
    # and back: what the port saves, the JAX package loads
    tmx.nd.save(str(tmp_path / "t"), {k: tmx.nd.array(v)
                                      for k, v in dct.items()})
    back = jmx.nd.load(str(tmp_path / "t"))
    for k in dct:
        np.testing.assert_array_equal(back[k].asnumpy(), dct[k])


# ---------------------------------------------------------------- context
def test_context_rules(monkeypatch):
    """The default context is the card; without one, making an array on it
    raises, unless the CPU is asked for (``with cpu():`` or ``ctx=``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu(0)
        x = tmx.nd.zeros((2,))
        assert x.context == tmx.cpu() and x.tensor.device.type == "cpu"
        with tmx.gpu(1):
            assert tmx.current_context() == tmx.gpu(1)
            with pytest.raises(tmx.NoCudaDeviceError):
                tmx.nd.zeros((2,))
        assert tmx.current_context() == tmx.cpu()
    # outside every scope (the fixture's cpu scope is entered by the
    # autouse fixture, so leave it for this check)
    stack = tmx.context._context_stack.stack
    saved, stack[:] = list(stack), []
    try:
        assert tmx.current_context() == tmx.gpu(0)
        for make in (lambda: tmx.nd.array([1.0]), lambda: tmx.nd.ones((2,)),
                     lambda: tmx.nd.arange(3), lambda: tmx.random.uniform(
                         shape=(2,)),
                     lambda: tmx.nd.array([1.0], ctx=tmx.gpu())):
            with pytest.raises(tmx.NoCudaDeviceError):
                make()
        y = tmx.nd.array([1.0, 2.0], ctx=tmx.cpu())
        assert y.context == tmx.cpu()
        assert (y + 1).context == tmx.cpu()       # scalars follow the array
        assert tmx.nd.maximum(y, 0).context == tmx.cpu()
    finally:
        stack[:] = saved
    assert tmx.tpu(2) == tmx.gpu(2) and repr(tmx.tpu(2)) == "gpu(2)"
    assert tmx.Context("gpu", 1) != tmx.cpu(1)
    assert tmx.Context(tmx.gpu(3)).device_id == 3
    assert tmx.num_gpus() == 0
    with pytest.raises(ValueError):
        tmx.Context("npu")


# ------------------------------------------------------------ update ops
W0 = _f(3, 4, seed=60)
G0 = _f(3, 4, seed=61)
S_POS = _f(3, 4, lo=0.5, hi=1.5, seed=62)
S_ANY = _f(3, 4, seed=63) * 0.1
UPDATES = {
    "sgd_update": (lambda nd, w, g, s: nd.sgd_update(
        w, g, lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.4), 0),
    "sgd_mom_update": (lambda nd, w, g, s: nd.sgd_mom_update(
        w, g, s[0], lr=0.1, momentum=0.9, wd=0.01), 1),
    "mp_sgd_update": (lambda nd, w, g, s: nd.mp_sgd_update(
        w, g, s[0], lr=0.1, wd=0.01), 1),
    "mp_sgd_mom_update": (lambda nd, w, g, s: nd.mp_sgd_mom_update(
        w, g, s[0], s[1], lr=0.1, momentum=0.9), 2),
    "nag_mom_update": (lambda nd, w, g, s: nd.nag_mom_update(
        w, g, s[0], lr=0.1, momentum=0.9, wd=0.01), 1),
    "mp_nag_mom_update": (lambda nd, w, g, s: nd.mp_nag_mom_update(
        w, g, s[0], s[1], lr=0.1, momentum=0.9), 2),
    "ftml_update": (lambda nd, w, g, s: nd.ftml_update(
        w, g, s[0], s[1], s[2], lr=0.1, t=2, wd=0.01), 3),
    "adam_update": (lambda nd, w, g, s: nd.adam_update(
        w, g, s[0], s[1], lr=0.01, wd=0.01, clip_gradient=1.0), 2),
    "rmsprop_update": (lambda nd, w, g, s: nd.rmsprop_update(
        w, g, s[0], lr=0.01, clip_weights=0.5), 1),
    "rmspropalex_update": (lambda nd, w, g, s: nd.rmspropalex_update(
        w, g, s[0], s[1], s[2], lr=0.01), 3),
    "ftrl_update": (lambda nd, w, g, s: nd.ftrl_update(
        w, g, s[0], s[1], lr=0.1, wd=0.01), 2),
    "signsgd_update": (lambda nd, w, g, s: nd.signsgd_update(
        w, g, lr=0.1, wd=0.01), 0),
    "signum_update": (lambda nd, w, g, s: nd.signum_update(
        w, g, s[0], lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.01), 1),
    "adagrad_update": (lambda nd, w, g, s: nd.adagrad_update(
        w, g, s[0], lr=0.1, wd=0.01), 1),
    "group_adagrad_update": (lambda nd, w, g, s: nd.group_adagrad_update(
        w, g, s[0], lr=0.1), 1),
}


def _update_states(name, n):
    if name == "group_adagrad_update":
        return [S_POS[:, 0].copy()]
    if name == "rmspropalex_update":
        return [S_POS * 2, S_ANY, S_ANY]
    if name.startswith("mp_"):
        return ([S_ANY] if n == 2 else []) + [W0.copy()]
    return [S_POS if i == 0 and name in ("ftrl_update", "adagrad_update",
                                         "rmsprop_update")
            else S_POS * (i + 1) for i in range(n)]


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_op_matches_jax(name):
    fn, n = UPDATES[name]
    states = _update_states(name, n)
    res = []
    for mx in (jmx, tmx):
        w = mx.nd.array(W0.astype(np.float16) if name.startswith("mp_")
                        else W0)
        s = [mx.nd.array(a) for a in states]
        for _ in range(2):
            fn(mx.nd, w, mx.nd.array(G0), s)
        res.append([w.asnumpy()] + [a.asnumpy() for a in s])
        assert str(np.dtype(w.dtype)) == ("float16" if name.startswith("mp_")
                                          else "float32")
    for t, j in zip(res[1], res[0]):
        _assert_close(t, j, 1e-5)


def test_update_ops_cover_the_reference():
    from incubator_mxnet_tpu.ndarray import optimizer_ops as jops
    from incubator_mxnet_tpu_torch.ndarray import optimizer_ops as tops
    assert sorted(tops.__all__) == sorted(jops.__all__) == sorted(UPDATES)


def test_update_keeps_a_marked_weight_a_leaf():
    w = tmx.nd.array(W0)
    w.attach_grad()
    with tmx.autograd.record():
        loss = (w * w).sum()
    loss.backward()
    tmx.nd.sgd_update(w, w.grad, lr=0.1)
    assert w.tensor.requires_grad and w.tensor.is_leaf
    np.testing.assert_allclose(w.asnumpy(), W0 - 0.1 * 2 * W0, rtol=1e-6)


def test_op_namespace_covers_the_reference():
    """Every public op and alias of the reference's ``nd`` namespace exists
    in the port's (the JAX-only bridge ``from_jax`` excepted)."""
    from incubator_mxnet_tpu.ndarray import ops as jops
    want = {n for n, v in vars(jops).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", "").startswith(
                "incubator_mxnet_tpu.ndarray")}
    missing = sorted(n for n in want if not hasattr(tmx.nd, n))
    assert missing == []


# ----------------------------------------------------------------- random
SAMPLERS = {
    "uniform": (lambda mx: mx.random.uniform(-1, 3, shape=(20000,)),
                1.0, 16 / 12),
    "normal": (lambda mx: mx.random.normal(2, 0.5, shape=(20000,)),
               2.0, 0.25),
    "randn": (lambda mx: mx.random.randn(100, 200), 0.0, 1.0),
    "gamma": (lambda mx: mx.random.gamma(2.5, 2.0, shape=(20000,)),
              5.0, 10.0),
    "gamma_small_alpha": (lambda mx: mx.random.gamma(0.5, 1.0,
                                                     shape=(20000,)),
                          0.5, 0.5),
    "exponential": (lambda mx: mx.random.exponential(2.0, shape=(20000,)),
                    2.0, 4.0),
    "poisson": (lambda mx: mx.random.poisson(3.0, shape=(20000,)), 3.0, 3.0),
    "negative_binomial": (lambda mx: mx.random.negative_binomial(
        3, 0.4, shape=(20000,)), 4.5, 11.25),
    "generalized_negative_binomial": (
        lambda mx: mx.random.generalized_negative_binomial(
            2.0, 0.5, shape=(20000,)), 2.0, 4.0),
    "bernoulli": (lambda mx: mx.random.bernoulli(0.3, shape=(20000,)),
                  0.3, 0.21),
    "randint": (lambda mx: mx.random.randint(0, 10, shape=(20000,)),
                4.5, 8.25),
    "sample_uniform": (lambda mx: mx.random.sample_uniform(
        mx.nd.array([0.0, 1.0]), mx.nd.array([1.0, 3.0]), shape=(10000,))
        .reshape((-1,)), 1.25, None),
    "sample_normal": (lambda mx: mx.random.sample_normal(
        mx.nd.array([1.0]), mx.nd.array([2.0]), shape=(20000,)), 1.0, 4.0),
    "sample_gamma": (lambda mx: mx.random.sample_gamma(
        mx.nd.array([2.0]), mx.nd.array([1.5]), shape=(20000,)), 3.0, 4.5),
    "sample_exponential": (lambda mx: mx.random.sample_exponential(
        mx.nd.array([0.5]), shape=(20000,)), 2.0, 4.0),
    "sample_poisson": (lambda mx: mx.random.sample_poisson(
        mx.nd.array([4.0]), shape=(20000,)), 4.0, 4.0),
    "sample_negative_binomial": (lambda mx: mx.random.sample_negative_binomial(
        mx.nd.array([3.0]), mx.nd.array([0.5]), shape=(20000,)), 3.0, 6.0),
    "sample_generalized_negative_binomial": (
        lambda mx: mx.random.sample_generalized_negative_binomial(
            mx.nd.array([2.0]), mx.nd.array([0.25]), shape=(20000,)),
        2.0, 3.0),
    "multinomial": (lambda mx: mx.random.multinomial(
        mx.nd.array([0.2, 0.3, 0.5]), shape=(20000,)), 1.3, 0.61),
    "sample_multinomial": (lambda mx: mx.random.sample_multinomial(
        mx.nd.array([[0.5, 0.5], [0.1, 0.9]]), shape=(10000,))
        .reshape((-1,)), 0.7, None),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_distribution_matches_jax(name):
    """Shape, dtype and moments agree with the reference's sampler (the
    streams differ by design), and a re-seed repeats the stream."""
    fn, mean, var = SAMPLERS[name]
    jmx.random.seed(7)
    j = fn(jmx)
    tmx.random.seed(7)
    t = fn(tmx)
    assert t.shape == j.shape
    assert str(np.dtype(t.dtype)) == str(np.dtype(j.dtype))
    tv = t.asnumpy().astype(np.float64)
    jv = j.asnumpy().astype(np.float64)
    n = tv.size
    sd = np.sqrt(var if var is not None else tv.var())
    for v in (tv, jv):
        assert abs(v.mean() - mean) < 6 * sd / np.sqrt(n) + 1e-3
        if var is not None:
            assert abs(v.var() - var) < 0.1 * var
    tmx.random.seed(7)
    np.testing.assert_array_equal(fn(tmx).asnumpy(), t.asnumpy())


def test_random_out_shuffle_and_state():
    out = tmx.nd.zeros((3, 4))
    r = tmx.random.uniform(shape=(3, 4), out=out)
    assert r is out and 0 <= out.asnumpy().min()
    x = tmx.nd.array(np.arange(10, dtype=np.float32))
    s = tmx.random.shuffle(x).asnumpy()
    np.testing.assert_array_equal(np.sort(s), np.arange(10))
    state = tmx.random.get_state()
    a = tmx.random.normal(shape=(5,)).asnumpy()
    tmx.random.set_state(state)
    np.testing.assert_array_equal(tmx.random.normal(shape=(5,)).asnumpy(), a)
    idx, lp = tmx.random.multinomial(tmx.nd.array([[0.25, 0.75]]),
                                     shape=(4,), get_prob=True)
    np.testing.assert_allclose(lp.asnumpy(), np.log(np.where(
        idx.asnumpy() == 1, 0.75, 0.25)), rtol=1e-6)


# ----------------------------------------------------------- initializers
def test_initializer_registry_matches_jax():
    from incubator_mxnet_tpu import initializer as jinit
    from incubator_mxnet_tpu_torch import initializer as tinit
    assert tinit._REG.keys() == jinit._REG.keys()
    assert sorted(tinit.__all__) == sorted(jinit.__all__)


INITS = {
    "zero": (lambda mx: mx.init.Zero(), "w", 0.0, 0.0),
    "one": (lambda mx: mx.init.One(), "w", 1.0, 0.0),
    "constant": (lambda mx: mx.init.Constant(0.3), "w", 0.3, 0.0),
    "uniform": (lambda mx: mx.init.Uniform(0.5), "w", 0.0, 0.25 / 3),
    "normal": (lambda mx: mx.init.Normal(0.2), "w", 0.0, 0.04),
    "xavier": (lambda mx: mx.init.Xavier(), "w", 0.0, 3.0 / 150 / 3),
    "xavier_gaussian_in": (lambda mx: mx.init.Xavier(
        "gaussian", "in", 2.0), "w", 0.0, 2.0 / 100),
    "msraprelu": (lambda mx: mx.init.MSRAPrelu(), "w", 0.0,
                  2.0 / (1 + 0.0625) / 150),
    "bias_by_name": (lambda mx: mx.init.Normal(), "fc_bias", 0.0, 0.0),
    "gamma_by_name": (lambda mx: mx.init.Uniform(), "bn_gamma", 1.0, 0.0),
    "lstmbias": (lambda mx: mx.init.LSTMBias(2.0), "w", 0.5, None),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_statistics_match_jax(name):
    make, pname, mean, var = INITS[name]
    shape = (200, 100) if name != "lstmbias" else (40,)
    res = []
    for mx in (jmx, tmx):
        arr = mx.nd.zeros(shape)
        make(mx)(mx.initializer.InitDesc(pname), arr)
        res.append(arr.asnumpy())
    for v in res:
        assert v.shape == shape
        assert abs(v.mean() - mean) < 0.01
        if var is not None:
            assert abs(v.var() - var) <= 0.05 * var + 1e-9
    if name in ("zero", "one", "constant", "bias_by_name", "gamma_by_name",
                "lstmbias"):
        np.testing.assert_array_equal(res[0], res[1])


def test_orthogonal_bilinear_mixed_load(tmp_path):
    w = tmx.nd.zeros((6, 4))
    tmx.init.Orthogonal(scale=1.0)("w", w)
    np.testing.assert_allclose(w.asnumpy().T @ w.asnumpy(), np.eye(4),
                               atol=1e-5)
    res = []
    for mx in (jmx, tmx):
        b = mx.nd.zeros((2, 1, 4, 4))
        mx.init.Bilinear()("up_weight", b)
        res.append(b.asnumpy())
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)
    mixed = tmx.init.Mixed([".*bias", ".*"], [tmx.init.Zero(),
                                              tmx.init.One()])
    a, b = tmx.nd.ones((2,)), tmx.nd.zeros((2,))
    mixed("fc_bias", a)
    mixed("fc_weight", b)
    assert a.asnumpy().sum() == 0 and b.asnumpy().sum() == 2
    jmx.nd.save(str(tmp_path / "p"), {"arg:fc_weight": jmx.nd.array(X)})
    c = tmx.nd.zeros((3, 4))
    tmx.init.Load(str(tmp_path / "p"))("fc_weight", c)
    np.testing.assert_array_equal(c.asnumpy(), X)
    tmx.random.seed(3)
    d1 = tmx.nd.zeros((5, 5))
    tmx.init.Xavier()("w", d1)
    tmx.random.seed(3)
    d2 = tmx.nd.zeros((5, 5))
    tmx.init.Xavier()("w", d2)
    np.testing.assert_array_equal(d1.asnumpy(), d2.asnumpy())
    with pytest.raises(NotImplementedError, match="A11"):
        tmx.init.FusedRNN(None, 4, 1, "lstm")("p", tmx.nd.zeros((8,)))


def test_engine_scopes():
    from incubator_mxnet_tpu_torch import engine
    assert engine.set_bulk_size(4) is None
    with engine.bulk(8):
        assert engine.bulk_size() == 8
    assert engine.bulk_size() == 4
    engine.set_bulk_size(None)
    with engine.naive_engine():
        assert engine.engine_type() == "naive"
        y = tmx.nd.array([1.0, 2.0]) * 2
    assert engine.engine_type() == "async"
    np.testing.assert_array_equal(y.asnumpy(), [2.0, 4.0])
    engine.waitall()
    tmx.nd.waitall()
