"""INT8 conversion path for the vision model zoo.

Counterpart of the reference's ``gluon/model_zoo/vision/quantized.py``
(ref: the reference's ``quantization/`` example flow —
imagenet_gen_qsym_mkldnn.py: BN fold and a calibrated int8 symbol for the
zoo ResNets). ``quantize_vision_net`` applies the standard inference-graph
recipe to any zoo net built from Conv/BN/ReLU ``HybridSequential`` bodies
(an NCHW ResNetV1 is the headline consumer; NHWC convs stay float32):

1. **BN fold** — every inference BatchNorm folds into its producing
   Conv2D (``contrib.quantization.fold_batchnorm``): the per-channel
   scale lands in the conv weight ahead of weight quantization, and the
   BN shift becomes the conv bias, added in the int32 accumulator.
2. **Calibrated conversion** — ``quantize_net`` with requantize fusion:
   each bottleneck body (conv-relu-conv-relu-conv after the fold)
   becomes ONE ``QuantizedChain`` (on the card, one ``qconv_s8`` launch a
   conv, each requantizing in its epilogue); the residual add stays
   float32 at block boundaries (the junction mixes two ranges).

The returned net serves through ``InferenceEngine.load_model`` like any
HybridBlock, or pass ``quantize={"calib_data": ..., "fold_bn": True}`` to
``load_model`` and let the engine run this recipe at load.
"""
from __future__ import annotations

__all__ = ["quantize_vision_net"]


def quantize_vision_net(net, calib_data=None, calib_mode: str = "entropy",
                        exclude=None, fuse=None, thresholds=None,
                        num_calib_batches: int = 4):
    """Fold BatchNorm and convert ``net`` to calibrated int8 inference,
    in place. ``calib_data``: iterable of representative input batches
    (NCHW). ``thresholds``: a saved ``get_thresholds`` dict to skip
    calibration (the deploy-time path). Returns the net."""
    from ....contrib.quantization import fold_batchnorm, quantize_net
    fold_batchnorm(net)
    return quantize_net(net, calib_data=calib_data, calib_mode=calib_mode,
                        exclude=exclude, fuse=fuse, thresholds=thresholds,
                        num_calib_batches=num_calib_batches)
