"""Vision model zoo (ref: python/mxnet/gluon/model_zoo/vision/__init__.py).

The port has the ResNet and VGG families and ``quantize_vision_net``
(the int8 conversion); the other families of the reference (AlexNet,
DenseNet, SqueezeNet, Inception, MobileNet) are ROADMAP.md A6 and
``get_model`` raises for them."""
from .quantized import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from . import resnet as _resnet
from . import vgg as _vgg

_NOT_PORTED = ("alexnet", "densenet121", "densenet161", "densenet169",
               "densenet201", "squeezenet1.0", "squeezenet1.1",
               "inceptionv3", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
               "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
               "mobilenetv2_0.5", "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Get a model by name (ref: vision/__init__.py:get_model)."""
    models = {f"resnet{n}_v{v}": getattr(_resnet, f"resnet{n}_v{v}")
              for n in (18, 34, 50, 101, 152) for v in (1, 2)}
    models.update({f"vgg{n}{bn}": getattr(_vgg, f"vgg{n}{bn}")
                   for n in (11, 13, 16, 19) for bn in ("", "_bn")})
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"get_model({name!r}): only the ResNet and VGG families are "
            "ported; the other vision families are ROADMAP.md A6")
    if name not in models:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t"
            + "\n\t".join(sorted(models.keys() | set(_NOT_PORTED))))
    return models[name](**kwargs)
