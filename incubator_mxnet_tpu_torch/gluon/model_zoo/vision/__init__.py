"""Vision model zoo (ref: python/mxnet/gluon/model_zoo/vision/__init__.py).

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/``: every
family of the reference (ResNet, VGG, AlexNet, DenseNet, SqueezeNet,
Inception V3, MobileNet v1/v2) and ``quantize_vision_net`` (the int8
conversion), with ``get_model`` over the reference's names."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .quantized import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from . import resnet as _resnet
from . import vgg as _vgg


def get_model(name, **kwargs):
    """Get a model by name (ref: vision/__init__.py:get_model)."""
    models = {f"resnet{n}_v{v}": getattr(_resnet, f"resnet{n}_v{v}")
              for n in (18, 34, 50, 101, 152) for v in (1, 2)}
    models.update({f"vgg{n}{bn}": getattr(_vgg, f"vgg{n}{bn}")
                   for n in (11, 13, 16, 19) for bn in ("", "_bn")})
    # (the family modules' names are shadowed by their star-imported
    # functions here, as in the reference's package)
    models.update({"alexnet": alexnet, "densenet121": densenet121,
                   "densenet161": densenet161, "densenet169": densenet169,
                   "densenet201": densenet201,
                   "squeezenet1.0": squeezenet1_0,
                   "squeezenet1.1": squeezenet1_1,
                   "inceptionv3": inception_v3})
    for m in ("1.0", "0.75", "0.5", "0.25"):
        tag = m.replace(".", "_")
        models[f"mobilenet{m}"] = globals()[f"mobilenet{tag}"]
        models[f"mobilenetv2_{m}"] = globals()[f"mobilenet_v2_{tag}"]
    name = name.lower()
    if name not in models:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t"
            + "\n\t".join(sorted(models.keys())))
    return models[name](**kwargs)
