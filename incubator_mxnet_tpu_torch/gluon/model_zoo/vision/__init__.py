"""Vision models of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py``; reference
python/mxnet/gluon/model_zoo/vision/__init__.py): ResNet V1 and V2
(tensor-level modules with a Gluon surface), and VGG, AlexNet,
DenseNet, SqueezeNet, Inception V3, Inception-BN and MobileNet as Gluon
``HybridBlock``s named as the JAX package names them, so that their
``.params`` files load either way.  ``get_model(name)`` builds any of
the 31 by name; ``pretrained=True`` raises, as nothing is downloaded."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .inception_bn import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet_spec)
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
import sys as _sys

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "inceptionbn": inception_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
}


def get_model(name, **kwargs):
    """Build a zoo model by name, with its constructor's keywords
    (``classes``, ``fuse_bn_relu`` ...)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t"
            + "\n\t".join(sorted(_MODELS.keys())))
    return _MODELS[name](**kwargs)


__all__ = (["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
            "ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
            "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
            "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
            "resnet152_v2", "resnet_spec", "get_model"]
           + [n for m in ("alexnet", "densenet", "inception", "inception_bn",
                          "mobilenet", "squeezenet", "vgg")
              for n in _sys.modules[f"{__name__}.{m}"].__all__])
