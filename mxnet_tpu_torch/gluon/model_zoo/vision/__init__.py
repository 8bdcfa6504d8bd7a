"""Vision model zoo (counterpart of `mxnet_tpu/gluon/model_zoo/vision/`):
ResNet, AlexNet, VGG, SqueezeNet, MobileNet v1/v2, DenseNet and
Inception v3, with the reference's `get_model` names, the dotted
aliases (``mobilenetv2_1.0``, ``squeezenet1.1``, ``inceptionv3``, ...)
among them."""
from .resnet import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .alexnet import __all__ as _alexnet_all
from .vgg import __all__ as _vgg_all
from .squeezenet import __all__ as _squeezenet_all
from .mobilenet import __all__ as _mobilenet_all
from .densenet import __all__ as _densenet_all
from .inception import __all__ as _inception_all

_models = {name: globals()[name]
           for name in (_resnet_all + _alexnet_all + _vgg_all +
                        _squeezenet_all + _mobilenet_all + _densenet_all +
                        _inception_all)
           if name[0].islower() and not name.startswith("get_")}
_models.update({
    "mobilenetv2_1.0": mobilenet_v2_1_0,  # noqa: F405
    "mobilenetv2_0.75": mobilenet_v2_0_75,  # noqa: F405
    "mobilenetv2_0.5": mobilenet_v2_0_5,  # noqa: F405
    "mobilenetv2_0.25": mobilenet_v2_0_25,  # noqa: F405
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "mobilenet1.0": mobilenet1_0,  # noqa: F405
    "mobilenet0.75": mobilenet0_75,  # noqa: F405
    "mobilenet0.5": mobilenet0_5,  # noqa: F405
    "mobilenet0.25": mobilenet0_25,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
})


def get_model(name, pretrained=False, ctx=None, root=None, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ``"mobilenetv2_1.0"``,
    ...).  ``pretrained=True`` raises: no weights ship with the port."""
    key = name.lower()
    if key not in _models:
        raise ValueError(f"Model {name} is not supported by the port's zoo. "
                         f"Available: {sorted(_models)}")
    return _models[key](pretrained=pretrained, **kwargs)


__all__ = [n for n in _models if "." not in n] + ["get_model"]
