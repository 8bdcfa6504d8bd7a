"""Vision model zoo (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/`): the ResNet family.  AlexNet, VGG,
SqueezeNet, MobileNet, DenseNet and Inception are not ported yet
(ROADMAP queue A)."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

_models = {name: globals()[name] for name in _resnet_all
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, pretrained=False, ctx=None, root=None, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ...)."""
    key = name.lower()
    if key not in _models:
        raise ValueError(f"Model {name} is not supported by the port's zoo. "
                         f"Available: {sorted(_models)}")
    return _models[key](pretrained=pretrained, **kwargs)


__all__ = list(_resnet_all) + ["get_model"]
