"""SqueezeNet 1.0/1.1 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/squeezenet.py`): fire modules of a
squeeze 1x1 conv and 1x1 | 3x3 expand convs concatenated on channels;
ceil-mode pools, as the reference."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(_make_fire_conv(squeeze_channels, 1))
    expand = nn.HybridConcatenate(axis=1)
    expand.add(_make_fire_conv(expand1x1_channels, 1))
    expand.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(expand)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        assert version in ("1.0", "1.1"), (
            "Unsupported SqueezeNet version {}: 1.0 or 1.1 expected"
            .format(version))
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))

        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1))
        self.output.add(nn.Activation("relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def squeezenet1_0(**kwargs):
    return _get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return _get_squeezenet("1.1", **kwargs)


def _get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not shipped; carry weights across with "
            "utils.convert.load_reference_params")
    return net
