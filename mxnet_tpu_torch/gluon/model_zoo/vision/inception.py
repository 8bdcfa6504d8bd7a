"""Inception v3 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/inception.py`): mixed blocks of
parallel conv towers concatenated on channels; 299 x 299 input."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _Concurrent():
    """Parallel branches concatenated on channels (the reference's
    HybridConcurrent — here the shared nn.HybridConcatenate)."""
    return nn.HybridConcatenate(axis=1)


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B():
    out = _Concurrent()
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7):
    out = _Concurrent()
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D():
    out = _Concurrent()
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)),
                         (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _SplitConcat(stem, left_setting, right_setting):
    """One conv stem followed by two parallel convs whose outputs concat."""
    out = nn.HybridSequential()
    if stem is not None:
        out.add(stem)
    split = nn.HybridConcatenate(axis=1)
    split.add(_make_branch(None, left_setting))
    split.add(_make_branch(None, right_setting))
    out.add(split)
    return out


def _make_E():
    out = _Concurrent()
    out.add(_make_branch(None, (320, 1, None, None)))
    out.add(_SplitConcat(_make_branch(None, (384, 1, None, None)),
                         (384, (1, 3), None, (0, 1)),
                         (384, (3, 1), None, (1, 0))))
    out.add(_SplitConcat(_make_branch(None, (448, 1, None, None),
                                      (384, 3, None, 1)),
                         (384, (1, 3), None, (0, 1)),
                         (384, (3, 1), None, (1, 0))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))

        self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not shipped; carry weights across with "
            "utils.convert.load_reference_params")
    return net
