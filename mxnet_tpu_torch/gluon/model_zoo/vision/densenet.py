"""DenseNet 121/161/169/201 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/densenet.py`): each dense layer's
features concatenated onto its input along the channels (axis 1)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _make_dense_layer(growth_rate, bn_size, dropout):
    # identity ∥ BN-relu-conv body, concatenated on channels — the same
    # shape the reference builds with HybridConcurrent + Identity
    body = nn.HybridSequential()
    body.add(nn.BatchNorm())
    body.add(nn.Activation("relu"))
    body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False))
    body.add(nn.BatchNorm())
    body.add(nn.Activation("relu"))
    body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
    if dropout:
        body.add(nn.Dropout(dropout))
    out = nn.HybridConcatenate(axis=1)
    out.add(nn.Identity())
    out.add(body)
    return out


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    out = nn.HybridSequential()
    for _ in range(num_layers):
        out.add(_make_dense_layer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                    strides=2, padding=3, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))

        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(_make_transition(num_features // 2))
                num_features = num_features // 2
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.AvgPool2D(pool_size=7))
        self.features.add(nn.Flatten())

        self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


# num_init_features, growth_rate, block_config
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                  **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not shipped; carry weights across with "
            "utils.convert.load_reference_params")
    return net


def densenet121(**kwargs):
    return _get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return _get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return _get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return _get_densenet(201, **kwargs)
