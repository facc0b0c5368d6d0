"""ResNet-50 in plain ``torch.nn``: the port's workload model for deferred
init on a convolutional network (BASELINE config 2, "deferred_init
resnet50, materialize on a single chip").

The port's own copy of ``torchdistx_tpu/models/resnet_torch.py``: a
standard ResNet-50 (He et al. 2015, arXiv:1512.03385) with torchvision's
module types (Conv2d, BatchNorm2d, Linear, pooling) and their default
initialization (kaiming-uniform convolutions, batch norm ones and zeros,
uniform linear), so the tape that ``deferred_init`` records has the shape
of torchvision's.  Build it under
:func:`~torchdistx_tpu_torch.deferred_init.deferred_init` and materialize
it with :func:`~torchdistx_tpu_torch.materialize.materialize_module_torch`
(seeded, onto the card) or ``materialize_module``.
"""

from __future__ import annotations

import torch.nn as nn

__all__ = ["resnet50", "Bottleneck", "ResNet"]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, layers: list[int], num_classes: int = 1000):
        super().__init__()
        self.in_ch = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0])
        self.layer2 = self._make_layer(128, layers[1], stride=2)
        self.layer3 = self._make_layer(256, layers[2], stride=2)
        self.layer4 = self._make_layer(512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512 * Bottleneck.expansion, num_classes)

    def _make_layer(self, width: int, blocks: int, stride: int = 1):
        downsample = None
        out_ch = width * Bottleneck.expansion
        if stride != 1 or self.in_ch != out_ch:
            downsample = nn.Sequential(
                nn.Conv2d(self.in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch),
            )
        layers = [Bottleneck(self.in_ch, width, stride, downsample)]
        self.in_ch = out_ch
        layers += [Bottleneck(out_ch, width) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(x)


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes)
