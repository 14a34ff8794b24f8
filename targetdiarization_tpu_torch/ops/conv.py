"""flax's convolution and dense conventions, for the ported models.

flax's `padding="SAME"` on a strided convolution pads
total = max((ceil(n / s) - 1)·s + (k - 1)·d + 1 − n, 0) samples, total // 2
on the left and the rest on the right: asymmetric for even n, which a
symmetric `padding=` of torch's convolutions gets wrong. flax adds the
bias after the product, in the product's type: in bf16 the product is
rounded first, which torch's fused bias does not do, so these layers add
it apart. flax's `nn.gelu` is the tanh approximation.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(left, right) padding of flax's "SAME" along an axis of length n."""
    total = max((-(-n // stride) - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def gelu(x):
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _add_bias(y, bias, spatial: int):
    return y if bias is None else y + bias.reshape(-1, *([1] * spatial))


class Conv1dSame(nn.Conv1d):
    """flax Conv over (B, C, T): "SAME" padding, the bias added apart."""

    def forward(self, x):
        pads = same_pads(x.shape[-1], self.kernel_size[0], self.stride[0], self.dilation[0])
        y = F.conv1d(F.pad(x, pads), self.weight, None, self.stride, 0, self.dilation)
        return _add_bias(y, self.bias, 1)


class Conv2dSame(nn.Conv2d):
    """flax Conv over (B, C, H, W): "SAME" padding, the bias added apart."""

    def forward(self, x):
        ph = same_pads(x.shape[-2], self.kernel_size[0], self.stride[0], self.dilation[0])
        pw = same_pads(x.shape[-1], self.kernel_size[1], self.stride[1], self.dilation[1])
        y = F.conv2d(F.pad(x, (*pw, *ph)), self.weight, None, self.stride, 0, self.dilation)
        return _add_bias(y, self.bias, 2)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ConvTranspose with kernel = stride ("SAME" pads nothing there;
    the converter flips the kernel), the bias added apart."""

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight, None, self.stride)
        return _add_bias(y, self.bias, 2)


class Dense(nn.Linear):
    """flax Dense: the bias added apart."""

    def forward(self, x):
        return _add_bias(F.linear(x, self.weight), self.bias, 0)
