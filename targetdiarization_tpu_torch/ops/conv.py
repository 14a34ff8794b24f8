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


def transpose_pads(k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of the stride-dilated input in flax's
    ConvTranspose with "SAME" (lax's `_conv_transpose_padding`): k + s - 2
    in all, k - 1 before where s > k - 1, else the larger half before."""
    total = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-total // 2)
    return before, total - before


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ConvTranspose with "SAME" padding (the converter flips the
    kernel), the bias added apart. lax pads the dilated input by
    `transpose_pads` on each axis; torch's transposed conv with padding p
    pads it by k - 1 - p on both sides, so p takes the larger pad and the
    output is cropped where the other side's pad is smaller. Kernel =
    stride pads nothing; a 4x4 kernel of stride 2 pads 1 on both sides."""

    def forward(self, x):
        padding, crops = [], []
        for k, s in zip(self.kernel_size, self.stride):
            before, after = transpose_pads(k, s)
            if max(before, after) > k - 1:
                raise ValueError(f"kernel {k} with stride {s} pads past the kernel")
            padding.append(k - 1 - max(before, after))
            crops.append((max(before, after) - before, max(before, after) - after))
        y = F.conv_transpose2d(x, self.weight, None, self.stride, tuple(padding))
        (h0, h1), (w0, w1) = crops
        if h0 or h1 or w0 or w1:
            y = y[..., h0: y.shape[-2] - h1, w0: y.shape[-1] - w1]
        return _add_bias(y, self.bias, 2)


class Dense(nn.Linear):
    """flax Dense: the bias added apart."""

    def forward(self, x):
        return _add_bias(F.linear(x, self.weight), self.bias, 0)
