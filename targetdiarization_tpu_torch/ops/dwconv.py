"""Depthwise and grouped-to-one 1-D convolution, time-major.

Counterpart of targetdiarization_tpu/ops/dwconv.py::dw_conv1d. On the
main path every depthwise conv outside the FFConvM kernel is at most 512
channels wide (the FSMN's 39-tap dilated convs at 256), where the JAX
package also leaves the op to its compiler, so this is plain PyTorch.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def dw_conv1d(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1,
              padding: Union[str, Sequence[int]] = "SAME") -> torch.Tensor:
    """out[..., t, c] = sum_i sum_j kernel[i, j, c] * x[..., t + i*dilation - pad_l, c*m + j].

    x: (B, T, Cin) or (T, Cin) with Cin = m * C; kernel: (K, m, C), the
    flax grouped-conv layout (group c reads input channels c*m .. c*m+m-1).
    padding: "SAME" or explicit (pad_l, pad_r) zero padding of time.
    """
    k, m, c = kernel.shape
    if x.shape[-1] != m * c:
        raise ValueError(f"input has {x.shape[-1]} channels, kernel wants {m * c}")
    span = (k - 1) * dilation
    if isinstance(padding, str):
        if padding.upper() != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        pad_l, pad_r = span // 2, span - span // 2
    else:
        pad_l, pad_r = padding
    squeeze = x.dim() == 2
    xb = x[None] if squeeze else x
    xt = F.pad(xb.transpose(1, 2), (pad_l, pad_r))  # (B, Cin, T + pads)
    w = kernel.permute(2, 1, 0).to(x.dtype)          # (C, m, K): torch grouped layout
    out = F.conv1d(xt, w, dilation=dilation, groups=c).transpose(1, 2)
    return out[0] if squeeze else out
