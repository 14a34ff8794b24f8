"""Depthwise and grouped-to-one 1-D convolution, time-major.

Counterpart of targetdiarization_tpu/ops/dwconv.py::dw_conv1d. Every call
goes to `ops.kernels.dwconv`: on the card that is the CUDA kernel for
every shape the models use (the separator's FSMN memory, the SAN-M
memory of the Paraformer, the VAD's memory), on the CPU its plain
version. This function only resolves the padding and the unbatched form.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .kernels.dwconv import Taps, dwconv


def dw_conv1d(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1,
              padding: Union[str, Sequence[int]] = "SAME",
              taps: Optional[Taps] = None) -> torch.Tensor:
    """out[..., t, c] = sum_i sum_j kernel[i, j, c] * x[..., t + i*dilation - pad_l, c*m + j].

    x: (B, T, Cin) or (T, Cin) with Cin = m * C; kernel: (K, m, C), the
    flax grouped-conv layout (group c reads input channels c*m .. c*m+m-1).
    padding: "SAME" or explicit (pad_l, pad_r) zero padding of time.
    taps: the kernel made once for the card (`prepare_taps`), which a CUDA
    x needs; the CPU reads `kernel`.
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
        pad_l, pad_r = (int(p) for p in padding)
    squeeze = x.dim() == 2
    xb = x[None] if squeeze else x
    out = dwconv(xb.contiguous(), kernel, dilation, pad_l, pad_r, taps=taps)
    return out[0] if squeeze else out
