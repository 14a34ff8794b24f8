"""Depthwise (grouped-to-one) 1-D convolution over time.

Counterpart of targetdiarization_tpu/ops/pallas/dwconv.py::
dw_conv1d_pallas. The kernel is `csrc/dwconv.cu`; `dwconv_plain` is the
same function in plain PyTorch (`F.conv1d` with groups=C). Both sum in
float32 for float32 or bfloat16 inputs (`F.conv1d` on bfloat16 is the
library's own accumulation) and return x's type.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import declare

# mirrors csrc/dwconv.cu: 64 output rows by 32 channels a block, input
# rows plus halo and the weights in shared memory as float32
ROWS, CHANNELS = 64, 32
MAX_SMEM = 232448


def smem_bytes(k: int, m: int, dilation: int) -> int:
    return ((ROWS + (k - 1) * dilation) * CHANNELS * m + k * m * CHANNELS) * 4


def dwconv_plain(x, kernel, dilation: int, pad_l: int, pad_r: int):
    """x (B, T, C*m); kernel (K, m, C), group c reading input channels
    c*m .. c*m+m-1. Returns (B, T + pad_l + pad_r - (K-1)*dilation, C)."""
    c = kernel.shape[2]
    xt = F.pad(x.transpose(1, 2), (pad_l, pad_r))   # (B, C*m, T + pads)
    w = kernel.permute(2, 1, 0).to(x.dtype)          # (C, m, K): torch grouped layout
    return F.conv1d(xt, w, dilation=dilation, groups=c).transpose(1, 2)


_fn = declare("td_dwconv", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _check(x, kernel, dilation, pad_l, pad_r) -> int:
    """Validates a CUDA call; returns T_out."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dwconv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, C*m) tensor, got {tuple(x.shape)}")
    if kernel.dim() != 3:
        raise ValueError(f"kernel must be (K, m, C), got {tuple(kernel.shape)}")
    k, m, c = kernel.shape
    if x.shape[-1] != m * c:
        raise ValueError(f"x has {x.shape[-1]} channels, kernel {tuple(kernel.shape)} "
                         f"wants {m * c}")
    if dilation < 1 or pad_l < 0 or pad_r < 0:
        raise ValueError(f"bad dilation {dilation} or padding ({pad_l}, {pad_r})")
    if smem_bytes(k, m, dilation) > MAX_SMEM:
        raise ValueError(f"dwconv kernel cannot take K {k}, m {m}, dilation {dilation}: "
                         f"its tile needs {smem_bytes(k, m, dilation)} bytes of shared memory")
    t_out = x.shape[1] + pad_l + pad_r - (k - 1) * dilation
    if t_out <= 0:
        raise ValueError(f"no output rows: T {x.shape[1]}, pads ({pad_l}, {pad_r}), "
                         f"span {(k - 1) * dilation}")
    return t_out


def dwconv(x, kernel, dilation: int = 1, pad_l: int = 0, pad_r: int = 0):
    """Depthwise conv of x (B, T, C*m) with kernel (K, m, C). CPU tensors run
    `dwconv_plain`; CUDA tensors launch the kernel (float32 or bfloat16;
    the kernel is cast to x's type)."""
    if x.device.type == "cpu":
        return dwconv_plain(x, kernel, dilation, pad_l, pad_r)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv runs on cpu or cuda, not {x.device}")
    t_out = _check(x, kernel, dilation, pad_l, pad_r)
    k, m, c = kernel.shape
    b, t = x.shape[0], x.shape[1]
    w = kernel.detach().to(device=x.device, dtype=x.dtype).contiguous()
    out = torch.empty(b, t_out, c, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, t, t_out, c, m, k,
                    dilation, pad_l, int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"td_dwconv failed with CUDA error {err}")
    dwconv.launches += 1
    return out


dwconv.launches = 0
