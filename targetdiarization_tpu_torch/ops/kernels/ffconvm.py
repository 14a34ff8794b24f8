"""FFConvM: row norm -> dense + bias -> SiLU -> h + 17-tap depthwise conv of h.

Counterpart of targetdiarization_tpu/ops/pallas/ffconvm.py. The kernel is
`csrc/ffconvm.cu`; `ffconvm_plain` is the same function in plain PyTorch.
Both follow the TPU kernel's arithmetic: the normalised row is rounded to
x's type before the product, h stays float32 through the conv, and the
output is in x's type. Rows outside [0, T) add zero to the conv; in-array
rows add silu(bias) whatever the model's mask says.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import declare

TAPS = 17
NORMS = ("scalenorm", "layernorm")
EPS = 1e-5


def scale_norm(x: torch.Tensor, g: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x / max(||x|| d^-1/2, eps) * g, written NaN-free as sqrt(max(ss/d, eps^2))."""
    scale = x.shape[-1] ** -0.5
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(ss * (scale * scale), eps * eps)) * g


def _norm_f32(x: torch.Tensor, na: torch.Tensor, nb: torch.Tensor, norm: str) -> torch.Tensor:
    xf = x.float()
    na = na.to(x.dtype).float()
    if norm == "scalenorm":
        return scale_norm(xf, na)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + EPS) * na + nb.to(x.dtype).float()


def ffconvm_plain(x, na, nb, weight, bias, dwk, norm: str = "scalenorm"):
    """x (B, T, cin); weight (cout, cin) and bias (cout,) of a Linear;
    dwk (17, 1, cout); na, nb: ScaleNorm g (1,) and anything, or
    LayerNorm weight and bias (cin,)."""
    y = _norm_f32(x, na, nb, norm).to(x.dtype).float()
    h = F.silu(y @ weight.to(x.dtype).float().T + bias.to(x.dtype).float())
    k = dwk.shape[0]
    pad_l = (k - 1) // 2
    hp = F.pad(h, (0, 0, pad_l, k - 1 - pad_l))
    t = h.shape[-2]
    w = dwk.to(x.dtype).float()
    acc = h
    for i in range(k):
        acc = acc + hp[..., i:i + t, :] * w[i, 0]
    return acc.to(x.dtype)


_fn = declare("td_ffconvm", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check(x, weight, dwk, norm):
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffconvm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, cin) tensor, got {tuple(x.shape)}")
    cout, cin = weight.shape
    if cin != x.shape[-1] or weight.dtype != x.dtype or not weight.is_contiguous() \
            or weight.device != x.device:
        raise ValueError(f"weight must be a contiguous ({cout}, {x.shape[-1]}) {x.dtype} "
                         f"tensor on {x.device}")
    if tuple(dwk.shape) != (TAPS, 1, cout):
        raise ValueError(f"dwk must be ({TAPS}, 1, {cout}), got {tuple(dwk.shape)}")


def ffconvm(x, na, nb, weight, bias, dwk, norm: str = "scalenorm"):
    """Fused FFConvM. CPU tensors run `ffconvm_plain`; CUDA tensors launch
    the kernel (float32 or bfloat16, float32 accumulation)."""
    if x.device.type == "cpu":
        return ffconvm_plain(x, na, nb, weight, bias, dwk, norm)
    if x.device.type != "cuda":
        raise RuntimeError(f"ffconvm runs on cpu or cuda, not {x.device}")
    _check(x, weight, dwk, norm)
    b, t, cin = x.shape
    cout = weight.shape[0]
    small = [a.detach().to(device=x.device, dtype=x.dtype).contiguous().reshape(-1)
             for a in (na, nb, bias, dwk)]
    stats = torch.empty(b * t, 2, device=x.device, dtype=torch.float32)
    out = torch.empty(b, t, cout, device=x.device, dtype=x.dtype)
    scale = cin ** -0.5
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), small[0].data_ptr(), small[1].data_ptr(), weight.data_ptr(),
                    small[2].data_ptr(), small[3].data_ptr(), stats.data_ptr(), out.data_ptr(),
                    b, t, cin, cout, int(norm == "layernorm"), EPS, scale * scale,
                    int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"td_ffconvm failed with CUDA error {err}")
    ffconvm.launches += 1
    return out


ffconvm.launches = 0
