"""FFConvM: row norm -> dense + bias -> SiLU -> h + 17-tap depthwise conv of h.

Counterpart of targetdiarization_tpu/ops/pallas/ffconvm.py. The kernel is
`csrc/ffconvm.cu`; `ffconvm_plain` is the same function in plain PyTorch.
Both follow the TPU kernel's arithmetic: the normalised row is rounded to
x's type before the product, h stays float32 through the conv, and the
output is in x's type. Rows outside [0, T) add zero to the conv; in-array
rows add silu(bias) whatever the model's mask says.

`FFConvMFn` is the gradient, as the JAX package's custom VJP takes it:
the forward launches the kernel on the prepared operands, the backward
recomputes the plain version from x and the live weights under autograd.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import check_fresh, count_launch, grads_by_recompute
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


def ffconvm_plain(x, na, nb, weight, bias, dwk, norm: str = "scalenorm",
                  grouped: bool = False):
    """x (B, T, cin); weight (cout, cin) and bias (cout,) of a Linear;
    dwk (17, 1, cout); na, nb: ScaleNorm g (1,) and anything, or
    LayerNorm weight and bias (cin,). `grouped` takes the 17 taps as one
    grouped `F.conv1d` instead of 17 shifted products: the same sums, and
    under autograd one saved input instead of one gradient buffer a tap."""
    y = _norm_f32(x, na, nb, norm).to(x.dtype).float()
    h = F.silu(y @ weight.to(x.dtype).float().T + bias.to(x.dtype).float())
    k = dwk.shape[0]
    pad_l = (k - 1) // 2
    w = dwk.to(x.dtype).float()
    if grouped:
        conv = F.conv1d(F.pad(h.transpose(-1, -2), (pad_l, k - 1 - pad_l)),
                        w.permute(2, 1, 0), groups=w.shape[2])
        return (h + conv.transpose(-1, -2)).to(x.dtype)
    hp = F.pad(h, (0, 0, pad_l, k - 1 - pad_l))
    t = h.shape[-2]
    acc = h
    for i in range(k):
        acc = acc + hp[..., i:i + t, :] * w[i, 0]
    return acc.to(x.dtype)


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t = hi + lo + r with hi = bf16(t), lo = bf16(t - hi) and |r| at most
    about 2^-18 |t|: float32 operands as two bf16 halves for the tensor cores."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


class FFConvMOperands(NamedTuple):
    """The kernel's operands of one FFConvM, made once for one activation
    type on one card: W as bf16 (cout, cin) halves (w_lo None when W is
    bf16-exact in that type, so its pass is skipped), and the norm and
    bias vectors and the (17, cout) taps in float32, rounded to the
    activation type as `ffconvm_plain` rounds them. They are copies: the
    model's weights are frozen once its engine has made them, and a model
    loaded, moved or cast afterwards needs them made again, and so do
    weights changed in place: `sources` are the tensors they were made from
    and `versions` their versions then, and on the card a call after an
    in-place change raises, naming `owner`, the module."""

    dtype: torch.dtype
    layernorm: bool
    w_hi: torch.Tensor
    w_lo: torch.Tensor | None
    na: torch.Tensor
    nb: torch.Tensor
    bias: torch.Tensor
    dwk: torch.Tensor
    sources: tuple = ()
    versions: tuple = ()
    owner: str = ""

    def tracked(self):
        return zip(self.sources, self.versions)


def prepare_ffconvm(na, nb, weight, bias, dwk, norm: str, dtype: torch.dtype,
                    device=None, owner: str = "") -> FFConvMOperands:
    """The kernel's operands for activations of `dtype` (float32 or
    bfloat16) on `device` (default: the weight's); raises on a shape the
    kernel cannot take."""
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
    if dtype not in _TYPES:
        raise TypeError(f"ffconvm kernel takes float32 or bfloat16, got {dtype}")
    cout, cin = weight.shape
    if cin % 8 or cout % 8:
        raise ValueError(f"weight must be (cout, cin) with cin and cout multiples of 8, "
                         f"got {tuple(weight.shape)}")
    if tuple(dwk.shape) != (TAPS, 1, cout):
        raise ValueError(f"dwk must be ({TAPS}, 1, {cout}), got {tuple(dwk.shape)}")
    device = weight.device if device is None else torch.device(device)

    def f32(a, *shape):
        return a.detach().to(device=device, dtype=dtype).float().reshape(*shape).contiguous()

    w_hi, w_lo = split_bf16(weight.detach().to(device=device, dtype=dtype))
    sources = tuple(t for t in (na, nb, weight, bias, dwk) if not t.is_inference())
    return FFConvMOperands(dtype, norm == "layernorm", w_hi.contiguous(),
                           w_lo.contiguous() if bool(w_lo.any()) else None, f32(na, -1),
                           f32(nb, -1), f32(bias, -1), f32(dwk, TAPS, -1), sources,
                           tuple(t._version for t in sources), owner)


_TYPES = (torch.float32, torch.bfloat16)
_fn = declare("td_ffconvm", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_prepared(x, ops: FFConvMOperands | None, norm: str) -> None:
    """Attribute reads only: the operands were made for x's type, card and
    width, from the weights as they are now."""
    if ops is None:
        raise ValueError("ffconvm on the card takes operands made once by prepare_ffconvm "
                         "(engines make them with ops.kernels.prepare_kernels)")
    if ops.dtype != x.dtype or ops.w_hi.get_device() != x.get_device() \
            or ops.layernorm != (norm == "layernorm"):
        raise ValueError(f"ffconvm operands were prepared for {ops.dtype} "
                         f"{'layernorm' if ops.layernorm else 'scalenorm'} on "
                         f"{ops.w_hi.device}, called with {x.dtype} {norm} on {x.device}")
    if x.dim() != 3 or not x.is_contiguous() or ops.w_hi.shape[1] != x.shape[-1]:
        raise ValueError(f"x must be a contiguous (B, T, {ops.w_hi.shape[1]}) tensor, got "
                         f"{tuple(x.shape)}")
    check_fresh(ops)


def _forward(x, na, nb, weight, bias, dwk, norm, prepared):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ffconvm_plain(x, na, nb, weight, bias, dwk, norm)
        raise RuntimeError(f"ffconvm runs on cpu or cuda, not {x.device}")
    _check_prepared(x, prepared, norm)
    b, t, cin = x.shape
    cout = prepared.w_hi.shape[0]
    stats = torch.empty(b * t, 2, device=x.device, dtype=torch.float32)
    out = torch.empty(b, t, cout, device=x.device, dtype=x.dtype)
    w_lo = prepared.w_lo
    _fn(x.get_device(), x.data_ptr(), prepared.na.data_ptr(), prepared.nb.data_ptr(),
        prepared.w_hi.data_ptr(), None if w_lo is None else w_lo.data_ptr(),
        prepared.bias.data_ptr(), prepared.dwk.data_ptr(), stats.data_ptr(), out.data_ptr(),
        b, t, cin, cout, int(prepared.layernorm), EPS, cin ** -0.5 * cin ** -0.5,
        int(x.dtype == torch.bfloat16))
    count_launch(ffconvm)
    return out


class FFConvMFn(torch.autograd.Function):
    """ffconvm with the JAX package's gradient rule (`_ff_bwd`): the
    backward recomputes `ffconvm_plain` (its taps as one grouped conv) from
    x and the live weights, not from the prepared copies."""

    @staticmethod
    def forward(ctx, x, na, nb, weight, bias, dwk, norm, prepared):
        ctx.norm = norm
        ctx.save_for_backward(x, na, nb, weight, bias, dwk)
        return _forward(x, na, nb, weight, bias, dwk, norm, prepared)

    @staticmethod
    def backward(ctx, g):
        norm = ctx.norm
        grads = grads_by_recompute(
            lambda *a: ffconvm_plain(*a, norm=norm, grouped=True), ctx.saved_tensors,
            ctx.needs_input_grad[:6], g)
        return (*grads, None, None)


def ffconvm(x, na, nb, weight, bias, dwk, norm: str = "scalenorm",
            prepared: FFConvMOperands | None = None):
    """Fused FFConvM. CPU tensors run `ffconvm_plain` on the weights given;
    CUDA tensors launch the kernel (float32 or bfloat16, float32
    accumulation) on the `prepared` operands alone (`prepare_ffconvm`),
    which the model made once, and raise without them or after a weight
    changed in place. Where autograd records the call goes through
    `FFConvMFn`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, na, nb, weight, bias, dwk)):
        return FFConvMFn.apply(x, na, nb, weight, bias, dwk, norm, prepared)
    return _forward(x, na, nb, weight, bias, dwk, norm, prepared)


ffconvm.launches = 0
