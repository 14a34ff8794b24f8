"""Depthwise (grouped-to-one) 1-D convolution over time.

Counterpart of targetdiarization_tpu/ops/pallas/dwconv.py::
dw_conv1d_pallas. The kernel is `csrc/dwconv.cu`; `dwconv_plain` is the
same function in plain PyTorch (`F.conv1d` with groups=C). Both sum in
float32 for float32 or bfloat16 inputs (`F.conv1d` on bfloat16 is the
library's own accumulation) and return x's type.

Gradients follow the JAX package's custom VJP (`_dw_bwd`): `DwconvFn`'s
backward takes dx at m = 1 by the kernel again, on the taps flipped in
time with the pads swapped to span - pad (`dwconv.backward_launches`
counts those launches); dx at m > 1 and dw are float32 sums per tap in
plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import check_fresh
from ._build import declare

# mirrors csrc/dwconv.cu: a block stages at most ROWS output rows (8 d
# when the dilation d is above 16) plus the (K-1) d halo rows of up to
# CHANNELS input channels, and its taps, K rounded up to a multiple of
# WINDOW, x CHANNELS as float32; the widest case is float32, 4 bytes an
# element (a second staging buffer is added only where it fits). Where
# that does not fit, phase tiles stage at most ROWS rows of one dilation
# phase plus K-1 halo rows, at any dilation up to MAX_DILATION.
ROWS, CHANNELS, WINDOW = 128, 128, 8
MAX_SMEM = 232448
MAX_DILATION = 1 << 16
# the kernel's channel vectors: m output-channel groups of 4 input channels,
# whole 16-byte copies of each row
KERNEL_M = (1, 2, 4)


def _tile_bytes(k: int, dilation: int) -> int:
    k_padded = -(-k // WINDOW) * WINDOW
    return ((max(ROWS, 8 * dilation) + (k - 1) * dilation) * CHANNELS + k_padded * CHANNELS) * 4


def _phase_tile_bytes(k: int) -> int:
    return ((ROWS + k - 1) * CHANNELS + -(-k // WINDOW) * WINDOW * CHANNELS) * 4


def phase_tiles(k: int, dilation: int) -> bool:
    """Whether the kernel runs this (K, dilation) on phase tiles: the
    dilated tile and its halo do not fit in shared memory."""
    return _tile_bytes(k, dilation) > MAX_SMEM


def smem_bytes(k: int, m: int, dilation: int) -> int:
    """The most shared memory a block takes for K taps at this dilation,
    dilated tiles where they fit and phase tiles elsewhere (m does not
    change it: a block's CHANNELS input channels are CHANNELS / m groups)."""
    return _phase_tile_bytes(k) if phase_tiles(k, dilation) else _tile_bytes(k, dilation)


def max_dilation(k: int) -> int:
    """The largest dilation the kernel takes at K taps (0: none)."""
    if _phase_tile_bytes(k) <= MAX_SMEM:
        return MAX_DILATION
    d = 0
    while _tile_bytes(k, d + 1) <= MAX_SMEM:
        d += 1
    return d


def _kernel_takes(m: int, cin: int, dtype: torch.dtype) -> bool:
    return m in KERNEL_M and cin % (16 // (2 if dtype is torch.bfloat16 else 4)) == 0


def dwconv_plain(x, kernel, dilation: int, pad_l: int, pad_r: int):
    """x (B, T, C*m); kernel (K, m, C), group c reading input channels
    c*m .. c*m+m-1. Returns (B, T + pad_l + pad_r - (K-1)*dilation, C)."""
    c = kernel.shape[2]
    xt = F.pad(x.transpose(1, 2), (pad_l, pad_r))   # (B, C*m, T + pads)
    w = kernel.permute(2, 1, 0).to(x.dtype)          # (C, m, K): torch grouped layout
    return F.conv1d(xt, w, dilation=dilation, groups=c).transpose(1, 2)


_TYPES = (torch.float32, torch.bfloat16)
# one block of 13 int64 values (csrc/dwconv.cu): at the ASR path's small
# shapes the host's cost per call sets the time, and ctypes converts one
# pointer faster than thirteen arguments (`tools/dwconv_call_cost.py`)
_fn = declare("td_dwconv", [ctypes.c_void_p], packed=13)


def _check(x, kernel, dilation, pad_l, pad_r) -> int:
    """Validates a CUDA call; returns T_out."""
    if x.dtype not in _TYPES:
        raise TypeError(f"dwconv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, C*m) tensor, got {tuple(x.shape)}")
    if kernel.dim() != 3:
        raise ValueError(f"kernel must be (K, m, C), got {tuple(kernel.shape)}")
    k, m, c = kernel.shape
    if x.shape[-1] != m * c:
        raise ValueError(f"x has {x.shape[-1]} channels, kernel {tuple(kernel.shape)} "
                         f"wants {m * c}")
    if kernel.dtype != x.dtype or kernel.get_device() != x.get_device() \
            or not kernel.is_contiguous():
        raise ValueError(f"the taps must be a contiguous (K, m, C) {x.dtype} tensor on "
                         f"{x.device}, got {kernel.dtype} on {kernel.device}: the module "
                         "that owns them holds them in the activation type")
    if not _kernel_takes(m, x.shape[-1], x.dtype):
        raise ValueError(f"dwconv kernel takes m in {KERNEL_M} and C*m a multiple of "
                         f"{16 // x.element_size()} for {x.dtype}, got m {m}, C*m {x.shape[-1]}")
    if dilation < 1 or pad_l < 0 or pad_r < 0:
        raise ValueError(f"bad dilation {dilation} or padding ({pad_l}, {pad_r})")
    if not 1 <= dilation <= max_dilation(k):
        raise ValueError(f"dwconv kernel cannot take K {k}, m {m}, dilation {dilation}: "
                         f"its tile needs {smem_bytes(k, m, dilation)} bytes of shared memory")
    t_out = x.shape[1] + pad_l + pad_r - (k - 1) * dilation
    if t_out <= 0:
        raise ValueError(f"no output rows: T {x.shape[1]}, pads ({pad_l}, {pad_r}), "
                         f"span {(k - 1) * dilation}")
    return t_out


class Taps(NamedTuple):
    """A conv's taps held once in the kernel's layout and type: `weight`
    (K, m, C) contiguous, in the activation type, on its card (device -1 on
    the CPU), with what a call needs read once: its shape, address, type
    flag, the largest dilation whose tile fits in shared memory, and
    whether the kernel takes this m and width in this type. The
    module that owns the taps makes them (`prepare_taps`) when its engine
    places it, so a call on the card validates x with a few attribute reads
    and copies nothing. The kernel reads the taps at `ptr`: the model's
    weights are frozen once they are made, and a model loaded, moved or
    cast afterwards needs them made again, and so does a weight changed in
    place: `source` is the tensor they were made from (None for an
    inference tensor, which keeps no version) and `version` its version
    then, and on the card a call after an in-place change raises, naming
    `owner`, the module."""

    weight: torch.Tensor
    shape: tuple
    dtype: torch.dtype
    device: int
    ptr: int
    is_bf16: int
    max_dilation: int
    kernel_ok: bool
    source: torch.Tensor | None = None
    version: int = 0
    owner: str = ""

    def tracked(self) -> tuple:
        return () if self.source is None else ((self.source, self.version),)


def prepare_taps(kernel: torch.Tensor, owner: str = "") -> Taps:
    if kernel.dim() != 3:
        raise ValueError(f"kernel must be (K, m, C), got {tuple(kernel.shape)}")
    w = kernel.detach().contiguous()
    k, m, c = w.shape
    source = None if kernel.is_inference() else kernel
    return Taps(w, (k, m, w.shape[2]), w.dtype, w.get_device(), w.data_ptr(),
                int(w.dtype is torch.bfloat16), max_dilation(k),
                _kernel_takes(m, m * c, w.dtype), source,
                0 if source is None else source._version, owner)


def _launch(x, taps: Taps, dilation: int, pad_l: int, pad_r: int):
    """One launch of the kernel on x (B, T, C*m) and prepared taps."""
    k, m, c = taps.shape
    b, t, cin = x.shape
    t_out = t + pad_l + pad_r - (k - 1) * dilation
    if not (taps.kernel_ok and x.dtype is taps.dtype and cin == m * c and x.is_contiguous()
            and x.get_device() == taps.device and t_out > 0
            and 1 <= dilation <= taps.max_dilation and pad_l >= 0 and pad_r >= 0
            and (taps.source is None or taps.source._version == taps.version)):
        _check(x, taps.weight, dilation, pad_l, pad_r)  # raises with the reason
        check_fresh(taps)
    # the output has x's shape for m 1 and SAME or (lorder, rorder) pads:
    # empty_like is the cheaper allocation on the host
    out = torch.empty_like(x) if t_out == t and m == 1 else \
        torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)
    _fn(taps.device, x.data_ptr(), taps.ptr, out.data_ptr(), b, t, t_out, c, m, k, dilation,
        pad_l, taps.is_bf16)
    return out


def _forward(x, kernel, dilation: int, pad_l: int, pad_r: int, taps: Taps | None):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dwconv_plain(x, kernel, dilation, pad_l, pad_r)
        raise RuntimeError(f"dwconv runs on cpu or cuda, not {x.device}")
    if taps is None:
        raise ValueError("dwconv on the card takes taps made once by prepare_taps "
                         "(engines make them with ops.kernels.prepare_kernels)")
    out = _launch(x, taps, dilation, pad_l, pad_r)
    dwconv.launches += 1
    return out


def _dx(g, w, dilation: int, pad_l: int, pad_r: int, t: int):
    """dx of the conv for the output gradient g (B, T_out, C) and taps w:
    x[s] received sum_i w[i] g[s + pad_l - i d], a conv of g with the taps
    flipped in time and pads span - pad_l, span - pad_r. At m = 1 that is
    the conv itself (the kernel on the card, its plain version on the CPU);
    at m > 1 a float32 sum per tap of g's shifted rows, per input group."""
    k, m, c = w.shape
    span = (k - 1) * dilation
    lp, rp = span - pad_l, span - pad_r
    if m > 1:
        gp = F.pad(g.float(), (0, 0, lp, rp))
        wt = w.float()
        acc = g.new_zeros((g.shape[0], t, c, m), dtype=torch.float32)
        for i in range(k):
            off = span - i * dilation
            acc += gp[:, off:off + t, :, None] * wt[i].T
        return acc.reshape(g.shape[0], t, c * m).to(g.dtype)
    if lp < 0 or rp < 0:  # pads above the span: the rows they add read nothing
        g = g[:, max(-lp, 0): g.shape[1] - max(-rp, 0)]
        lp, rp = max(lp, 0), max(rp, 0)
    flipped = w.flip(0).to(g.dtype).contiguous()
    if not g.is_cuda:
        return dwconv_plain(g, flipped, dilation, lp, rp)
    out = _launch(g.contiguous(), prepare_taps(flipped), dilation, lp, rp)
    dwconv.backward_launches += 1
    return out


def _dw(g, x, w, dilation: int, pad_l: int, pad_r: int):
    """dw[i, j, c] = sum over (b, t) of g[b, t, c] xp[b, t + i d, c m + j],
    in float32 a tap at a time, cast to w's type."""
    k, m, c = w.shape
    b, t_out = g.shape[:2]
    xp = F.pad(x.float(), (0, 0, pad_l, pad_r))
    g32 = g.float()
    return torch.stack([
        torch.einsum("btc,btcj->jc", g32,
                     xp[:, i * dilation: i * dilation + t_out].reshape(b, t_out, c, m))
        for i in range(k)]).to(w.dtype)


class DwconvFn(torch.autograd.Function):
    """dwconv with the JAX package's gradient rule (`_dw_bwd`)."""

    @staticmethod
    def forward(ctx, x, kernel, dilation, pad_l, pad_r, taps):
        ctx.save_for_backward(x, kernel)
        ctx.conv = (dilation, pad_l, pad_r)
        return _forward(x, kernel, dilation, pad_l, pad_r, taps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dilation, pad_l, pad_r = ctx.conv
        dx = _dx(g, w, dilation, pad_l, pad_r, x.shape[1]) if ctx.needs_input_grad[0] else None
        dw = _dw(g, x, w, dilation, pad_l, pad_r) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None, None


def dwconv(x, kernel, dilation: int = 1, pad_l: int = 0, pad_r: int = 0,
           taps: Taps | None = None):
    """Depthwise conv of x (B, T, C*m) with kernel (K, m, C). CPU tensors
    run `dwconv_plain` on `kernel`; CUDA tensors launch the kernel (float32
    or bfloat16) on `taps` alone, the kernel's taps made once in x's type
    on its card (`prepare_taps`), and raise without them: the call copies
    nothing. Where autograd records (grad mode on and x or kernel needing a
    gradient) the call goes through `DwconvFn`, else straight on."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return DwconvFn.apply(x, kernel, dilation, pad_l, pad_r, taps)
    return _forward(x, kernel, dilation, pad_l, pad_r, taps)


dwconv.launches = 0
dwconv.backward_launches = 0
