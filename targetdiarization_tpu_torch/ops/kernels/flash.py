"""Grouped FLASH attention: the gated form and the two-output form.

Counterparts of targetdiarization_tpu/ops/pallas/flash.py::
flash_gated_attention (grouped relu^2 attention + linear term + gate,
which MossFormer2's FlashBlock runs) and ::flash_group_attention (the
public two-output op, out_v = A v and out_u = A u). Both kernels are
`csrc/flash_gated.cu`; `flash_gated_plain` and `flash_group_plain` are
the same functions in plain PyTorch, following the TPU kernels'
arithmetic: A in float32, rounded to v's type before the products,
float32 accumulation, the gate in float32, outputs in v's type. The
kernel runs both products on the tensor cores, float32 operands as three
passes over their bf16 halves: it agrees with the plain version within
chip_smoke.py's limit of 1e-4 of max|out| in float32, not bit for bit.

`FlashGatedFn` and `FlashGroupFn` are the gradients, as the JAX package's
custom VJPs take them (`_gated_bwd`, `_flash_bwd`): the forward launches
the kernel, the backward recomputes the plain version under autograd; the
mask gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch, grads_by_recompute
from ._build import declare


def _attn(q, k, v, mask):
    """relu(q k^T / g)^2 * mask in float32, rounded to v's type, as float32."""
    g = q.shape[-2]
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / g)
    return (torch.relu(sim).square() * mask.float()).to(v.dtype).float()


def flash_gated_plain(q, k, v, u, mask, lq, lin_kv, lin_ku):
    """q, k, lq (B, G, g, d); v, u (B, G, g, e); mask (B, G, 1, g) over key
    columns; lin_kv, lin_ku (B, d, e). Returns out (B, G, g, e):
    out = (A u + lq lin_ku) * v * sigmoid((A v + lq lin_kv) * u),
    A = relu(q k^T / g)^2 * mask."""
    attn = _attn(q, k, v, mask)
    lqf = lq.float()
    att_v = torch.matmul(attn, v.float()) + torch.matmul(lqf, lin_kv.float()[:, None])
    att_u = torch.matmul(attn, u.float()) + torch.matmul(lqf, lin_ku.float()[:, None])
    out = (att_u * v.float()) * torch.sigmoid(att_v * u.float())
    return out.to(v.dtype)


def flash_group_plain(q, k, v, u, mask):
    """q, k (B, G, g, d); v, u (B, G, g, e); mask (B, G, 1, g) over key
    columns. Returns (out_v, out_u), each (B, G, g, e) in v's type."""
    attn = _attn(q, k, v, mask)
    return (torch.matmul(attn, v.float()).to(v.dtype),
            torch.matmul(attn, u.float()).to(v.dtype))


_fn = declare("td_flash_gated", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_group_fn = declare("td_flash_group",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def in_range(g: int, d: int, e: int) -> bool:
    """Whether the kernels take group size g, q/k depth d and v/u width e."""
    return (g % 64 == 0 and 64 <= g <= 256 and d % 16 == 0 and 16 <= d <= min(g, 128)
            and e % 128 == 0 and e > 0)


def _check(q, k, v, u, mask, lq=None, lin_kv=None, lin_ku=None):
    """Validates a CUDA call; the gated form passes lq, lin_kv and lin_ku."""
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q and v must be (B, G, g, d) and (B, G, g, e), got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    b, n_groups, g, d = q.shape
    e = v.shape[-1]
    want = {"q": (q, (b, n_groups, g, d)), "k": (k, (b, n_groups, g, d)),
            "v": (v, (b, n_groups, g, e)), "u": (u, (b, n_groups, g, e)),
            "mask": (mask, (b, n_groups, 1, g))}
    if lq is not None:
        want.update({"lq": (lq, (b, n_groups, g, d)), "lin_kv": (lin_kv, (b, d, e)),
                     "lin_ku": (lin_ku, (b, d, e))})
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {shape} {q.dtype} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not in_range(g, d, e):
        raise ValueError(f"flash kernels take g a multiple of 64 in [64, 256], d a multiple of "
                         f"16 in [16, min(g, 128)] and e a multiple of 128 "
                         f"(csrc/flash_gated.cu), got g {g}, d {d}, e {e}")


def _gated_forward(q, k, v, u, mask, lq, lin_kv, lin_ku):
    if q.device.type == "cpu":
        return flash_gated_plain(q, k, v, u, mask, lq, lin_kv, lin_ku)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_gated runs on cpu or cuda, not {q.device}")
    _check(q, k, v, u, mask, lq, lin_kv, lin_ku)
    b, n_groups, g, d = q.shape
    e = v.shape[-1]
    out = torch.empty_like(v)
    _fn(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(),
        mask.data_ptr(), lq.data_ptr(), lin_kv.data_ptr(), lin_ku.data_ptr(), out.data_ptr(),
        b, n_groups, g, d, e, int(q.dtype == torch.bfloat16))
    count_launch(flash_gated)
    return out


def _group_forward(q, k, v, u, mask):
    if q.device.type == "cpu":
        return flash_group_plain(q, k, v, u, mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_group_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v, u, mask)
    b, n_groups, g, d = q.shape
    e = v.shape[-1]
    out_v = torch.empty_like(v)
    out_u = torch.empty_like(v)
    _group_fn(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(),
              mask.data_ptr(), out_v.data_ptr(), out_u.data_ptr(), b, n_groups, g, d, e,
              int(q.dtype == torch.bfloat16))
    count_launch(flash_group_attention)
    return out_v, out_u


def _mask_needs_none(needs):
    """The recompute's needs with the mask (input 4) left out, as JAX's
    backward returns None for it."""
    return tuple(n and i != 4 for i, n in enumerate(needs))


class FlashGatedFn(torch.autograd.Function):
    """flash_gated with the JAX package's gradient rule (`_gated_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, u, mask, lq, lin_kv, lin_ku):
        ctx.save_for_backward(q, k, v, u, mask, lq, lin_kv, lin_ku)
        return _gated_forward(q, k, v, u, mask, lq, lin_kv, lin_ku)

    @staticmethod
    def backward(ctx, g):
        return grads_by_recompute(flash_gated_plain, ctx.saved_tensors,
                                  _mask_needs_none(ctx.needs_input_grad), g)


class FlashGroupFn(torch.autograd.Function):
    """flash_group_attention with the JAX package's gradient rule (`_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, u, mask):
        ctx.save_for_backward(q, k, v, u, mask)
        return _group_forward(q, k, v, u, mask)

    @staticmethod
    def backward(ctx, g_v, g_u):
        return grads_by_recompute(flash_group_plain, ctx.saved_tensors,
                                  _mask_needs_none(ctx.needs_input_grad), (g_v, g_u))


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_gated(q, k, v, u, mask, lq, lin_kv, lin_ku):
    """Fused gated FLASH epilogue. CPU tensors run `flash_gated_plain`;
    CUDA tensors launch the kernel (float32 or bfloat16, all inputs of
    one type). Where autograd records the call goes through `FlashGatedFn`."""
    args = (q, k, v, u, mask, lq, lin_kv, lin_ku)
    if _records(*args):
        return FlashGatedFn.apply(*args)
    return _gated_forward(*args)


flash_gated.launches = 0


def flash_group_attention(q, k, v, u, mask):
    """Grouped relu^2 attention with one A applied to v and u: q, k (B, G, g, d);
    v, u (B, G, g, e); mask (B, G, 1, g). CPU tensors run `flash_group_plain`;
    CUDA tensors launch the kernel (float32 or bfloat16, all inputs of one type).
    Where autograd records the call goes through `FlashGroupFn`."""
    if _records(q, k, v, u, mask):
        return FlashGroupFn.apply(q, k, v, u, mask)
    return _group_forward(q, k, v, u, mask)


flash_group_attention.launches = 0
