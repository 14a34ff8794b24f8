"""Gated FLASH attention: grouped relu^2 attention + linear term + gate.

Counterpart of targetdiarization_tpu/ops/pallas/flash.py::
flash_gated_attention. The kernel is `csrc/flash_gated.cu`;
`flash_gated_plain` is the same function in plain PyTorch, following the
TPU kernel's arithmetic: A in float32, rounded to v's type before the
products, float32 accumulation, the gate in float32, the output in v's
type.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library


def flash_gated_plain(q, k, v, u, mask, lq, lin_kv, lin_ku):
    """q, k, lq (B, G, g, d); v, u (B, G, g, e); mask (B, G, 1, g) over key
    columns; lin_kv, lin_ku (B, d, e). Returns out (B, G, g, e):
    out = (A u + lq lin_ku) * v * sigmoid((A v + lq lin_kv) * u),
    A = relu(q k^T / g)^2 * mask."""
    g = q.shape[-2]
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / g)
    attn = (torch.relu(sim).square() * mask.float()).to(v.dtype).float()
    lqf = lq.float()
    att_v = torch.matmul(attn, v.float()) + torch.matmul(lqf, lin_kv.float()[:, None])
    att_u = torch.matmul(attn, u.float()) + torch.matmul(lqf, lin_ku.float()[:, None])
    out = (att_u * v.float()) * torch.sigmoid(att_v * u.float())
    return out.to(v.dtype)


@functools.cache
def _fn():
    lib = load_library()
    fn = lib.td_flash_gated
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, u, mask, lq, lin_kv, lin_ku):
    b, n_groups, g, d = q.shape
    e = v.shape[-1]
    want = {"q": (q, (b, n_groups, g, d)), "k": (k, (b, n_groups, g, d)),
            "lq": (lq, (b, n_groups, g, d)), "v": (v, (b, n_groups, g, e)),
            "u": (u, (b, n_groups, g, e)), "mask": (mask, (b, n_groups, 1, g)),
            "lin_kv": (lin_kv, (b, d, e)), "lin_ku": (lin_ku, (b, d, e))}
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_gated kernel takes float32 or bfloat16, got {q.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {shape} {q.dtype} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def flash_gated(q, k, v, u, mask, lq, lin_kv, lin_ku):
    """Fused gated FLASH epilogue. CPU tensors run `flash_gated_plain`;
    CUDA tensors launch the kernel (float32 or bfloat16, all inputs of
    one type)."""
    if q.device.type == "cpu":
        return flash_gated_plain(q, k, v, u, mask, lq, lin_kv, lin_ku)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_gated runs on cpu or cuda, not {q.device}")
    _check(q, k, v, u, mask, lq, lin_kv, lin_ku)
    b, n_groups, g, d = q.shape
    e = v.shape[-1]
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(), mask.data_ptr(),
                    lq.data_ptr(), lin_kv.data_ptr(), lin_ku.data_ptr(), out.data_ptr(),
                    b, n_groups, g, d, e, int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"td_flash_gated failed with CUDA error {err}")
    flash_gated.launches += 1
    return out


flash_gated.launches = 0
