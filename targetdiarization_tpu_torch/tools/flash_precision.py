"""Where gated FLASH's float32 error comes from, on the card.

The float32 kernel runs each product as three 16-bit passes over the
operands' halves (hi.hi + hi.lo + lo.hi, `csrc/flash_gated.cu`): fp16
halves of operands scaled by powers of two. For each of chip_smoke.py's
FLASH_SHAPES, on chip_smoke.py's inputs (the same generator and draws),
this prints the error of the kernel, of the plain float32 version and of
two designs emulated in float64 (the same splits, exact sums): `emulated`,
the kernel's fp16 halves (its scales taken per batch row and group here,
not per tile), and `emulated_bf16`, bf16 halves with no scales (the design
before); each against the function in float64, as max |error| / max
|reference|. Also the kernel against the emulation and where the kernel's
largest error lies (batch, group, row, column). A kernel that follows its
design errs about as its emulation does.

Run from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.flash_precision
"""

from __future__ import annotations

import json


def _split(x, half):
    import torch

    if not half:
        hi = x.to(torch.bfloat16).float()
        return hi.double(), (x - hi).to(torch.bfloat16).double()
    top = x.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30)
    scale = torch.exp2(14 - torch.floor(torch.log2(top)))
    hi = (x * scale).half().float()
    return hi.double() / scale, ((x * scale) - hi).half().double() / scale


def _mm3(half):
    """a @ b as three passes over 16-bit halves, summed exactly (float64)."""
    def mm(a, b):
        ah, al = _split(a, half)
        bh, bl = _split(b, half)
        return ah @ bh + ah @ bl + al @ bh
    return mm


def gated(q, k, v, u, mask, lq, kv, ku, mm, dtype):
    """flash_gated_plain's function with the products `mm` in `dtype`."""
    import torch

    g = q.shape[-2]
    sim = mm(q, k.transpose(-1, -2)).to(dtype) * (1.0 / g)
    attn = (torch.relu(sim).square() * mask.to(dtype)).float()
    lqf = lq.float()
    att_v = mm(attn, v).to(dtype) + mm(lqf, kv[:, None]).to(dtype)
    att_u = mm(attn, u).to(dtype) + mm(lqf, ku[:, None]).to(dtype)
    return (att_u * v.to(dtype)) * torch.sigmoid(att_v * u.to(dtype))


def main() -> None:
    import chip_smoke
    from ..ops.kernels.flash import flash_gated, flash_gated_plain

    torch = chip_smoke.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)  # chip_smoke.check_flash's draws
    for label, batch, n_groups, g, d, e, masked_tail in chip_smoke.FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

            q, k = rnd(batch, n_groups, g, d, scale=4.0), rnd(batch, n_groups, g, d, scale=4.0)
            lq = rnd(batch, n_groups, g, d)
            v, u = rnd(batch, n_groups, g, e), rnd(batch, n_groups, g, e)
            mask = torch.ones(batch, n_groups, 1, g, device="cuda", dtype=dtype)
            mask[:, -1, :, g - masked_tail:] = 0
            kv, ku = rnd(batch, d, e, scale=0.1), rnd(batch, d, e, scale=0.1)
            if dtype != torch.float32:
                continue  # the draws keep chip_smoke's order; bf16 is not studied
            args = (q, k, v, u, mask, lq, kv, ku)
            got = flash_gated(*args).double()
            plain = flash_gated_plain(*args).double()
            ref = gated(*(a.double() for a in args), lambda a, b: a.double() @ b.double(),
                        torch.float64)
            emu = gated(*args, _mm3(True), torch.float64)
            emu_bf16 = gated(*args, _mm3(False), torch.float64)
            top = ref.abs().max()

            def err(x):
                return float((x - ref).abs().max() / top)

            worst = int((got - ref).abs().argmax())
            b, grp, row, col = (int(i) for i in torch.unravel_index(torch.tensor(worst),
                                                                    got.shape))
            at = (b, grp, row, col)
            row_out = {"shape": label, "g": g, "d": d, "e": e,
                       "kernel": err(got), "plain_f32": err(plain), "emulated": err(emu),
                       "emulated_bf16": err(emu_bf16),
                       "kernel_vs_emulated": float((got - emu).abs().max() / top),
                       "kernel_vs_plain": float((got - plain).abs().max() / plain.abs().max()),
                       "worst_at": at, "worst_group_masked": grp == n_groups - 1,
                       "worst_ref": float(ref[at]), "worst_kernel_err": float(got[at] - ref[at]),
                       "worst_emulated_err": float(emu[at] - ref[at]),
                       "kernel_p9999": float(torch.quantile(
                           ((got - ref).abs() / top).flatten()[::7].float(), 0.9999)),
                       "emulated_p9999": float(torch.quantile(
                           ((emu - ref).abs() / top).flatten()[::7].float(), 0.9999))}
            print(json.dumps(row_out), flush=True)
            del args, got, plain, ref, emu, emu_bf16


if __name__ == "__main__":
    main()
