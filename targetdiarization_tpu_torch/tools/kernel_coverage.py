"""Does each kernel write every output element, and the same bits each time?

For every shape chip_smoke.py holds a kernel at (DWCONV_SHAPES and
DX_SHAPES for dwconv's forward and dx, FFCONVM_SHAPES, FLASH_SHAPES and
FLASH_RANGE for both FLASH forms), this calls the kernel's wrapper once
with every `torch.empty` / `torch.empty_like` it makes filled with NaN
(so an element the kernel leaves unwritten stays NaN), then twice more on
the same inputs, and prints per kernel the calls made, those that left
NaN, and those whose three outputs were not bitwise equal.

Run from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.kernel_coverage
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from unittest import mock


@contextmanager
def nan_allocations():
    """torch.empty and torch.empty_like return NaN-filled floating tensors."""
    import torch

    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    with mock.patch.object(torch, "empty", lambda *a, **k: fill(empty(*a, **k))), \
            mock.patch.object(torch, "empty_like", lambda *a, **k: fill(empty_like(*a, **k))):
        yield


def probe(call) -> tuple[bool, bool]:
    """(output finite after NaN-filled allocations, three calls bitwise equal)."""
    import torch

    with nan_allocations():
        first = call()
    outs = [first, call(), call()]
    torch.cuda.synchronize()
    flat = [o if isinstance(o, tuple) else (o,) for o in outs]
    finite = all(bool(torch.isfinite(t).all()) for t in flat[0])
    same = all(torch.equal(a, b) for other in flat[1:] for a, b in zip(flat[0], other))
    return finite, same


def main() -> None:
    import chip_smoke
    from ..ops.kernels import dwconv as dwmod
    from ..ops.kernels.ffconvm import TAPS, ffconvm, prepare_ffconvm
    from ..ops.kernels.flash import flash_gated, flash_group_attention

    torch = chip_smoke.require_cuda()
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    summary: dict = {}

    def record(kernel, label, finite, same):
        row = summary.setdefault(kernel, {"calls": 0, "unwritten": [], "not_bitwise": []})
        row["calls"] += 1
        if not finite:
            row["unwritten"].append(label)
        if not same:
            row["not_bitwise"].append(label)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    for name, b, t, k, m, c, dil, pad_l, pad_r, types in chip_smoke.DWCONV_SHAPES:
        for dtype in (getattr(torch, n) for n in types):
            x, w = rnd(b, t, c * m, dtype=dtype), rnd(k, m, c, dtype=dtype, scale=0.2)
            taps = dwmod.prepare_taps(w)
            record("dwconv", f"{name} {dtype}",
                   *probe(lambda: dwmod.dwconv(x, w, dil, pad_l, pad_r, taps=taps)))
    for name, b, t, k, c, dil, pads in chip_smoke.DX_SHAPES:
        span = (k - 1) * dil
        pad_l, pad_r = pads or (span // 2, span - span // 2)
        for dtype in (torch.float32, torch.bfloat16):
            g, w = rnd(b, t, c, dtype=dtype), rnd(k, 1, c, dtype=dtype, scale=0.2)
            record("dwconv_dx", f"{name} {dtype}",
                   *probe(lambda: dwmod._dx(g, w, dil, pad_l, pad_r, t)))
    variants = {v[0]: v for v in chip_smoke.FFCONVM_VARIANTS}
    for name, b, t, cin, cout, norm, names in chip_smoke.FFCONVM_SHAPES:
        for _, dname, bf16_w, _ in (variants[n] for n in names):
            dtype = getattr(torch, dname)
            x = rnd(b, t, cin, dtype=dtype)
            na = rnd(1 if norm == "scalenorm" else cin, dtype=dtype, scale=0.1) + 1
            nb = torch.zeros(1, device="cuda", dtype=dtype) if norm == "scalenorm" \
                else rnd(cin, dtype=dtype, scale=0.1)
            w, bias = rnd(cout, cin, dtype=dtype, scale=cin ** -0.5), rnd(cout, dtype=dtype)
            dwk = rnd(TAPS, 1, cout, dtype=dtype, scale=0.2)
            if bf16_w:
                w = w.to(torch.bfloat16).to(dtype)
            ops = prepare_ffconvm(na, nb, w, bias, dwk, norm, dtype)
            record("ffconvm", f"{name} {dname}",
                   *probe(lambda: ffconvm(x, na, nb, w, bias, dwk, norm, prepared=ops)))
    shapes = [("gated", g, d, e, b, n) for _, b, n, g, d, e, _ in chip_smoke.FLASH_SHAPES]
    shapes += [(form, g, d, e, 2, 6) for form, g, d, e in chip_smoke.FLASH_RANGE]
    shapes += [("two-output", 256, 128, 1024, 2, 79)]
    for form, g, d, e, b, n in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k = rnd(b, n, g, d, dtype=dtype, scale=4.0), rnd(b, n, g, d, dtype=dtype, scale=4.0)
            v, u = rnd(b, n, g, e, dtype=dtype), rnd(b, n, g, e, dtype=dtype)
            mask = torch.ones(b, n, 1, g, device="cuda", dtype=dtype)
            mask[:, -1, :, g // 2:] = 0
            if form == "gated":
                lq = rnd(b, n, g, d, dtype=dtype)
                kv, ku = rnd(b, d, e, dtype=dtype, scale=0.1), rnd(b, d, e, dtype=dtype, scale=0.1)
                call = lambda: flash_gated(q, k, v, u, mask, lq, kv, ku)  # noqa: E731
            else:
                call = lambda: flash_group_attention(q, k, v, u, mask)  # noqa: E731
            record(f"flash {form}", f"g {g} d {d} e {e} {dtype}", *probe(call))
    print(json.dumps(summary), flush=True)
    if any(r["unwritten"] or r["not_bitwise"] for r in summary.values()):
        raise SystemExit("a kernel left outputs unwritten or changed between calls")


if __name__ == "__main__":
    main()
