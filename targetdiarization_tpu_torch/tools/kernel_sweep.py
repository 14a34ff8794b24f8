"""Device times of the port's dwconv kernel over a sweep of tap counts, beside
the separator's shapes, to show what its time scales with.

At B 2, T 20224 (the separator's 160k bucket) and C 256 in float32 it times
the kernel for K 1, 9, 17 and 39 (m 1, d 1, SAME padding), then the
separator's conv1 form (K 39, m 2, d 2). A time that does not grow with K
is the staging and the stores; the rest is the taps. Each time is
chip_smoke.py's `device_ms`: 20 launches replayed in one CUDA graph. Run
from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.kernel_sweep

It prints the card's name and power limit and one JSON line per shape.
"""

from __future__ import annotations

import json


def main() -> None:
    import chip_smoke
    from ..ops.kernels.dwconv import dwconv, dwconv_plain, prepare_taps

    torch = chip_smoke.require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    env = chip_smoke.environment()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(k, 1, 1) for k in (1, 9, 17, 39)] + [(39, 2, 2)]
    for k, m, dil in shapes:
        x = torch.randn(2, 20224, 256 * m, generator=gen, device="cuda")
        w = torch.randn(k, m, 256, generator=gen, device="cuda") * 0.2
        span = (k - 1) * dil
        args = (x, w, dil, span // 2, span - span // 2)
        taps = prepare_taps(w)
        got = dwconv(*args, taps=taps)
        want = dwconv_plain(*args)
        err = (got - want).abs().max().item() / want.abs().max().item()
        nbytes = 4 * (x.numel() + got.numel() + w.numel())
        print(json.dumps({"K": k, "m": m, "dilation": dil, "rel_err": err,
                          "device_ms": chip_smoke.graph_ms(lambda: dwconv(*args, taps=taps)),
                          "bytes_ms": nbytes / chip_smoke.PEAK_BYTES * 1e3,
                          "fma_ms": 2.0 * got.numel() * k * m / chip_smoke.PEAK_FLOPS["float32"]
                          * 1e3}), flush=True)
    print(env["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
