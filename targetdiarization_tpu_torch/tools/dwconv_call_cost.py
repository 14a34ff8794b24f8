"""The host's cost of one dwconv call on the card, by C calling convention.

`csrc/dwconv.cu`'s entry takes one block of int64 arguments (the wrapper
fills it and ctypes converts one pointer); the other kernels take typed
arguments. This script builds the same kernel a second time behind an
entry with the thirteen typed arguments, and times in turns, in one
process: the port's `dwconv` call (packed), the same call through the
typed entry, and `F.conv1d(groups=C)` on a ready padded input, at the
shapes of `chip_smoke.py`'s dwconv check (the ASR path's SAN-M and VAD
memories, the separator's FSMN convs and the other models' convs) in the
types that script checks them in.

Times are chip_smoke.py's: host-inclusive milliseconds per call by CUDA
events over back-to-back calls (each round library, packed, typed, typed,
packed, library; the median over the rounds), and device milliseconds from
20 launches replayed in one CUDA graph. Run from the repository root on a
machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.dwconv_call_cost [--rounds 7] [--shapes SAN-M,VAD]

It prints the card's name and power limit and one JSON line per shape and
type, and raises if a convention's output differs from the plain version's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from unittest import mock

TYPED_SHIM = """
#include "{csrc}/dwconv.cu"

extern "C" int td_dwconv_typed(const void* x, const void* w, void* out, int batch, int t_in,
                               int t_out, int c, int m, int k, int dil, int pad_l,
                               int is_bf16, void* stream) {{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_m<__nv_bfloat16>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
    return launch_m<float>(x, w, out, batch, t_in, t_out, c, m, k, dil, pad_l, s);
}}
"""


def typed_entry():
    """The dwconv kernel behind a typed C entry, as an `Entry` that the
    port's `dwconv` wrapper can call in place of its packed one."""
    from ..ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "dwconv_typed.cu")
    lib = os.path.join(_build.BUILD_DIR, "libtd_dwconv_typed.so")
    with open(src, "w") as f:
        f.write(TYPED_SHIM.format(csrc=_build.CSRC))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    entry = _build.Entry("td_dwconv_typed", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p])
    with mock.patch.object(_build, "load_library", lambda: ctypes.CDLL(lib)):
        entry._bind()
    return entry


def main() -> None:
    import torch.nn.functional as F

    import chip_smoke
    from ..ops.kernels import dwconv as dwmod

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--iters", type=int, default=200, help="calls per timing, small shapes")
    parser.add_argument("--shapes", default="",
                        help="comma-separated name prefixes of the shapes to time (default all)")
    args = parser.parse_args()
    prefixes = tuple(p for p in args.shapes.split(",") if p)
    torch = chip_smoke.require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    packed, typed = dwmod._fn, typed_entry()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, batch, t, k, m, c, dil, pad_l, pad_r, types in chip_smoke.DWCONV_SHAPES:
        if prefixes and not name.startswith(prefixes):
            continue
        for dtype in (getattr(torch, n) for n in types):
            x = torch.randn(batch, t, c * m, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, m, c, generator=gen, device="cuda") * 0.2).to(dtype)
            taps = dwmod.prepare_taps(w)
            xt = F.pad(x.transpose(1, 2), (pad_l, pad_r)).contiguous()
            wt = w.permute(2, 1, 0).contiguous()
            want = dwmod.dwconv_plain(x, w, dil, pad_l, pad_r)

            def kernel():
                return dwmod.dwconv(x, w, dil, pad_l, pad_r, taps=taps)

            def library():
                return F.conv1d(xt, wt, dilation=dil, groups=c)

            times = {"packed": [], "typed": [], "library": []}
            device = {}
            small = t * c * m < 1_000_000
            iters, rounds = (args.iters, args.rounds) if small else (20, 2)
            for conv, fn in (("packed", packed), ("typed", typed)):
                dwmod._fn = fn
                if chip_smoke.rel_err(kernel(), want)[1] > chip_smoke.TOL[str(dtype)[6:]]:
                    raise AssertionError(f"dwconv {name} {dtype} through the {conv} entry "
                                         "disagrees with its plain version")
                device[conv] = chip_smoke.graph_ms(kernel)
            device["library"] = chip_smoke.graph_ms(library)
            for _ in range(rounds):
                for conv in ("library", "packed", "typed", "typed", "packed", "library"):
                    if conv == "library":
                        times[conv].append(chip_smoke.time_ms(library, iters=iters))
                    else:
                        dwmod._fn = packed if conv == "packed" else typed
                        times[conv].append(chip_smoke.time_ms(kernel, iters=iters))
            dwmod._fn = packed
            row = {"shape": name, "dtype": str(dtype)[6:], "rounds": rounds, "iters": iters}
            for conv, ms in times.items():
                row[f"{conv}_ms"] = statistics.median(ms)
                row[f"{conv}_ms_all"] = ms
                row[f"{conv}_device_ms"] = device[conv]
            print(json.dumps(row), flush=True)
            del x, w, taps, xt, wt, want


if __name__ == "__main__":
    main()
