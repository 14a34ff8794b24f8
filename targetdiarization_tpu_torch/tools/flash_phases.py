"""Where gated FLASH's time goes inside a block, by phase, on the card.

Builds a copy of `csrc/flash_gated.cu` with clock64() counters at the
phase boundaries of one block (batch 0, group 7, query tile 1; the first
warp of each warpgroup), runs it at the main path's shape (B 2, G 79, g 256,
d 128, e 1024) in float32 and bfloat16, and prints each phase's share of the
block's cycles:

    stage1   q, k and lq split into shared memory, S = q k^T, A's epilogue
    put0     the first chunk of v and u into the ring
    sync     the barrier at the top of each step
    issue    issuing the step's wgmma
    put      splitting the next chunk into the ring (waits for its loads)
    fetch    issuing the loads of the chunk after it
    wait     waiting for the step's wgmma
    epilogue the gate and the store at each slice's end, and the loop
    end      after the last step

The counters cost a few percent; the copy's device time is printed beside
the kernel's. The library is built into `_build/`, next to the port's. Run
from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.flash_phases
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from unittest import mock

PHASES = ("stage1", "put0", "sync", "issue", "put", "fetch", "wait", "epilogue", "end")

# (anchor in csrc/flash_gated.cu, text put in its place): counter k adds the
# cycles since the previous counter to phase k
_EDITS = (
    ("namespace {\n\nusing namespace td;",
     "__device__ unsigned long long g_phase[4][16];\n\nnamespace {\n\nusing namespace td;"),
    ("    fetch(0);  // stage 2's first chunk loads while stage 1 runs\n",
     "    const bool rec = threadIdx.x % 128 == 0 && blockIdx.x == 1 && blockIdx.y == 7 &&\n"
     "                     blockIdx.z == 0;\n"
     "    unsigned long long phase[16] = {0};\n"
     "    long long c0 = clock64(), c1;\n"
     "#define TICK(i) if (rec) { c1 = clock64(); phase[i] += c1 - c0; c0 = c1; }\n"
     "    fetch(0);  // stage 2's first chunk loads while stage 1 runs\n"),
    ("    // ---- stage 2: [A | lq] . [v ; lin_kv] and [A | lq] . [u ; lin_ku]\n",
     "    TICK(0)\n    // ---- stage 2: [A | lq] . [v ; lin_kv] and [A | lq] . [u ; lin_ku]\n"),
    ("    if (n_steps > 1) fetch(1);\n", "    if (n_steps > 1) fetch(1);\n    TICK(1)\n"),
    ("        fence_proxy_async();\n        __syncthreads();  // stage st",
     "        TICK(7)\n        fence_proxy_async();\n        __syncthreads();  // stage st"),
    ("        wgmma_fence();\n        const uint32_t a = at_s + ch * kTile;",
     "        TICK(2)\n        wgmma_fence();\n        const uint32_t a = at_s + ch * kTile;"),
    ("        wgmma_commit();\n"
     "        if (step + 1 < n_steps) {  // while the tensor cores work\n"
     "            put(st ^ 1, step + 1);\n"
     "            if (step + 2 < n_steps) fetch(step + 2);\n"
     "        }\n"
     "        wgmma_wait_all();\n"
     "        fence_acc(acc);\n",
     "        wgmma_commit();\n        TICK(3)\n"
     "        if (step + 1 < n_steps) {\n"
     "            put(st ^ 1, step + 1);\n            TICK(4)\n"
     "            if (step + 2 < n_steps) fetch(step + 2);\n            TICK(5)\n"
     "        }\n"
     "        wgmma_wait_all();\n"
     "        fence_acc(acc);\n        TICK(6)\n"),
)
_END = "template <typename T, bool kGated, bool kFullD>\nint launch_d("


def instrument(source: str) -> str:
    """`source` with the counters; raises if an anchor is missing."""
    for anchor, text in _EDITS:
        if source.count(anchor) != 1:
            raise ValueError(f"csrc/flash_gated.cu has {source.count(anchor)} copies of the "
                             f"anchor {anchor.splitlines()[0]!r}; update tools/flash_phases.py")
        source = source.replace(anchor, text)
    end = source.rindex("}\n", 0, source.index(_END))
    source = (source[:end] + "    TICK(8)\n"
              "    if (rec) for (int i = 0; i < 16; ++i) g_phase[threadIdx.x / 128][i] = phase[i];\n"
              + source[end:])
    return source + ('\nextern "C" int td_flash_phases(void* host) {\n'
                     "    return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, "
                     "sizeof(g_phase)));\n}\n")


def build() -> ctypes.CDLL:
    from ..ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "flash_phases.cu")
    lib = os.path.join(_build.BUILD_DIR, "libtd_flash_phases.so")
    with open(os.path.join(_build.CSRC, "flash_gated.cu")) as f:
        text = instrument(f.read())
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
                           src], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(lib)


def main() -> None:
    import chip_smoke
    from ..ops.kernels import _build
    from ..ops.kernels import flash as flmod

    torch = chip_smoke.require_cuda()
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    lib = build()
    lib.td_flash_phases.argtypes = [ctypes.c_void_p]
    counted = _build.Entry("td_flash_gated", flmod._fn.argtypes)
    with mock.patch.object(_build, "load_library", lambda: lib):
        counted._bind()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n_groups, g, d, e = 2, 79, 256, 128, 1024
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = rnd(b, n_groups, g, d, scale=4.0), rnd(b, n_groups, g, d, scale=4.0)
        lq, v, u = rnd(b, n_groups, g, d), rnd(b, n_groups, g, e), rnd(b, n_groups, g, e)
        mask = torch.ones(b, n_groups, 1, g, device="cuda", dtype=dtype)
        kv, ku = rnd(b, d, e, scale=0.1), rnd(b, d, e, scale=0.1)
        args = (q, k, v, u, mask, lq, kv, ku)
        row = {"dtype": str(dtype)[6:],
               "device_ms": chip_smoke.graph_ms(lambda: flmod.flash_gated(*args))}
        with mock.patch.object(flmod, "_fn", counted):
            got = flmod.flash_gated(*args)
            row["counted_device_ms"] = chip_smoke.graph_ms(lambda: flmod.flash_gated(*args))
            flmod.flash_gated(*args)
        torch.cuda.synchronize()
        row["rel_err"] = chip_smoke.rel_err(got, flmod.flash_gated_plain(*args))[1]
        buf = (ctypes.c_ulonglong * 64)()
        if lib.td_flash_phases(ctypes.addressof(buf)):
            raise RuntimeError("td_flash_phases failed")
        for w in range(2):
            cycles = list(buf[16 * w:16 * w + len(PHASES)])
            row[f"warpgroup{w}_cycles"] = sum(cycles)
            row[f"warpgroup{w}_share"] = {p: c / sum(cycles) for p, c in zip(PHASES, cycles)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
