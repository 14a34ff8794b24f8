#!/usr/bin/env python3
"""Card check of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, drive `AudioProcessor.separate_speaker` on the
512/24 MossFormer2 (`checkpoints/sep-bootstrap-512`), drive the ASR stage
(`ASRProcessor` on `checkpoints/{vad,asr,punc}-bootstrap`) on synthetic
speech of the kind the bootstrap models were trained on, and drive the
front end (`FusedFrontend.analyze` and `enroll`, and
`AudioProcessor.denoise_vocal`, on `checkpoints/{den,vad,seg,spk}-bootstrap`)
on a synthetic two-voice conversation, drive the whole offline pipeline,
`TargetDiarization.infer`, on the eight shipped checkpoints it loads, with
the 512/24 separator and Apollo restoration (`checkpoints/rest-bootstrap`),
drive the streaming pipeline, `TargetDiarizationStream.infer_stream`,
on the server's `build_model()`: one session, then four at once, and
drive the rest of `build_model()`'s engines (`surface`): the flow
enhancer (`checkpoints/enh-bootstrap`) through `enhance_audio` on 10 s,
emotion (`checkpoints/emo-bootstrap`) in bf16 against float32, and the
Paraformer's forced alignment (`timestamp_prediction`) and the VAD's
`get_speech_timestamps` and `is_speech`, and drive the alternate engines
(`engines`): `build_model()` with ASR_ENGINE=sensevoice and
EMBEDDING_MODEL=checkpoints/campp-bootstrap through `infer` and one
`infer_stream` session, SenseVoice at its full width (seeded weights made
on the card), a whisper engine at its class defaults (a seeded checkpoint
written for the run) against its CPU run, and CAM++ against its CPU run,
and drive the separator zoo (`zoo`): the ten classes of
`models/zoo.py` at their class defaults, each from a seeded checkpoint
written for the run through its inverse converter, through
`SeparationEngine.from_pretrained` (`separate`, `separate_batch`, their
forwards' lengths: ladder rungs or exact lengths), against the CPU and
the plain kernels, and `build_model()` with TD_SEP_CHECKPOINT naming the
ConvTasNet and MossFormer checkpoints through `infer`, and drive training
(`train`): dwconv's dx on the kernel against autograd of its plain version,
then `SeparationTrainer` on the 512/24 separator in float32 (gradients
through the kernels' Functions against the plain path, four steps with
their launches, save and restore, the inference export through
`SeparationEngine`), and two ConvTasNet steps, and drive the bootstrap
recipes (`recipes`): `train/recipes.py`'s five recipes that train through
a kernel, each at its shipped checkpoint's width (the separator also at
its own 64/4 default) for 5 steps from synthesized fixtures, with the
kernels and under the plain versions, their checkpoints served back by
their engines, and drive the recipes whose models run no kernel
(`recipes_plain`): `train/recipes_plain.py`'s nine (the speaker one with
ERes2NetV2 and CAM++, the whisper one on its corpus and on device batches)
at the shipped checkpoints' widths for 3 steps, no kernel launched, their
checkpoints reloaded against the models as saved, and drive the readers of
reference checkpoints (`port_rules`): the 512/24 MossFormer2, Apollo and
ConvTasNet from seeded state dicts in the reference (look2hear) layout
through `runtime/port_rules.py`, one float32 forward each with the kernels
and under the plain versions, and the DNSMOS and SigMOS nets from
synthetic ONNX graphs through `runtime/onnx_io.py` against its numpy
evaluator, and drive data parallelism (`mesh`): `parallel/mesh.py`'s mesh
(two slots of the one card, or every card) under `SeparationTrainer`,
`SeparationEngine`, the fused analyze and the fused ASR, each against one
slot (`tools/dryrun_multichip.py`). It also builds the host library
(`utils/native.py` from `csrc/host/tdaudio.cpp`, with g++) and holds its
BS.1770 meter and converters against their numpy versions (`host_library`),
and profiles through `runtime/trace.py::device_profile`, reading each
profile back from the Chrome trace it writes; `infer` (a)'s trace must hold
each FFConvM, gated FLASH and dwconv launch that the counters count and
the `fused/separate` span (`device_profile`).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Each phase prints one JSON line with `elapsed_s` since the start: the build,
the host library's build seconds and its meter's and the numpy meter's ms
on 1 s and 46 s of speech, each kernel's registers and spills from ptxas
and, by `cuobjdump`, the tensor-core instructions of the built FFConvM and
FLASH kernels; each kernel
against its plain version at the main path's shapes and types and at the
recipes' separators' (FFConvM and gated FLASH at 256/12 and 64/4), with its
host-inclusive time (`ms`), its device time from 20 launches replayed in
one CUDA graph (`device_ms`) and its bounds; both FLASH forms at the other
depths and group sizes they take (`flash_range`, agreement only); the
separator (launch counts, wall times, a profiler breakdown of one call,
agreement with the plain paths), the ASR stage, the front end and `infer`
(three calls: wall times, kernel launches per trace span, a profiler
breakdown by span and by kernel, agreement) and the stream (warm-up, one
20 s session's intake and emission latencies, launches per span,
synchronous against asynchronous flushes, a profiler breakdown, agreement
with the plain path, four concurrent paced sessions against each alone),
and the surface (the enhancer's times at nfe 1, 64 and 128 against its
float32 FMA bound and its agreement with its CPU run, emotion's time and
bf16 agreement, forced alignment's branch and timestamps, launches per
forward, kernels against plain), and the engines (wall times, launches
against the forwards, float32 kernels against float32 plain, SenseVoice's
tags; the full-width SenseVoice's ms and 50 dwconv a forward; whisper's
ms at 64 steps and its ids against the CPU's; CAM++'s ms and cosines),
and the zoo (each class's `separate` ms on 4 s, its forwards, SI-SDR of
the card against its CPU run, of bf16 against float32 plain and, for
ConvTasNet and MossFormer, of the kernels against plain; `infer` on two
of them, kernels against plain with `check_infer`'s limits), and training
(dwconv's dx rows with their times and bounds; step 1's loss, grad norm and
gradient cosine with the kernels against plain, the launches a step, the
forward, backward and optimizer ms of a step, the peak memory, the
export's SI-SDR against the trained model; ConvTasNet's gradients and
launches), and the recipes (each recipe's ms a step, peak memory,
launches a step against the prediction from the model, step losses with
the kernels and plain, metrics, the served checkpoint's agreement), and
the plain recipes (each run's ms a step, peak GB, losses, launches, the
reloaded checkpoints' agreement, `phase_s`), and the reference checkpoints
(each conversion's host seconds, each forward's ms with the kernels and
plain, launches against the model's prediction, SI-SDR of the kernels
against plain; each MOS net's ms and error against `evaluate_onnx`), and
the mesh (the visible cards and the slots; each check's sharded and
single-slot ms, its gaps and its launches against the prediction).
The line before the last
holds every kernel's launches, error and times; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits nonzero and prints no result. It needs CUDA and the repository: with no
card, or with no port beside it, it fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "sep-bootstrap-512")
ASR_CHECKPOINTS = {name: os.path.join(ROOT, "checkpoints", f"{name}-bootstrap")
                   for name in ("vad", "asr", "punc")}
FRONTEND_CHECKPOINTS = {name: os.path.join(ROOT, "checkpoints", f"{name}-bootstrap")
                        for name in ("den", "vad", "seg", "spk")}

# published peaks of one H100 SXM (dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain on the same inputs, max|diff| / max|plain|
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SR = 16000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.time() - T0, 3), **fields}),
          flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA card with CUDA")
    return torch


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: `launches` calls captured in one CUDA
    graph and replayed, so the host's cost per call drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def bound(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def environment() -> dict:
    torch = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    from targetdiarization_tpu_torch.ops.kernels import _build

    t = time.time()
    _build.load_library()
    build_s = time.time() - t
    env = {"device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
           "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": round(build_s, 3)}
    emit("environment", **env)
    return env


# ---------------- kernels against their plain versions ----------------

# (variant, activation type, weights rounded to bf16, tensor-core passes):
# the float32 engine, the main path (the bf16 engine's promoted float32
# stream with bf16-rounded weights), and bf16 activations
FFCONVM_VARIANTS = (("float32", "float32", False, 3), ("main", "float32", True, 2),
                    ("bfloat16", "bfloat16", True, 1))
# (name, B, T, cin, cout, norm, variants): the 512/24 main path at the 160k
# bucket in every variant, and the training recipes' separators (float32
# weights and activations) at their batch of 8 x 1 s, 2048 frames: the
# shipped sep-bootstrap 256/12 and the recipe's default 64/4
_ALL, _F32 = ("float32", "main", "bfloat16"), ("float32",)
FFCONVM_SHAPES = (
    ("to_hidden", 2, 20224, 512, 2048, "scalenorm", _ALL),
    ("to_qk", 2, 20224, 512, 128, "scalenorm", _ALL),
    ("to_out", 2, 20224, 1024, 512, "scalenorm", _ALL),
    ("to_u", 2, 20224, 256, 256, "layernorm", _ALL),
    ("recipe 256/12 to_hidden", 8, 2048, 256, 1024, "scalenorm", _F32),
    ("recipe 256/12 to_qk", 8, 2048, 256, 128, "scalenorm", _F32),
    ("recipe 256/12 to_out", 8, 2048, 512, 256, "scalenorm", _F32),
    ("recipe 256/12 to_u", 8, 2048, 256, 256, "layernorm", _F32),
    ("recipe 64/4 to_hidden", 8, 2048, 64, 256, "scalenorm", _F32),
    ("recipe 64/4 to_qk", 8, 2048, 64, 32, "scalenorm", _F32),
    ("recipe 64/4 to_out", 8, 2048, 128, 64, "scalenorm", _F32),
    ("recipe 64/4 to_u", 8, 2048, 64, 64, "layernorm", _F32),
)


def check_ffconvm(shapes: tuple = FFCONVM_SHAPES) -> list[dict]:
    import torch

    from targetdiarization_tpu_torch.ops.kernels.ffconvm import (TAPS, ffconvm, ffconvm_plain,
                                                                 prepare_ffconvm)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, batch, t, cin, cout, norm, variants in shapes:
        for variant, dname, bf16_weights, passes in (v for v in FFCONVM_VARIANTS
                                                     if v[0] in variants):
            dtype = getattr(torch, dname)

            def rnd(*shape, scale=1.0):
                v = torch.randn(*shape, generator=gen, device="cuda") * scale
                return (v.to(torch.bfloat16) if bf16_weights else v).to(dtype)

            x = torch.randn(batch, t, cin, generator=gen, device="cuda").to(dtype)
            na = rnd(1, scale=0.3) + 1 if norm == "scalenorm" else rnd(cin, scale=0.1) + 1
            nb = torch.zeros(1, device="cuda", dtype=dtype) if norm == "scalenorm" \
                else rnd(cin, scale=0.1)
            w = rnd(cout, cin, scale=cin ** -0.5)
            b = rnd(cout, scale=0.1)
            dwk = rnd(TAPS, 1, cout, scale=0.2)
            args = (x, na, nb, w, b, dwk, norm)
            ops = prepare_ffconvm(na, nb, w, b, dwk, norm, dtype)
            if (ops.w_lo is None) != bf16_weights:
                raise AssertionError(f"ffconvm {name} {variant}: W_lo is "
                                     f"{'absent' if ops.w_lo is None else 'present'}")
            try:
                ffconvm(*args)
            except ValueError:
                pass
            else:
                raise AssertionError("ffconvm ran on the card without prepared operands")
            got = ffconvm(*args, prepared=ops)
            want = ffconvm_plain(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            isz = x.element_size()
            flops = 2.0 * batch * t * cout * (cin + TAPS + 1)
            nbytes = isz * (batch * t * (cin + cout) + cin * cout + cout * (TAPS + 1) + 2 * cin)
            fma_bound_ms, fma_by = bound(flops, nbytes, "float32")
            # the design's least time: its bf16 tensor-core passes, the taps
            # on the float32 units, or the bytes, whichever is longest
            tc_ms = passes * 2.0 * batch * t * cout * cin / PEAK_FLOPS["bfloat16"] * 1e3
            taps_ms = 2.0 * batch * t * cout * (TAPS + 1) / PEAK_FLOPS["float32"] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound_ms = max(tc_ms, taps_ms, bytes_ms)
            xm = x.reshape(-1, cin).float()
            wt = w.float().t().contiguous()
            row = {"shape": name, "variant": variant, "dtype": dname,
                   "weights": "bf16-exact" if bf16_weights else "float32",
                   "tensor_core_passes": passes, "B": batch, "T": t, "cin": cin, "cout": cout,
                   "norm": norm, "flops": flops, "bytes": nbytes,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": time_ms(lambda: ffconvm(*args, prepared=ops)),
                   "device_ms": graph_ms(lambda: ffconvm(*args, prepared=ops)),
                   "plain_ms": time_ms(lambda: ffconvm_plain(*args), iters=5),
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= max(tc_ms, taps_ms) else "operations",
                   "fma_bound_ms": fma_bound_ms, "fma_bound_by": fma_by,
                   "tensor_core_ms": tc_ms, "taps_ms": taps_ms, "bytes_ms": bytes_ms,
                   "matmul_ms": time_ms(lambda: torch.matmul(xm, wt)),
                   "library_ms": None}
            emit("ffconvm", **row)
            if not rel <= TOL[dname]:
                raise AssertionError(f"ffconvm {name} {variant}: kernel vs plain rel err "
                                     f"{rel:.3g} > {TOL[dname]}")
            rows.append(row)
            del x, w, got, want, xm, wt, ops
    pair = [r for r in rows if r["variant"] == "main"]
    emit("ffconvm_pair", variant="main", calls="to_hidden + to_qk + to_out + 2 x to_u",
         ms=sum(r["ms"] * (2 if r["shape"] == "to_u" else 1) for r in pair),
         device_ms=sum(r["device_ms"] * (2 if r["shape"] == "to_u" else 1) for r in pair))
    return rows


# the kernels of csrc/ whose ptxas and SASS counts the build report gives
BUILD_KERNELS = ("ffconvm_kernel", "flash_kernel", "dwconv_kernel")
# mangled-name marks of the gated FLASH instantiations, which must run on
# the tensor cores
GATED_FLASH = {"float32": "flash_kernelIfLb1E", "bfloat16": "flash_kernelI13__nv_bfloat16Lb1E"}


def flash_smem_bytes(g: int, d: int, gated: bool, dtype_name: str) -> int:
    """csrc/flash_gated.cu's smem_bytes: [A | lq] as bf16 halves (lq's d
    columns padded to a multiple of 64), two ring stages of v and u (128 e
    columns x 64 deep), 1024 bytes of alignment."""
    parts = 2 if dtype_name == "float32" else 1
    dpad = -(-d // 64) * 64
    return parts * ((g + (dpad if gated else 0)) // 64) * 8192 + 2 * parts * 2 * 16384 + 1024


def build_report() -> dict:
    """Diagnostics of the built kernels: registers, spills and shared memory
    from ptxas's report of the build, and the tensor-core instructions in
    the library by cuobjdump (the kernels' wgmma shows as HGMMA; a
    WARPGROUP.DEPBAR waits for the products issued before it, so one for
    each HGMMA means they run one at a time). FFConvM's lines keep their
    phase; FLASH's and dwconv's follow in a second one, with FLASH's dynamic
    shared memory at the main path's shape. Fails if a gated FLASH
    instantiation holds no HGMMA, or cuobjdump is missing."""
    from targetdiarization_tpu_torch.ops.kernels import _build

    report: dict = {}
    fn = None
    log = _build.ptxas_log(_build.library_path())
    lines = open(log).read().splitlines() if os.path.exists(log) else []
    for line in lines:
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            fn = fn if any(k in fn for k in BUILD_KERNELS) else None
        elif fn and ("Used" in line or "spill" in line):
            report.setdefault(fn, {}).setdefault("ptxas", []).append(line.split(":")[-1].strip())
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    fn = None
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", _build.library_path()], capture_output=True,
                              text=True, timeout=300).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = fn if any(k in fn for k in BUILD_KERNELS) else None
                if fn:
                    report.setdefault(fn, {})["sass"] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0,
                                                         "WARPGROUP.DEPBAR": 0}
            elif fn:
                counts = report[fn]["sass"]
                for op in counts:
                    if f" {op}." in line or f" {op} " in line:
                        counts[op] += 1
    found = os.path.exists(tool)
    cuobjdump = tool if found else f"{tool} not found: no instruction counts"
    emit("ffconvm_build", ptxas_log=log if lines else None, cuobjdump=cuobjdump,
         kernels={n: r for n, r in report.items() if "ffconvm_kernel" in n})
    smem = {f"flash {form} {t}": flash_smem_bytes(256, 128, form == "gated", t)
            for form in ("gated", "two-output") for t in ("float32", "bfloat16")}
    emit("kernel_build", cuobjdump=cuobjdump, flash_dynamic_smem_bytes_g256_d128=smem,
         kernels={n: r for n, r in report.items() if "ffconvm_kernel" not in n})
    if not found:
        raise AssertionError(f"{cuobjdump}: cannot show that gated FLASH runs on the tensor cores")
    for dname, mark in GATED_FLASH.items():
        hgmma = [r.get("sass", {}).get("HGMMA", 0) for n, r in report.items() if mark in n]
        if not hgmma or min(hgmma) == 0:
            raise AssertionError(f"gated FLASH ({dname}) holds no HGMMA: {hgmma}")
    return report


def design_bound(mma_flops: float, flops: float, nbytes: float, dtype_name: str) -> dict:
    """FLASH's bounds: its products on the bf16 tensor cores (three split
    passes for float32, one for bf16; `tensor_core_ms`), its bytes
    (`bytes_ms`), and the same work on the float32 FMA units
    (`fma_bound_ms`). `bound_ms` is the design's: the larger of the first two."""
    passes = 3 if dtype_name == "float32" else 1
    tc_ms = passes * mma_flops / PEAK_FLOPS["bfloat16"] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    fma_ms, fma_by = bound(flops, nbytes, "float32")
    return {"tensor_core_passes": passes, "tensor_core_ms": tc_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(tc_ms, bytes_ms),
            "bound_by": "operations" if tc_ms >= bytes_ms else "bytes",
            "fma_bound_ms": fma_ms, "fma_bound_by": fma_by}


# (label, B, G, g, d, e, masked tail keys) of gated FLASH: the 512/24 main
# path at the 160k bucket (a 160k window: 19999 of 20224 frames valid), and
# the training recipes' separators at their batch of 8 x 1 s (1999 encoder
# frames): sep-bootstrap's 256/12 (16 groups of 128, d 128, e 512) and the
# recipe's default 64/4 (32 groups of 64, d 32, e 128)
FLASH_SHAPES = (("512/24, 160k bucket", 2, 79, 256, 128, 1024, 225),
                ("recipe sep-bootstrap 256/12, batch 8 of 1 s", 8, 16, 128, 128, 512, 49),
                ("recipe default 64/4, batch 8 of 1 s", 8, 32, 64, 32, 128, 49))
# (form, g, d, e) that the kernels take and no model makes, at B 2, G 6 with
# a masked tail: depths below 128 at each group size, a partial depth chunk
# after a full one (d 80-112), d 16, and the two-output form below d 128
FLASH_RANGE = (("gated", 64, 16, 128), ("gated", 64, 64, 256), ("gated", 128, 64, 512),
               ("gated", 128, 80, 128), ("gated", 192, 48, 384), ("gated", 256, 96, 1024),
               ("gated", 256, 112, 256), ("two-output", 64, 32, 128),
               ("two-output", 128, 16, 256), ("two-output", 256, 96, 512))


def check_flash_range(batch: int = 2, n_groups: int = 6) -> list[dict]:
    """Both FLASH forms at the FLASH_RANGE shapes in float32 and bf16,
    against their plain versions with TOL: the depths, group sizes and
    partial chunks the kernels take beside the ones the models make."""
    import torch

    from targetdiarization_tpu_torch.ops.kernels.flash import (flash_gated, flash_gated_plain,
                                                               flash_group_attention,
                                                               flash_group_plain)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for (form, g, d, e), dtype in ((s, t) for s in FLASH_RANGE
                                   for t in (torch.float32, torch.bfloat16)):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = rnd(batch, n_groups, g, d, scale=4.0), rnd(batch, n_groups, g, d, scale=4.0)
        v, u = rnd(batch, n_groups, g, e), rnd(batch, n_groups, g, e)
        mask = torch.ones(batch, n_groups, 1, g, device="cuda", dtype=dtype)
        mask[:, -1, :, g - 17:] = 0
        if form == "gated":
            args = (q, k, v, u, mask, rnd(batch, n_groups, g, d), rnd(batch, d, e, scale=0.1),
                    rnd(batch, d, e, scale=0.1))
            pairs = [(flash_gated(*args), flash_gated_plain(*args))]
        else:
            pairs = list(zip(flash_group_attention(q, k, v, u, mask),
                             flash_group_plain(q, k, v, u, mask)))
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in pairs]
        dname = str(dtype).split(".")[1]
        row = {"form": form, "dtype": dname, "B": batch, "G": n_groups, "g": g, "d": d, "e": e,
               "max_abs_err": max(x[0] for x in errs), "rel_err": max(x[1] for x in errs)}
        emit("flash_range", **row)
        if not row["rel_err"] <= TOL[dname]:
            raise AssertionError(f"flash {form} g {g} d {d} e {e} {dname}: kernel vs plain rel "
                                 f"err {row['rel_err']:.3g} > {TOL[dname]}")
        rows.append(row)
    return rows


def check_flash(shapes: tuple = FLASH_SHAPES) -> list[dict]:
    import torch

    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_gated_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (label, batch, n_groups, g, d, e, masked_tail), dtype in (
            (shape, dtype) for shape in shapes for dtype in (torch.float32, torch.bfloat16)):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = rnd(batch, n_groups, g, d, scale=4.0), rnd(batch, n_groups, g, d, scale=4.0)
        lq = rnd(batch, n_groups, g, d)
        v, u = rnd(batch, n_groups, g, e), rnd(batch, n_groups, g, e)
        mask = torch.ones(batch, n_groups, 1, g, device="cuda", dtype=dtype)
        mask[:, -1, :, g - masked_tail:] = 0
        kv, ku = rnd(batch, d, e, scale=0.1), rnd(batch, d, e, scale=0.1)
        args = (q, k, v, u, mask, lq, kv, ku)
        got = flash_gated(*args)
        want = flash_gated_plain(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        dname = str(dtype).split(".")[1]
        isz = q.element_size()
        bg = batch * n_groups
        mma_flops = 2.0 * bg * g * (g * d + 2 * (g + d) * e)
        flops = mma_flops + 6.0 * bg * g * e
        nbytes = isz * (bg * g * (3 * d + 3 * e + 1) + 2 * batch * d * e)
        row = {"shape": label, "dtype": dname, "B": batch, "G": n_groups, "g": g, "d": d,
               "e": e, "masked_tail": masked_tail, "flops": flops, "bytes": nbytes,
               "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(lambda: flash_gated(*args)),
               "device_ms": graph_ms(lambda: flash_gated(*args)),
               "plain_ms": time_ms(lambda: flash_gated_plain(*args), iters=5),
               **design_bound(mma_flops, flops, nbytes, dname), "library_ms": None}
        emit("flash_gated", **row)
        if not rel <= TOL[dname]:
            raise AssertionError(f"flash_gated {label} {dname}: kernel vs plain rel err "
                                 f"{rel:.3g} > {TOL[dname]}")
        rows.append(row)
        del args, q, k, lq, v, u, got, want
    return rows


DWCONV_SHAPES = (  # (name, B, T, K, m, C, dilation, pad_l, pad_r, types) on the main path
    ("separator conv0", 2, 20224, 39, 1, 256, 1, 19, 19, ("float32", "bfloat16")),
    ("separator conv1", 2, 20224, 39, 2, 256, 2, 38, 38, ("float32", "bfloat16")),
    ("SAN-M memory, 60 s rung", 1, 1000, 11, 1, 256, 1, 5, 5, ("float32", "bfloat16")),
    ("VAD memory, 30 s rung", 1, 2998, 13, 1, 64, 1, 10, 2, ("float32", "bfloat16")),
    # SenseVoice's SAN-M memory over T + 4 rows (its 4 tag rows): the full
    # width (D 512, 50 layers) at the 30 s rung, and sv-bootstrap (D 192,
    # 6 layers) at the 16 s rung; both engines' stream is float32 there
    ("SenseVoice memory, full width, 30 s rung", 1, 504, 11, 1, 512, 1, 5, 5,
     ("float32", "bfloat16")),
    ("SenseVoice memory, sv-bootstrap, 16 s rung", 1, 271, 11, 1, 192, 1, 5, 5, ("float32",)),
    # Apollo's ConvActNorm, float32 only: in FusedSeparation 4 clips give 8
    # streams x 80 bands at the clip rung's STFT frames, 96 channels (the
    # 160k rung is the largest; infer's call a runs at the 64k rung); in
    # `restore`, one stream's 80 bands at the restorer's rung (1, 2, 4 s)
    # or its 6 s window (infer's call c)
    ("Apollo ConvActNorm, 160k rung x 4 clips", 640, 1001, 7, 1, 96, 1, 3, 3, ("float32",)),
    ("Apollo ConvActNorm, 64k rung x 4 clips", 640, 401, 7, 1, 96, 1, 3, 3, ("float32",)),
    *((f"Apollo restore, {t_out - 1} frames", 80, t_out, 7, 1, 96, 1, 3, 3, ("float32",))
      for t_out in (101, 201, 401, 601)),
    # ConvTasNet at its class defaults: a 4 s clip at the 64k rung is 7999
    # encoder frames of 512 channels; K 3 at dilations 2^i, i < 8, SAME pads.
    # 64 and 128 run on phase tiles (the dilated tile's halo does not fit)
    *((f"ConvTasNet TCN, dilation {d}", 1, 7999, 3, 1, 512, d, d, d, ("float32", "bfloat16"))
      for d in (1, 8, 32, 64, 128)),
    # the recipes' training steps, float32 (the recipes phase): FsmnVADNet at
    # batch 16 of 2 s (198 frames), the Paraformer's SAN-M memory at batch 16
    # of 4 s (67 LFR frames; the decoder's over 67 token slots), SenseVoice's
    # (67 + 4 rows), Apollo's at batch 8 of 2 s (8 x 80 bands, 201 frames),
    # the 64/4 separator's FSMN convs at batch 8 of 1 s (2048 frames)
    ("recipe: VAD memory, 16 x 2 s", 16, 198, 13, 1, 64, 1, 10, 2, ("float32",)),
    ("recipe: SAN-M memory, Paraformer 16 x 4 s", 16, 67, 11, 1, 256, 1, 5, 5, ("float32",)),
    ("recipe: SenseVoice memory, 16 x 4 s", 16, 71, 11, 1, 192, 1, 5, 5, ("float32",)),
    ("recipe: Apollo ConvActNorm, 8 x 2 s", 640, 201, 7, 1, 96, 1, 3, 3, ("float32",)),
    ("recipe: separator 64/4 conv0, 8 x 1 s", 8, 2048, 39, 1, 64, 1, 19, 19, ("float32",)),
    ("recipe: separator 64/4 conv1, 8 x 1 s", 8, 2048, 39, 2, 64, 2, 38, 38, ("float32",)),
)
# (B, T, C) of Apollo's depthwise convs held above
APOLLO_DW_SHAPES = {(b, t, c) for name, b, t, _, _, c, *_ in DWCONV_SHAPES
                    if name.startswith("Apollo")}


def check_dwconv() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv, dwconv_plain, prepare_taps

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, batch, t, k, m, c, dil, pad_l, pad_r, types in DWCONV_SHAPES:
        for dtype in (getattr(torch, n) for n in types):
            x = torch.randn(batch, t, c * m, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, m, c, generator=gen, device="cuda") * 0.2).to(dtype)
            args = (x, w, dil, pad_l, pad_r)
            # the taps as the modules hold them, made once (`prepare_taps`)
            taps = prepare_taps(w)
            before = dwconv.launches
            try:
                dwconv(*args)
            except ValueError:
                pass
            else:
                raise AssertionError("dwconv ran on the card without prepared taps")
            got = dwconv(*args, taps=taps)
            want = dwconv_plain(x, w, dil, pad_l, pad_r)
            if dwconv.launches != before + 1:
                raise AssertionError("dwconv did not launch its kernel")
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            dname = str(dtype).split(".")[1]
            t_out = got.shape[1]
            # the library's one call on a ready (B, C*m, T + pads) input
            xt = F.pad(x.transpose(1, 2), (pad_l, pad_r)).contiguous()
            wt = w.permute(2, 1, 0).contiguous()
            isz = x.element_size()
            flops = 2.0 * batch * t_out * c * k * m  # float32 FMA work in both types
            nbytes = isz * (batch * t * c * m + batch * t_out * c + k * m * c)
            bound_ms, bound_by = bound(flops, nbytes, "float32")
            # host-inclusive times of back-to-back calls, library and kernel in
            # turns (library, kernel, kernel, library); at the small shapes the
            # host's cost per call sets both, so five rounds and the medians
            small = batch * t * c * m < 1_000_000
            iters, rounds = (200, 5) if small else (20, 1)

            def library():
                return F.conv1d(xt, wt, dilation=dil, groups=c)

            kern_ms, lib_ms = [], []
            for _ in range(rounds):
                lib_ms.append(time_ms(library, iters=iters))
                kern_ms += [time_ms(lambda: dwconv(*args, taps=taps), iters=iters)
                            for _ in range(2)]
                lib_ms.append(time_ms(library, iters=iters))
            row = {"shape": name, "dtype": dname, "B": batch, "T": t, "K": k, "m": m, "C": c,
                   "dilation": dil, "pads": [pad_l, pad_r], "flops": flops, "bytes": nbytes,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": statistics.median(kern_ms), "ms_range": [min(kern_ms), max(kern_ms)],
                   "device_ms": graph_ms(lambda: dwconv(*args, taps=taps)),
                   "plain_ms": time_ms(lambda: dwconv_plain(x, w, dil, pad_l, pad_r)),
                   "library_ms": statistics.median(lib_ms),
                   "library_ms_range": [min(lib_ms), max(lib_ms)],
                   "library_device_ms": graph_ms(library),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit("dwconv", **row)
            if not rel <= TOL[dname]:
                raise AssertionError(f"dwconv {name} {dname}: kernel vs plain rel err "
                                     f"{rel:.3g} > {TOL[dname]}")
            rows.append(row)
            del x, got, want, xt, taps
    return rows


def check_flash_group(batch: int = 2, n_groups: int = 79, g: int = 256, d: int = 128,
                      e: int = 1024, masked_tail: int = 225) -> list[dict]:
    import torch

    from targetdiarization_tpu_torch.ops.kernels.flash import (flash_group_attention,
                                                               flash_group_plain)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = rnd(batch, n_groups, g, d, scale=4.0), rnd(batch, n_groups, g, d, scale=4.0)
        v, u = rnd(batch, n_groups, g, e), rnd(batch, n_groups, g, e)
        mask = torch.ones(batch, n_groups, 1, g, device="cuda", dtype=dtype)
        mask[:, -1, :, g - masked_tail:] = 0
        args = (q, k, v, u, mask)
        before = flash_group_attention.launches
        got = flash_group_attention(*args)
        want = flash_group_plain(*args)
        if flash_group_attention.launches != before + 1:
            raise AssertionError("flash_group_attention did not launch its kernel")
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        err, rel = max(x[0] for x in errs), max(x[1] for x in errs)
        dname = str(dtype).split(".")[1]
        isz = q.element_size()
        bg = batch * n_groups
        # targetdiarization_tpu/ops/pallas/flash.py:223-227's counts, at this type's size
        flops = 2.0 * bg * (g * g * d + 2 * g * g * e)
        nbytes = isz * bg * (2 * g * d + 4 * g * e + g)
        row = {"dtype": dname, "B": batch, "G": n_groups, "g": g, "d": d, "e": e,
               "masked_tail": masked_tail, "flops": flops, "bytes": nbytes,
               "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(lambda: flash_group_attention(*args)),
               "device_ms": graph_ms(lambda: flash_group_attention(*args)),
               "plain_ms": time_ms(lambda: flash_group_plain(*args), iters=5),
               **design_bound(flops, flops, nbytes, dname), "library_ms": None}
        emit("flash_group", **row)
        if not rel <= TOL[dname]:
            raise AssertionError(f"flash_group {dname}: kernel vs plain rel err "
                                 f"{rel:.3g} > {TOL[dname]}")
        rows.append(row)
        del args, q, k, v, u, got, want
    return rows


def plain_kernels():
    """Every kernel wrapper of the port patched to its plain version."""
    from contextlib import ExitStack
    from unittest import mock

    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwconv_op
    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv_plain
    from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm_plain
    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated_plain

    def ffconvm_plain_call(*args, prepared=None):
        return ffconvm_plain(*args)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(separation, "ffconvm", ffconvm_plain_call))
    stack.enter_context(mock.patch.object(separation, "flash_gated", flash_gated_plain))

    def dwconv_plain_call(x, kernel, dilation, pad_l, pad_r, taps=None):
        return dwconv_plain(x, kernel, dilation, pad_l, pad_r)

    stack.enter_context(mock.patch.object(dwconv_op, "dwconv", dwconv_plain_call))
    return stack


def reset_launches() -> None:
    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
    from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm
    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_group_attention

    for fn in (ffconvm, flash_gated, flash_group_attention, dwconv):
        fn.launches = 0
    dwconv.backward_launches = 0


def read_launches() -> dict:
    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
    from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm
    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_group_attention

    return {"ffconvm": ffconvm.launches, "flash_gated": flash_gated.launches,
            "flash_group": flash_group_attention.launches, "dwconv": dwconv.launches}


# ---------------- the slice: AudioProcessor.separate_speaker ----------------


def two_voice_mix(seconds: float, seed: int) -> np.ndarray:
    """Two harmonic voices of different pitch, each with a syllable-rate
    envelope and a slow pitch glide, the first about 8 dB louder."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR

    def voice(f0, rate, level):
        f = f0 * (1.0 + 0.06 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f) / SR
        env = np.clip(np.sin(2 * np.pi * rate * t + rng.uniform(0, 6.3)), 0, None) ** 1.5
        tone = sum(np.sin(h * phase) * 0.8 ** h for h in range(1, 9))
        return level * env * tone / np.max(np.abs(tone))

    mix = voice(125.0, 3.7, 0.5) + voice(235.0, 5.1, 0.2)
    return (mix + 0.002 * rng.standard_normal(t.size)).astype(np.float32)


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    est, ref = est - est.mean(), ref - ref.mean()
    proj = np.dot(est, ref) / max(np.dot(ref, ref), 1e-20) * ref
    noise = est - proj
    return float(10 * np.log10(np.dot(proj, proj) / max(np.dot(noise, noise), 1e-30)))


def run_clips(ap, clips: dict, label: str) -> dict:
    import torch

    from targetdiarization_tpu_torch.ops.loudness import integrated_loudness

    outs = {}
    for name, mix in clips.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        streams = ap.separate_speaker(mix, SR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out = np.stack(streams)
        if out.shape != (2, mix.size) or not np.isfinite(out).all():
            raise AssertionError(f"{label} {name}: bad output {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        louds = [integrated_loudness(s, SR) for s in out]
        if not louds[0] >= louds[1]:
            raise AssertionError(f"{label} {name}: stream loudness {louds} not loudest first")
        emit("separate_speaker", path=label, clip=name, audio_s=mix.size / SR,
             wall_s=wall, rtf=wall / (mix.size / SR), rtfx=mix.size / SR / wall, lufs=louds)
        outs[name] = out
    return outs


def profile_call(fn, label: str, top: int = 10, spans: bool = False) -> dict:
    """A diagnostic line: one call under `runtime/trace.py::device_profile`,
    read back from the Chrome trace JSON it writes: the call's device time
    by kernel name (the `top` largest; kernels, copies and sets), the sum of
    all device time, and that sum's share of the call's host-clock time
    (the rest is the device idle, waiting on the host). Wall time here
    includes the profiler's own overhead; `export_s` is the trace's export
    and reading. Where the trace holds no device time, the line says so.
    The `runtime/trace.py` spans are ranges on the host (`user_annotation`)
    and on the device's timeline (`gpu_user_annotation`); with `spans`, each
    one's calls, host ms and device range. Returns the trace's device
    events and host ranges, each counted by name."""
    import glob
    import tempfile
    from collections import Counter

    import torch

    from targetdiarization_tpu_torch.runtime.trace import device_profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with device_profile(log_dir):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    export_s = time.perf_counter() - t
    device_ms, device_n, ranges = Counter(), Counter(), Counter()
    by_span = {}
    for ev in events:
        cat, name, ms = ev.get("cat"), ev["name"], ev.get("dur", 0) / 1e3
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device_ms[name] += ms
            device_n[name] += 1
        elif cat == "user_annotation":
            ranges[name] += 1
            if spans:
                row = by_span.setdefault(name, {"calls": 0, "host_ms": 0.0})
                row["calls"] += 1
                row["host_ms"] += ms
        elif cat == "gpu_user_annotation" and spans:
            # the range on the device's timeline, first kernel to last
            row = by_span.setdefault(name, {"calls": 0, "host_ms": 0.0})
            row["device_span_ms"] = row.get("device_span_ms", 0.0) + ms
    if set(device_n) & set(ranges):
        raise AssertionError(f"{label}: the spans {sorted(set(device_n) & set(ranges))} "
                             "are counted as device events")
    rows = sorted(((ms, device_n[name], name) for name, ms in device_ms.items() if ms > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit("profile", path=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if wall_ms else None,
         top=[{"ms": ms, "count": n, "name": name[:90]} for ms, n, name in rows[:top]],
         **({"spans": by_span} if spans else {}), export_s=export_s,
         note=None if rows else "the profiler recorded no device time")
    return {"device": device_n, "ranges": ranges}


def trace_launches(device: dict) -> dict:
    """Launches of the port's kernels among a trace's device events, by the
    kernels' names (demangled or not): ffconvm_kernel, flash_kernel with
    the gated template argument true (gated FLASH) or false (the
    two-output form), dwconv_kernel. FFConvM's row_stats_kernel, which
    each FFConvM launch also runs, is not counted."""
    import re

    out = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0, "dwconv": 0}
    for name, n in device.items():
        if "ffconvm_kernel" in name:
            out["ffconvm"] += n
        elif "dwconv_kernel" in name:
            out["dwconv"] += n
        elif "flash_kernel" in name:
            gated = re.search(r"flash_kernel<[^,]+,\s*(true|false)", name) \
                or re.search(r"flash_kernelI\w+?Lb([01])E", name)
            if gated is None:
                raise AssertionError(f"a FLASH kernel of unknown form in the trace: {name}")
            out["flash_gated" if gated.group(1) in ("true", "1") else "flash_group"] += n
    return out


# ---------------- the host library: utils/native.py ----------------

METER_LU_TOL = 1e-9  # the C++ meter against the numpy one (tests/test_torch_native.py)


def host_ms(fn, iters: int) -> float:
    """Median host milliseconds of `iters` calls after one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def check_host() -> dict:
    """The port's host library (`csrc/host/tdaudio.cpp`, built with g++ at
    first use): its build seconds, the C++ BS.1770 meter's and the numpy
    meter's median host ms on 1 s and 46 s of seeded speech (the
    conversation of `check_frontend`), which must agree within
    METER_LU_TOL, and the PCM converters, `resample_linear` and the ring
    against their numpy versions, bit for bit."""
    from targetdiarization_tpu_torch.ops.loudness import integrated_loudness
    from targetdiarization_tpu_torch.utils import native

    if native.disabled():
        raise AssertionError("TD_DISABLE_NATIVE=1: the host library would not run")
    path = native.library_path()
    built = not os.path.exists(path)
    t = time.perf_counter()
    native.load_library()
    load_s = time.perf_counter() - t
    speech = conversation(46.0, seed=8)
    meters = {}
    for name, x in (("1 s", speech[:SR]), ("46 s", speech)):
        lib, plain = native.integrated_loudness_native(x, SR), integrated_loudness(x, SR)
        if not (np.isfinite(lib) and abs(lib - plain) <= METER_LU_TOL):
            raise AssertionError(f"host meter on {name}: C++ {lib} LUFS, numpy {plain} LUFS")
        iters = 50 if name == "1 s" else 10
        meters[name] = {"lufs": lib, "plain_lufs": plain, "diff_lu": lib - plain,
                        "ms": host_ms(lambda: native.integrated_loudness_native(x, SR), iters),
                        "plain_ms": host_ms(lambda: integrated_loudness(x, SR), iters)}
    rng = np.random.default_rng(19)
    audio = rng.uniform(-1.2, 1.2, SR).astype(np.float32)
    pcm = rng.integers(-32768, 32768, SR).astype(np.int16)
    ring, ring_plain = native.RingBuffer(SR), native.RingBufferPlain(SR)
    pushed = [r.push(audio) for r in (ring, ring_plain)]
    popped = [r.pop(SR // 3) for r in (ring, ring_plain)]
    same = {"f32_to_pcm16": np.array_equal(native.f32_to_pcm16(audio),
                                           native.f32_to_pcm16_plain(audio)),
            "pcm16_to_f32": np.array_equal(native.pcm16_to_f32(pcm),
                                           native.pcm16_to_f32_plain(pcm)),
            "resample_linear": np.array_equal(native.resample_linear(audio, 44100),
                                              native.resample_linear_plain(audio, 44100)),
            "ring": pushed[0] == pushed[1] and np.array_equal(*popped)
            and len(ring) == len(ring_plain) and ring.space() == ring_plain.space()}
    emit("host_library", library=os.path.relpath(path, ROOT),
         **({"build_s": load_s} if built else {"load_s": load_s, "note": "already built"}),
         meter=meters, equal_to_numpy=same)
    if not all(same.values()):
        raise AssertionError(f"the host library against its numpy versions: {same}")
    return meters


def check_slice() -> dict:
    import torch

    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    clips = {"12s": two_voice_mix(12.0, seed=0), "3s": two_voice_mix(3.0, seed=1)}
    t = time.time()
    ap = AudioProcessor(CHECKPOINT, device="cuda")
    if not ap.is_separate_speaker or ap.separator.compute_dtype != torch.bfloat16:
        raise AssertionError("the 512/24 separator did not load in bfloat16 on the card")
    net = ap.separator.model.mask_net
    layers = len(net.layers)
    # the JAX model's types: bf16 up to the bottleneck, then a float32
    # stream from bf16-rounded weights, so every FFConvM runs two passes
    ops = [m.kernel_ops for m in net.layers.modules() if hasattr(m, "kernel_ops")]
    types = {"bottleneck": str(net.bottleneck.weight.dtype),
             "layer_params": sorted({str(p.dtype) for p in net.layers.parameters()}),
             "ffconvm_operands": sorted({str(o.dtype) for o in ops}),
             "ffconvm_w_lo": sum(o.w_lo is not None for o in ops)}
    emit("load", checkpoint=os.path.relpath(CHECKPOINT, ROOT), layers=layers,
         load_s=time.time() - t, **types)
    if types["bottleneck"] != "torch.bfloat16" or types["layer_params"] != ["torch.float32"] \
            or types["ffconvm_operands"] != ["torch.float32"] or types["ffconvm_w_lo"] \
            or len(ops) != 5 * layers:
        raise AssertionError(f"the bf16 separator does not compute in the JAX types: {types}")
    ap.separate_speaker(clips["3s"][:SR], SR)  # warm-up: cuBLAS and cuDNN set-up

    # the main path, counted: one forward per call (the 12 s clip is two
    # 160k windows in one batch, the 3 s clip one 64k bucket)
    reset_launches()
    main = run_clips(ap, clips, "bf16 kernels")
    launches = read_launches()
    forwards = len(clips)
    want = {"ffconvm": 5 * layers * forwards, "flash_gated": layers * forwards,
            "flash_group": 0, "dwconv": 2 * layers * forwards}
    emit("launches", path="separate_speaker", forwards=forwards, **launches)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on the separator path, want {want}")

    profile_call(lambda: ap.separate_speaker(clips["12s"], SR), "bf16 kernels, 12 s clip")
    with plain_kernels():
        plain_bf = run_clips(ap, clips, "bf16 plain")
    ap32 = AudioProcessor(CHECKPOINT, device="cuda", compute_dtype="float32")
    kern32 = run_clips(ap32, clips, "f32 kernels")
    with plain_kernels():
        plain32 = run_clips(ap32, clips, "f32 plain")
    for name in clips:
        f32 = [si_sdr(kern32[name][s], plain32[name][s]) for s in range(2)]
        bf16 = [si_sdr(main[name][s], plain32[name][s]) for s in range(2)]
        # both compute in float32 from the same bf16-rounded weights
        bf16_plain = [si_sdr(main[name][s], plain_bf[name][s]) for s in range(2)]
        emit("agreement", clip=name, si_sdr_f32_kernels_vs_plain=f32,
             si_sdr_bf16_kernels_vs_bf16_plain=bf16_plain,
             si_sdr_bf16_kernels_vs_f32_plain=bf16)
        if min(bf16_plain) < 40.0:
            raise AssertionError(f"{name}: bf16 kernel path vs bf16 plain SI-SDR "
                                 f"{bf16_plain} < 40 dB")
        if min(f32) < 40.0:
            raise AssertionError(f"{name}: f32 kernel path vs plain SI-SDR {f32} < 40 dB")
        if min(bf16) < 10.0:
            raise AssertionError(f"{name}: bf16 kernel path vs f32 plain SI-SDR {bf16} < 10 dB")
    return launches


# ---------------- the slice: ASRProcessor (VAD, Paraformer, punctuation) ----------------
#
# Speech of the kind the bootstrap models were trained on: a numpy copy of
# targetdiarization_tpu/train/synth.py (BOOT_CHARS, _char_params, synth_char,
# synth_utterance), which this script cannot import on a machine without jax.

BOOT_CHARS = "一二三四五六七八九十天地人日月水火山石田土王中大小上下左右心口手"


def _char_params(idx: int) -> dict:
    f1 = 280.0 + 170.0 * (idx % 6)
    f2 = 1000.0 + 240.0 * ((idx // 6) % 6)
    dur = 0.16 + 0.05 * (idx % 3)
    fricative = (idx % 8) == 7
    return {"f1": f1, "f2": f2, "dur": dur, "fricative": fricative}


def synth_char(idx: int, rng: np.random.Generator, sr: int = SR) -> np.ndarray:
    """One formant-synthesised syllable for char #idx, with jitter."""
    p = _char_params(idx)
    dur = p["dur"] * rng.uniform(0.9, 1.1)
    n = int(dur * sr)
    t = np.arange(n) / sr
    bw = 130.0
    if p["fricative"]:
        noise = rng.standard_normal(n).astype(np.float32)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        shape = (np.exp(-((freqs - p["f1"]) / (2 * bw)) ** 2)
                 + 0.8 * np.exp(-((freqs - p["f2"]) / (2 * bw)) ** 2))
        out = np.fft.irfft(spec * shape, n=n).astype(np.float32)
    else:
        f0 = rng.uniform(95.0, 220.0)
        out = np.zeros(n, np.float32)
        k_max = int(4000.0 / f0)
        for k in range(1, k_max + 1):
            fk = k * f0
            amp = (np.exp(-((fk - p["f1"]) / bw) ** 2)
                   + 0.7 * np.exp(-((fk - p["f2"]) / bw) ** 2)
                   + 0.02 / k)
            phase = rng.uniform(0, 2 * np.pi)
            out += (amp * np.sin(2 * np.pi * fk * t + phase)).astype(np.float32)
    att = max(int(0.02 * sr), 1)
    env = np.ones(n, np.float32)
    env[:att] = np.linspace(0, 1, att)
    env[-att:] *= np.linspace(1, 0, att)
    out *= env
    peak = np.abs(out).max() + 1e-9
    return (out / peak * rng.uniform(0.25, 0.6)).astype(np.float32)


def synth_utterance(text: str, rng: np.random.Generator, sr: int = SR,
                    noise_snr_db: float | None = None):
    """`text` (chars of BOOT_CHARS) -> (audio, [(start_s, end_s) per char])."""
    pieces = [np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32)]
    cursor = len(pieces[0])
    ranges = []
    for i, ch in enumerate(text):
        idx = BOOT_CHARS.index(ch)
        unit = synth_char(idx, rng, sr)
        ranges.append((cursor / sr, (cursor + len(unit)) / sr))
        pieces.append(unit)
        cursor += len(unit)
        if i < len(text) - 1:
            gap = np.zeros(int(rng.uniform(0.02, 0.07) * sr), np.float32)
            pieces.append(gap)
            cursor += len(gap)
    pieces.append(np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32))
    audio = np.concatenate(pieces)
    if noise_snr_db is not None:
        noise = rng.standard_normal(len(audio)).astype(np.float32)
        sig_p = np.mean(audio ** 2) + 1e-12
        noise_p = np.mean(noise ** 2)
        noise *= np.sqrt(sig_p / noise_p * 10 ** (-noise_snr_db / 10))
        audio = audio + noise
    return audio.astype(np.float32), ranges


def cer(ref: str, hyp: str) -> float:
    """Character error rate (Levenshtein distance / len(ref))."""
    if not ref:
        return 0.0 if not hyp else 1.0
    d = np.arange(len(hyp) + 1, dtype=np.int32)
    for i, rc in enumerate(ref, 1):
        prev = d[0]
        d[0] = i
        for j, hc in enumerate(hyp, 1):
            cur = d[j]
            d[j] = min(d[j] + 1, d[j - 1] + 1, prev + (rc != hc))
            prev = cur
    return float(d[-1]) / len(ref)


PUNCT = "，。？、！"


def strip_punct(text: str) -> str:
    return "".join(ch for ch in text if ch not in PUNCT)


def asr_inputs(seed: int = 7) -> dict:
    """Four utterances of 4-12 characters, a ~45 s clip of utterances and
    silences (the 60 s rung: T = 1000 LFR frames) and its first 30 s (the
    VAD's top rung)."""
    rng = np.random.default_rng(seed)

    def text(n):
        return "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(n))

    texts = [text(n) for n in (4, 7, 10, 12)]
    utts = [synth_utterance(t, rng)[0] for t in texts]
    pieces, long_text = [], []
    while sum(len(p) for p in pieces) < 45 * SR:
        t = text(int(rng.integers(4, 13)))
        pieces.append(synth_utterance(t, rng)[0])
        pieces.append(np.zeros(int(rng.uniform(0.5, 1.5) * SR), np.float32))
        long_text.append(t)
    long = np.concatenate(pieces)[:int(46 * SR)]
    return {"texts": texts, "utts": utts, "long": long, "long_text": "".join(long_text),
            "vad30": long[:30 * SR]}


def run_asr_calls(ap, data: dict, label: str, timed: bool = False) -> dict:
    """The ASR stage's entry points on `data`; wall times when `timed`."""
    import torch

    out: dict = {}

    def call(name, audio_s, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if timed:
            emit("asr_call", path=label, call=name, audio_s=audio_s, wall_s=wall,
                 rtfx=audio_s / wall if audio_s else None)
        return res

    out["utts"] = [call(f"asr_detection {len(u) / SR:.2f} s", len(u) / SR,
                        lambda u=u: ap.asr_detection(u, SR)[0]) for u in data["utts"]]
    out["batch"] = call("asr_detection_batch x4", sum(len(u) for u in data["utts"]) / SR,
                        lambda: ap.asr_detection_batch(data["utts"], SR))
    out["long"] = call(f"asr_detection {len(data['long']) / SR:.1f} s", len(data["long"]) / SR,
                       lambda: ap.asr_detection(data["long"], SR)[0])
    out["vad_long"] = call(f"vad_detection {len(data['long']) / SR:.1f} s",
                           len(data["long"]) / SR, lambda: ap.vad_detection(data["long"], SR))
    out["vad30"] = call("vad_detection 30 s", 30.0, lambda: ap.vad_detection(data["vad30"], SR))
    split = call(f"asr_vad_split {len(data['long']) / SR:.1f} s", len(data["long"]) / SR,
                 lambda: ap.asr_vad_split(data["long"], SR))
    out["split"] = [(s, e, len(c)) for s, e, c in split]
    raw = [strip_punct(r["text"]) for r in out["batch"]]
    out["punc"] = call("punctuation_restore_batch x4", None,
                       lambda: ap.punctuation_restore_batch(raw))
    return out


def check_timestamps(res: dict, label: str) -> None:
    """Monotonic [start, end] lists, one entry per character of the text."""
    for r in res["utts"] + res["batch"] + [res["long"]]:
        ts, text = r["timestamp"], strip_punct(r["text"])
        if len(ts) != len(text):
            raise AssertionError(f"{label}: {len(ts)} timestamps for {len(text)} "
                                 f"characters in {text!r}")
        flat = [x for se in ts for x in se]
        if any(b < a for a, b in zip(flat, flat[1:])):
            raise AssertionError(f"{label}: timestamps not monotonic: {ts}")


def same_results(a: dict, b: dict, label: str) -> None:
    """Same texts, punctuation and VAD segments; timestamps within 60 ms."""
    ra = a["utts"] + a["batch"] + [a["long"]]
    rb = b["utts"] + b["batch"] + [b["long"]]
    for x, y in zip(ra, rb):
        if x["text"] != y["text"] or len(x["timestamp"]) != len(y["timestamp"]):
            raise AssertionError(f"{label}: {x['text']!r} vs {y['text']!r}")
        for (s1, e1), (s2, e2) in zip(x["timestamp"], y["timestamp"]):
            if abs(s1 - s2) > 60 or abs(e1 - e2) > 60:
                raise AssertionError(f"{label}: timestamps differ by more than 60 ms")
    for key in ("vad_long", "vad30", "split", "punc"):
        if a[key] != b[key]:
            raise AssertionError(f"{label}: {key} differs: {a[key]} vs {b[key]}")


def check_asr() -> dict:
    import torch

    from targetdiarization_tpu_torch.models.asr import _SAMPLE_LADDER, LFR_N
    from targetdiarization_tpu_torch.models.features import num_frames
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor

    data = asr_inputs()
    rungs = sorted({_SAMPLE_LADDER.bucket(len(u)) / SR for u in data["utts"]})
    long_rung = _SAMPLE_LADDER.bucket(len(data["long"])) / SR
    emit("asr_inputs", texts=data["texts"], seconds=[len(u) / SR for u in data["utts"]],
         rungs_s=rungs, long_s=len(data["long"]) / SR)
    if len(rungs) < 2 or long_rung != 60:
        raise AssertionError(f"inputs land in rungs {rungs} and {long_rung}; "
                             "want two or more, and 60 s")
    kw = {f"{k}_model": v for k, v in ASR_CHECKPOINTS.items()}
    t = time.time()
    ap = ASRProcessor(**kw, device="cuda")
    if ap.asr.compute_dtype != torch.bfloat16:
        raise AssertionError("the ASR engines did not load in bfloat16 on the card")
    emit("asr_load", load_s=time.time() - t)
    run_asr_calls(ap, data, "warm-up")

    # the main path, counted: every Paraformer and VAD forward, by hooks
    forwards = {"asr": 0, "vad": 0}
    hooks = [ap.asr.model.register_forward_hook(lambda *_: forwards.__setitem__(
                 "asr", forwards["asr"] + 1)),
             ap.vad.model.register_forward_hook(lambda *_: forwards.__setitem__(
                 "vad", forwards["vad"] + 1))]
    reset_launches()
    main = run_asr_calls(ap, data, "bf16 kernels", timed=True)
    launches = read_launches()
    for h in hooks:
        h.remove()
    emit("launches", path="ASRProcessor", paraformer_forwards=forwards["asr"],
         vad_forwards=forwards["vad"], **launches)
    want = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0,
            "dwconv": 12 * forwards["asr"] + 4 * forwards["vad"]}
    if launches != want or not forwards["asr"] or not forwards["vad"]:
        raise AssertionError(f"kernel launches {launches} on the ASR path with {forwards} "
                             f"forwards, want {want}")
    check_timestamps(main, "bf16 kernels")

    ap32 = ASRProcessor(**kw, device="cuda", compute_dtype="float32")
    kern32 = run_asr_calls(ap32, data, "f32 kernels", timed=True)
    with plain_kernels():
        plain32 = run_asr_calls(ap32, data, "f32 plain", timed=True)
    check_timestamps(kern32, "f32 kernels")
    same_results(kern32, plain32, "f32 kernels vs f32 plain")
    for label, res in (("bf16 kernels", main), ("f32 kernels", kern32)):
        empty = [t for t, r in zip(data["texts"], res["utts"]) if not r["text"]]
        if empty:
            raise AssertionError(f"{label}: empty transcripts for trained utterances {empty}")

    # bf16 against f32 plain: the encoder output at the 60 s rung
    long_b = np.pad(data["long"], (0, 60 * SR - len(data["long"])))[None]
    t_lfr = [-(-num_frames(len(data["long"])) // LFR_N)]
    with torch.inference_mode():
        enc_bf = ap.asr.forward_device(long_b, t_lfr)["encoder_out"].float()
        with plain_kernels():
            enc_32 = ap32.asr.forward_device(long_b, t_lfr)["encoder_out"]
    _, enc_rel = rel_err(enc_bf, enc_32)
    cer_bf16 = [cer(strip_punct(b["text"]), strip_punct(a["text"]))
                for a, b in zip(main["utts"] + [main["long"]],
                                plain32["utts"] + [plain32["long"]])]
    cer_ref = [cer(t, strip_punct(r["text"])) for t, r in zip(data["texts"], kern32["utts"])]
    emit("asr_agreement", encoder_rel_err_bf16_vs_f32_plain=enc_rel,
         cer_bf16_vs_f32_plain=cer_bf16, cer_f32_vs_rendered_text=cer_ref,
         cer_long_f32_vs_rendered_text=cer(data["long_text"],
                                           strip_punct(kern32["long"]["text"])),
         texts_bf16=[r["text"] for r in main["utts"]],
         texts_f32=[r["text"] for r in kern32["utts"]],
         vad30_segments=kern32["vad30"])
    if not enc_rel <= 0.1:
        raise AssertionError(f"bf16 encoder output vs f32 plain rel err {enc_rel:.3g} > 0.1")
    return launches


# ---------------- the slice: FusedFrontend (preprocess, VAD, segmentation, embeddings) ----------------


def voice_b(audio: np.ndarray) -> np.ndarray:
    """A second voice from the synthesis: played 1.25 x faster, so pitch
    and formants sit a major third higher."""
    return np.interp(np.arange(0, len(audio), 1.25), np.arange(len(audio)),
                     audio).astype(np.float32)


def conversation(seconds: float, seed: int) -> np.ndarray:
    """Two voices taking turns, each turn starting before the last ends
    (overlapped speech), with pauses now and then."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos, voice = int(0.3 * SR), 0
    while pos < len(out) - SR // 2:
        text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                       for _ in range(int(rng.integers(4, 12))))
        utt = synth_utterance(text, rng)[0]
        utt = voice_b(utt) if voice else utt
        n = min(len(utt), len(out) - pos)
        out[pos: pos + n] += utt[:n]
        pause = rng.uniform(0.4, 1.2) if rng.random() < 0.3 else -0.25
        pos += max(n + int(pause * SR), SR // 4)
        voice ^= 1
    return out


def dialogue(seconds: float, seed: int, overlap: bool) -> np.ndarray:
    """Two voices in turns of 8-12 characters: with `overlap` every second
    turn starts 1.0-1.4 s before the last one ends (an overlapped stretch
    of at least 1 s) and the others 0.8-1.2 s after it; without, each turn
    starts 0.3-0.7 s after the last."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos, voice, turn = int(0.3 * SR), 0, 0
    while pos < len(out) - SR:
        text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                       for _ in range(int(rng.integers(8, 13))))
        utt = synth_utterance(text, rng)[0]
        utt = voice_b(utt) if voice else utt
        n = min(len(utt), len(out) - pos)
        out[pos: pos + n] += utt[:n]
        if not overlap:
            shift = rng.uniform(0.3, 0.7)
        else:
            shift = -rng.uniform(1.0, 1.4) if turn % 2 == 0 else rng.uniform(0.8, 1.2)
        pos += max(n + int(shift * SR), SR // 2)
        voice ^= 1
        turn += 1
    return out


def enrollment(seconds: float, seed: int) -> np.ndarray:
    """Utterances of the second voice alone, with short pauses."""
    rng = np.random.default_rng(seed)
    pieces, total = [], 0
    while total < seconds * SR:
        text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(8))
        pieces += [voice_b(synth_utterance(text, rng)[0]),
                   np.zeros(int(rng.uniform(0.2, 0.5) * SR), np.float32)]
        total += len(pieces[-2]) + len(pieces[-1])
    return np.concatenate(pieces)[: int(seconds * SR)]


def load_frontend(compute_dtype: str | None = None):
    """The front end as a user builds it: the denoiser through
    `AudioProcessor(denoise_model=...)`, the other engines from their
    checkpoints, all in the card's default types unless `compute_dtype`."""
    from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
    from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
    from targetdiarization_tpu_torch.models.vad import VADEngine
    from targetdiarization_tpu_torch.pipeline.fused import FusedFrontend
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    kw = {"device": "cuda", "compute_dtype": compute_dtype}
    ap = AudioProcessor(denoise_model=FRONTEND_CHECKPOINTS["den"], **kw)
    fe = FusedFrontend(ap.denoiser,
                       VADEngine.from_pretrained(FRONTEND_CHECKPOINTS["vad"], **kw),
                       SegmentationEngine.from_pretrained(FRONTEND_CHECKPOINTS["seg"], **kw),
                       SpeakerEngine.from_pretrained(FRONTEND_CHECKPOINTS["spk"], **kw))
    return ap, fe


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.atleast_2d(a).astype(np.float64), np.atleast_2d(b).astype(np.float64)
    return (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1),
                                        1e-30)


def front_end_agreement(got: dict, want: dict, got_emb: np.ndarray, want_emb: np.ndarray) -> dict:
    from targetdiarization_tpu_torch.models.vad import VADConfig, segment_probs

    seg_got = segment_probs(got["vad_probs"], VADConfig())
    seg_want = segment_probs(want["vad_probs"], VADConfig())
    return {"track_identical": bool(np.array_equal(got["audio"], want["audio"])),
            "track_si_sdr_db": si_sdr(got["audio"], want["audio"]),
            "vad_probs_max_abs": float(np.abs(got["vad_probs"] - want["vad_probs"]).max()),
            "seg_act_max_abs": float(np.abs(got["seg_act"] - want["seg_act"]).max()),
            "win_embs_min_cos": float(cosines(got["win_embs"], want["win_embs"]).min()),
            "enroll_emb_cos": float(cosines(got_emb, want_emb)[0]),
            "win_times_equal": got["win_times"] == want["win_times"],
            "vad_segments": [len(seg_got), len(seg_want)],
            "vad_segments_within_20ms": len(seg_got) == len(seg_want) and all(
                abs(a - b) <= 0.02 for x, y in zip(seg_got, seg_want) for a, b in zip(x, y))}


def check_frontend() -> dict:
    import torch

    from targetdiarization_tpu_torch.models.speaker import BatchNorm

    conv, clip = conversation(46.0, seed=8), enrollment(8.0, seed=9)
    t = time.time()
    ap, fe = load_frontend()
    seg_net, spk_net = fe.seg.model, fe.spk.model
    norms = {id(p) for m in spk_net.modules() if isinstance(m, BatchNorm) for p in m.parameters()}
    types = {"denoiser": sorted({str(p.dtype) for p in ap.denoiser.model.parameters()}),
             "vad": sorted({str(p.dtype) for p in fe.vad.model.parameters()}),
             "seg_convs": sorted({str(p.dtype) for m in (seg_net.conv1, seg_net.conv2)
                                  for p in m.parameters()}),
             "seg_rest": sorted({str(p.dtype) for m in (seg_net.layers, seg_net.head)
                                 for p in m.parameters()}),
             "spk_batchnorms": sorted({str(p.dtype) for p in spk_net.parameters()
                                       if id(p) in norms}),
             "spk_rest": sorted({str(p.dtype) for p in spk_net.parameters()
                                 if id(p) not in norms})}
    emit("frontend_load", checkpoints={k: os.path.relpath(v, ROOT)
                                       for k, v in FRONTEND_CHECKPOINTS.items()},
         load_s=time.time() - t, hop=ap.denoiser.hop, conversation_s=len(conv) / SR,
         enrollment_s=len(clip) / SR, **types)
    bf, f32 = ["torch.bfloat16"], ["torch.float32"]
    if types != {"denoiser": bf, "vad": bf, "seg_convs": bf, "seg_rest": f32,
                 "spk_batchnorms": bf, "spk_rest": f32}:
        raise AssertionError(f"the front end does not compute in the JAX package's types: {types}")
    fe.analyze(conv)  # warm-up: cuDNN, cuFFT and cuBLAS set-up at these shapes
    fe.enroll(clip)

    # the main path, counted: analyze of the 46 s conversation (a 30 s and a
    # 16 s part) and enroll of the 8 s clip, with the VAD's forwards by hook
    vad_forwards = [0]
    hook = fe.vad.model.register_forward_hook(
        lambda *_: vad_forwards.__setitem__(0, vad_forwards[0] + 1))
    reset_launches()
    main, analyze_s = timed(lambda: fe.analyze(conv))
    after_analyze = read_launches()
    main_enroll, enroll_s = timed(lambda: fe.enroll(clip))
    launches = read_launches()
    hook.remove()
    emit("launches", path="FusedFrontend", vad_forwards=vad_forwards[0],
         analyze=after_analyze, enroll={k: launches[k] - after_analyze[k] for k in launches},
         **launches)
    want = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0, "dwconv": 4 * vad_forwards[0]}
    if launches != want or vad_forwards[0] != 3 or after_analyze["dwconv"] != 8:
        raise AssertionError(f"kernel launches {launches} on the front end with "
                             f"{vad_forwards[0]} VAD forwards, want {want} from 3")
    n, top = len(conv), 30 * SR  # frames counted in each 30 s part
    frames = sum((min(top, n - i) - 400) // 160 + 1 for i in range(0, n, top))
    if (main["audio"].shape != (n,) or len(main["vad_probs"]) != frames
            or main["seg_act"].shape[1] != 3 or main["win_embs"].shape[1] != 192
            or len(main["win_times"]) != len(main["win_embs"])
            or not all(np.isfinite(main[k]).all() for k in ("audio", "vad_probs", "seg_act",
                                                             "win_embs"))
            or main_enroll["emb"].shape != (192,) or not np.isfinite(main_enroll["emb"]).all()):
        raise AssertionError("the front end's outputs have the wrong shapes or are not finite")
    denoised, denoise_s = timed(lambda: ap.denoise_vocal(conv, SR))
    for name, audio_s, wall in (("analyze", n / SR, analyze_s), ("enroll", len(clip) / SR,
                                                                 enroll_s),
                                ("denoise_vocal", n / SR, denoise_s)):
        emit("frontend_call", path="bf16 kernels", call=name, audio_s=audio_s, wall_s=wall,
             rtfx=audio_s / wall)
    emit("frontend_outputs", vad_frames=len(main["vad_probs"]),
         speech_share=float((main["vad_probs"] > 0.5).mean()),
         seg_frames=main["seg_act"].shape[0], windows=len(main["win_embs"]),
         enroll_vs_windows_cos_max_median=[
             float(f(cosines(main["win_embs"], main_enroll["emb"]))) for f in (np.max, np.median)],
         denoise_vocal_finite=bool(np.isfinite(denoised).all()))
    profile_call(lambda: fe.analyze(conv), "FusedFrontend.analyze, 46 s", top=12)

    # float32: the kernel path against the plain path (only the VAD holds a
    # kernel, so the track, the activations and the embeddings are the same)
    _, fe32 = load_frontend("float32")
    kern32 = fe32.analyze(conv), fe32.enroll(clip)["emb"]
    with plain_kernels():
        plain32 = fe32.analyze(conv), fe32.enroll(clip)["emb"]
    f32 = front_end_agreement(kern32[0], plain32[0], kern32[1], plain32[1])
    bf16 = front_end_agreement(main, plain32[0], main_enroll["emb"], plain32[1])
    emit("frontend_agreement", f32_kernels_vs_f32_plain=f32, bf16_kernels_vs_f32_plain=bf16)
    if not (f32["track_identical"] and f32["vad_probs_max_abs"] <= 1e-4
            and f32["seg_act_max_abs"] <= 1e-4 and f32["win_embs_min_cos"] >= 0.9999
            and f32["enroll_emb_cos"] >= 0.9999 and f32["win_times_equal"]):
        raise AssertionError(f"float32 kernel path vs float32 plain path: {f32}")
    if bf16["track_si_sdr_db"] < 10.0 or min(bf16["win_embs_min_cos"],
                                             bf16["enroll_emb_cos"]) < 0.95:
        raise AssertionError(f"bf16 front end vs float32 plain path: {bf16}")
    return launches


# ---------------- the slice: TargetDiarization.infer ----------------

INFER_CHECKPOINTS = {name: os.path.join(ROOT, "checkpoints", f"{name}-bootstrap")
                     for name in ("den", "vad", "seg", "spk", "rest", "asr", "punc")}


def load_system(compute_dtype: str | None = None, device: str = "cuda",
                separation: str = CHECKPOINT):
    """`TargetDiarization` as the server's `build_model` makes it: the
    denoiser, separator and restorer in `AudioProcessor`, VAD, Paraformer
    and punctuation in `ASRProcessor`, the speaker engine in `TargetASR`,
    the segmentation engine; all on `device` in the card's types unless
    `compute_dtype`."""
    from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
    from targetdiarization_tpu_torch.pipeline.offline import TargetDiarization
    from targetdiarization_tpu_torch.pipeline.target_asr import TargetASR
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    c, kw = INFER_CHECKPOINTS, {"device": device, "compute_dtype": compute_dtype}
    ap = AudioProcessor(separation, denoise_model=c["den"], restoration_model=c["rest"], **kw)
    asrp = ASRProcessor(vad_model=c["vad"], asr_model=c["asr"], punc_model=c["punc"], **kw)
    tasr = TargetASR(ap, asrp, embedding_model=c["spk"], **kw)
    return TargetDiarization(tasr, segmentation_engine=SegmentationEngine.from_pretrained(
        c["seg"], **kw))


def infer_inputs() -> tuple[dict, np.ndarray]:
    """The three calls (name -> (audio, infer keywords)) and the 8 s
    enrollment of the second voice. (a)'s target has three overlap clips
    of 2-4 s (`FusedSeparation`, Apollo in the same pass); (c)'s has more
    than four (the separator's batch and Apollo per stream). (b) runs in
    the single-speaker mode: the bootstrap segmentation model marks two
    channels on any speech, so with a target the multi-speaker path always
    separates, and only the single-speaker mode reaches `FusedASR`."""
    return ({"a: overlapped dialogue 20 s": (dialogue(20.0, seed=13, overlap=True), {}),
             "b: dialogue in turns 20 s, is_single": (dialogue(20.0, seed=12, overlap=False),
                                                      {"is_single": True}),
             "c: conversation 46 s": (conversation(46.0, seed=8), {})},
            enrollment(8.0, seed=9))


def dw_per_forward(model) -> int:
    """dwconv launches of one forward of `model`: its FSMN memories (the
    separator's two per layer, the VAD's, the Paraformer's SAN-M blocks)
    and Apollo's depthwise convs."""
    n = 0
    for m in model.modules():
        n += len(getattr(m, "conv_taps", None) or ())
        n += int(getattr(m, "memory_taps", None) is not None)
        n += int(getattr(m, "fsmn_taps", None) is not None)
        n += int(type(m).__name__ == "DepthwiseConv1d")
    return n


class PathCounter:
    """Forwards of the system's models (by hook), the (B, T, C) inputs of
    Apollo's depthwise convs, and kernel launches per trace span (by the
    trace module's hooks), between `start` and `stop`."""

    def __init__(self, td, asr_name: str = "paraformer"):
        from targetdiarization_tpu_torch.models.restoration import DepthwiseConv1d
        from targetdiarization_tpu_torch.runtime import trace

        self.trace = trace
        self.models = {"separator": td.ap.separator.model, "apollo": td.ap.restorer.model,
                       "vad": td.tasr.asrp.vad.model, asr_name: td.tasr.asrp.asr.model}
        self.per_forward = {k: dw_per_forward(m) for k, m in self.models.items()}
        self.apollo_convs = [m for m in self.models["apollo"].modules()
                             if isinstance(m, DepthwiseConv1d)]

    def start(self):
        self.forwards = {k: 0 for k in self.models}
        self.apollo_shapes = set()
        self.spans, self._open = {}, []
        self.handles = [m.register_forward_hook(
            lambda *_, k=k: self.forwards.__setitem__(k, self.forwards[k] + 1))
            for k, m in self.models.items()]
        self.handles += [m.register_forward_pre_hook(
            lambda _, args: self.apollo_shapes.add(tuple(args[0].shape)))
            for m in self.apollo_convs]
        self.trace.HOOKS.append(self._span)
        reset_launches()

    def _span(self, name: str, entering: bool):
        if entering:
            self._open.append(read_launches())
            return
        before, now = self._open.pop(), read_launches()
        row = self.spans.setdefault(name, {"calls": 0, **{k: 0 for k in now}})
        row["calls"] += 1
        for k in now:
            row[k] += now[k] - before[k]

    def stop(self) -> dict:
        for h in self.handles:
            h.remove()
        self.trace.HOOKS.remove(self._span)
        return read_launches()


def record_target_pieces(td) -> dict:
    """Wraps `td`'s ASR assembly so that after each infer call the returned
    dict holds, under "pieces", the target's entries as (type, first and
    end sample of the timerange, audio, the audio's first sample). A single
    entry's audio is its timerange of the analysed track; a separated
    one's is the stream of its whole overlap clip, which starts where the
    target's overlap range holding it starts (the clip that
    `sd_result_to_asr_audio` cut)."""
    from targetdiarization_tpu_torch.pipeline import intervals as iv

    seen = {"clip_starts": [], "pieces": []}
    assemble, parse = td.sd_result_to_asr_audio, td.asr_audio_parser

    def assembling(audio, sr, sd_result=None, overlap_map=None, target_spk="", *a, **k):
        ranges = (iv.subtract_overlap(sd_result, overlap_map, reverse_output=True)
                  .get(target_spk, []) if sd_result and overlap_map and target_spk else [])
        seen["clip_starts"] = sorted(int(s * sr) for s, _ in ranges)
        return assemble(audio, sr, sd_result, overlap_map, target_spk, *a, **k)

    def parsing(asr_result, target_spk, *a, **k):
        pieces = []
        for r in asr_result or []:
            if r["speaker"] != target_spk or r.get("audio") is None:
                continue
            lo, hi = int(r["timerange"][0] * SR), int(r["timerange"][1] * SR)
            # a timerange is rounded to 1 ms: its clip starts at most 1 ms after it
            starts = [c for c in seen["clip_starts"] if c <= lo + SR // 1000]
            first = max(starts) if r["type"] == "overlap" and starts else lo
            pieces.append((r["type"], lo, hi, np.asarray(r["audio"], np.float32), first))
        seen["pieces"] = pieces
        return parse(asr_result, target_spk, *a, **k)

    td.sd_result_to_asr_audio, td.asr_audio_parser = assembling, parsing
    return seen


def piece_agreement(got: list, want: list, min_s: float = 0.05) -> dict:
    """The target's audio entry by entry, over the entries of at least
    `min_s` (`short` counts the others). Entries of one type pair one to
    one, the pairs sharing the most time first (one speaker's overlap
    clips can overlap each other), and only where they share at least
    `min_s`; each pair's SI-SDR is taken on the samples both timeranges
    and both audios cover. The entries of either run in no pair are
    decisions that differ."""
    short = [sum(e[2] - e[1] < min_s * SR for e in run) for run in (got, want)]
    got, want = ([e for e in run if e[2] - e[1] >= min_s * SR] for run in (got, want))
    shared = []
    for i, (tg, lo_g, hi_g, ag, fg) in enumerate(got):
        for j, (tw, lo_w, hi_w, aw, fw) in enumerate(want):
            lo = max(lo_g, lo_w, fg, fw)
            hi = min(hi_g, hi_w, fg + len(ag), fw + len(aw))
            if tg == tw and hi - lo >= min_s * SR:
                shared.append((hi - lo, i, j, lo, hi))
    pairs, paired_g, paired_w = [], set(), set()
    for _, i, j, lo, hi in sorted(shared, reverse=True):
        if i in paired_g or j in paired_w:
            continue
        (tg, _, _, ag, fg), (_, _, _, aw, fw) = got[i], want[j]
        pairs.append({"type": tg, "s": [lo / SR, hi / SR],
                      "si_sdr_db": si_sdr(ag[lo - fg: hi - fg], aw[lo - fw: hi - fw])})
        paired_g.add(i)
        paired_w.add(j)
    return {"entries": [len(got), len(want)], "short": short, "pairs": len(pairs),
            "min_si_sdr_db": min((p["si_sdr_db"] for p in pairs), default=None),
            "unpaired": [[(e[0], e[1] / SR, e[2] / SR) for i, e in enumerate(got)
                          if i not in paired_g],
                         [(e[0], e[1] / SR, e[2] / SR) for j, e in enumerate(want)
                          if j not in paired_w]],
            "pairs_detail": pairs}


def min_at_least(value, floor: float) -> bool:
    """A floor on a smallest value that is None where there was none."""
    return value is None or value >= floor


def separation_outputs(td, clips: list) -> tuple[list, list]:
    """What `multi_speakers_separate_batch` scores for `clips`, in its own
    branch: each clip's two streams (restored) and their embeddings, from
    `FusedSeparation` (at most 4 clips of 10 s) or from the separator's
    batch, the speaker engine's batch and the restorer per stream."""
    fused = td.tasr._fused_separation().separate_score(clips, sr=SR)
    if fused is not None:
        return [r["streams"] for r in fused], [np.asarray(r["embs"]) for r in fused]
    pairs = td.ap.separator.separate_batch(clips, sr=SR)
    embs = np.asarray(td.tasr.spk.embed_batch([s for p in pairs for s in p[:2]], sr=SR))
    return ([[td.ap.restore_audio(s, SR) for s in p[:2]] for p in pairs],
            [embs[2 * i: 2 * i + 2] for i in range(len(pairs))])


def stream_agreement(got: tuple, want: tuple) -> dict:
    """Clip by clip, the two streams' SI-SDR in the better pairing (the
    smaller of the two) and the embeddings' smallest cosine."""
    return {"min_stream_si_sdr_db": [
                max(min(si_sdr(g[i], w[j]) for i, j in perm)
                    for perm in (((0, 0), (1, 1)), ((0, 1), (1, 0))))
                for g, w in zip(got[0], want[0])],
            "min_emb_cos": [float(cosines(g, w).min()) for g, w in zip(got[1], want[1])]}


def infer_summary(out, pieces: list) -> dict:
    spk, results, audio = out
    return {"target_spk": spk, "speakers": sorted({r["speaker"] for r in results}),
            "entries": [(r["speaker"], r["type"], r["timerange"], r["text"]) for r in results],
            "target_audio": audio, "pieces": pieces}


def infer_agreement(got: dict, want: dict) -> dict:
    """How far one infer result is from another: same target and speaker
    set, entry by entry the largest timerange gap and the texts, the
    target audio's SI-SDR over the shorter length and entry by entry
    (`piece_agreement`), and the CER."""
    ga, wa = got["target_audio"], want["target_audio"]
    n = min(len(ga), len(wa)) if ga is not None and wa is not None else 0
    same_entries = len(got["entries"]) == len(want["entries"]) and all(
        g[0] == w[0] and g[1] == w[1] for g, w in zip(got["entries"], want["entries"]))
    gap = max((abs(a - b) for g, w in zip(got["entries"], want["entries"])
               for a, b in zip(g[2], w[2])), default=0.0) if same_entries else None
    text_g = "".join(strip_punct(e[3]) for e in got["entries"])
    text_w = "".join(strip_punct(e[3]) for e in want["entries"])
    return {"target_spk_equal": got["target_spk"] == want["target_spk"],
            "speakers_equal": got["speakers"] == want["speakers"],
            "entries": [len(got["entries"]), len(want["entries"])],
            "entries_equal": same_entries, "timerange_max_gap_s": gap,
            "texts_equal": same_entries and all(g[3] == w[3] for g, w in
                                                zip(got["entries"], want["entries"])),
            "cer": cer(text_w, text_g),
            "target_audio_len": [None if ga is None else len(ga), None if wa is None else len(wa)],
            # the single-speaker mode has no target: both tracks are silence
            "target_audio_equal": ga is not None and wa is not None and np.array_equal(ga, wa),
            "target_audio_si_sdr_db": si_sdr(ga[:n], wa[:n]) if n and wa[:n].any() else None,
            "target_entries": piece_agreement(got["pieces"], want["pieces"])}


def check_infer() -> tuple[dict, dict]:
    import torch

    calls, enroll = infer_inputs()
    t = time.time()
    td = load_system()
    dtypes = {"separator": str(td.ap.separator.compute_dtype),
              "restorer_params": sorted({str(p.dtype) for p in td.ap.restorer.model.parameters()}),
              "paraformer": str(td.tasr.asrp.asr.compute_dtype)}
    emit("infer_load", load_s=time.time() - t, **dtypes,
         checkpoints={k: os.path.relpath(v, ROOT) for k, v in INFER_CHECKPOINTS.items()},
         separator_checkpoint=os.path.relpath(CHECKPOINT, ROOT),
         calls={k: len(a) / SR for k, (a, _) in calls.items()}, enrollment_s=len(enroll) / SR)
    if dtypes != {"separator": "torch.bfloat16", "restorer_params": ["torch.float32"],
                  "paraformer": "torch.bfloat16"}:
        raise AssertionError(f"the system is not in the card's types: {dtypes}")
    counter = PathCounter(td)
    per, layers = counter.per_forward, len(td.ap.separator.model.mask_net.layers)
    if per["separator"] != 2 * layers or per["apollo"] != 12 or per["vad"] != 4:
        raise AssertionError(f"dwconv convs per forward {per}, want {2 * layers}, 12 and 4")
    main, totals = {}, {k: 0 for k in read_launches()}
    separated, current = {}, [None]  # the clips each call sent to the separator
    separate = td.tasr.multi_speakers_separate_batch
    td.tasr.multi_speakers_separate_batch = \
        lambda clips, *a, **k: separated.__setitem__(current[0], clips) or separate(clips, *a, **k)
    seen = record_target_pieces(td)
    apollo_shapes = set()
    for name, (audio, kw) in calls.items():
        current[0] = name
        td.infer(audio, enroll, **kw)  # warm-up: the rungs' cuDNN, cuFFT and cuBLAS set-up
        counter.start()
        out, wall = timed(lambda: td.infer(audio, enroll, **kw))
        launches = counter.stop()
        fw = counter.forwards
        apollo_shapes |= counter.apollo_shapes
        emit("infer_call", path="bf16 kernels", call=name, audio_s=len(audio) / SR, wall_s=wall,
             rtfx=len(audio) / SR / wall, target_spk=out[0], entries=len(out[1]),
             types=sorted({r["type"] for r in out[1]}), forwards=fw, launches=launches,
             apollo_dw_shapes=sorted(counter.apollo_shapes), spans=counter.spans)
        want = {"ffconvm": 5 * layers * fw["separator"], "flash_gated": layers * fw["separator"],
                "flash_group": 0, "dwconv": sum(per[k] * fw[k] for k in fw)}
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, want {want} from "
                                 f"forwards {fw}")
        fused_sep = counter.spans.get("infer/asr_assembly/fused/separate", {})
        # one pass: the separator's convs, Apollo's and the streams' VAD
        if name.startswith("a") and not (
                fused_sep.get("ffconvm") == 5 * layers * fused_sep.get("calls", 0) > 0
                and fused_sep.get("dwconv") == (per["separator"] + per["apollo"] + per["vad"])
                * fused_sep["calls"]):
            raise AssertionError(f"{name}: no FusedSeparation with Apollo in its pass: "
                                 f"{counter.spans}")
        if name.startswith("b") and not (counter.spans.get("infer/asr_assembly/fused/asr", {})
                                         .get("dwconv", 0) >= per["paraformer"]):
            raise AssertionError(f"{name}: did not go through FusedASR: {counter.spans}")
        if not out[1] or out[2] is None or not np.isfinite(out[2]).all() or any(
                set(r) != {"speaker", "timerange", "text", "type", "score"} for r in out[1]):
            raise AssertionError(f"{name}: bad result {out[:2]}")
        main[name] = infer_summary(out, seen["pieces"]) | {"separated": fw["separator"] > 0}
        for k in totals:
            totals[k] += launches[k]
    del td.tasr.multi_speakers_separate_batch
    if not apollo_shapes <= APOLLO_DW_SHAPES:
        raise AssertionError(f"Apollo's depthwise convs ran at {sorted(apollo_shapes)}; "
                             f"check_dwconv holds {sorted(APOLLO_DW_SHAPES)}")
    name_a = "a: overlapped dialogue 20 s"
    audio_a, kw_a = calls[name_a]
    reset_launches()
    trace = profile_call(lambda: td.infer(audio_a, enroll, **kw_a),
                         "TargetDiarization.infer, call a", top=12, spans=True)
    profiled = read_launches()
    traced = trace_launches(trace["device"])
    emit("device_profile", call=name_a, launches=profiled, trace_launches=traced,
         fused_separate_ranges=trace["ranges"]["fused/separate"])
    # this slice's card path: infer (a) under device_profile runs FFConvM,
    # gated FLASH and dwconv, and its trace holds each launch and the span
    path_kernels = ("ffconvm", "flash_gated", "dwconv")
    if traced != profiled or not all(profiled[k] > 0 for k in path_kernels) \
            or trace["ranges"]["fused/separate"] < 1:
        raise AssertionError(f"{name_a} under device_profile: counted {profiled}, in the trace "
                             f"{traced}, fused/separate ranges {trace['ranges']['fused/separate']}")
    # the clips each call separated, through the bf16 card path's own branch
    sep_bf16 = {name: separation_outputs(td, clips) for name, clips in separated.items()}

    # float32: the kernel path against the plain path; bf16 against float32 plain
    del td
    td32 = load_system("float32")
    for name, clips in separated.items():
        sep_k32 = separation_outputs(td32, clips)
        with plain_kernels():
            sep_plain = separation_outputs(td32, clips)
        f32, bf16 = stream_agreement(sep_k32, sep_plain), stream_agreement(sep_bf16[name],
                                                                            sep_plain)
        emit("infer_separation_agreement", call=name, clips_s=[len(c) / SR for c in clips],
             f32_kernels_vs_f32_plain=f32, bf16_kernels_vs_f32_plain=bf16)
        if min(f32["min_stream_si_sdr_db"]) < 40.0 or min(f32["min_emb_cos"]) < 0.9999 \
                or min(bf16["min_stream_si_sdr_db"]) < 10.0:
            raise AssertionError(f"{name}: the separated clips against float32 plain: "
                                 f"{f32}, {bf16}")
    seen = record_target_pieces(td32)
    for name, (audio, kw) in calls.items():
        kern = infer_summary(td32.infer(audio, enroll, **kw), seen["pieces"])
        with plain_kernels():
            plain = infer_summary(td32.infer(audio, enroll, **kw), seen["pieces"])
        f32, bf16 = infer_agreement(kern, plain), infer_agreement(main[name], plain)
        extra = {} if bf16["entries_equal"] else {
            "bf16_entries": [e[:3] for e in main[name]["entries"]],
            "f32_plain_entries": [e[:3] for e in plain["entries"]]}
        emit("infer_agreement", call=name, f32_kernels_vs_f32_plain=f32,
             bf16_kernels_vs_f32_plain=bf16, **extra)
        # where the separator ran, its streams agree to float32 rounding, which
        # moves a few int16 samples by one step and can flip an argmax of the
        # bootstrap Paraformer: the texts are held to a CER, else equal
        texts_ok = f32["cer"] <= 0.03 if main[name]["separated"] else f32["texts_equal"]
        if not (f32["target_spk_equal"] and f32["speakers_equal"] and texts_ok
                and f32["entries_equal"] and f32["timerange_max_gap_s"] <= 0.01
                and (f32["target_audio_equal"] or (f32["target_audio_si_sdr_db"] or 0.0) >= 40.0)
                and f32["target_entries"]["unpaired"] == [[], []]
                and min_at_least(f32["target_entries"]["min_si_sdr_db"], 40.0)):
            raise AssertionError(f"{name}: float32 kernel path vs float32 plain path: {f32}")
        # bf16 may take another decision: an overlap clip whose streams both
        # score near cosine 0 kept or dropped, a VAD boundary some frames
        # away. Either shifts the rest of the target track, so its audio is
        # held entry by entry on the samples that both runs' entries cover;
        # every call with a target has such entries
        pieces = bf16["target_entries"]
        if not (bf16["target_spk_equal"] and bf16["speakers_equal"] and (
                not plain["target_spk"] or pieces["pairs"] > 0)
                and min_at_least(pieces["min_si_sdr_db"], 10.0)):
            raise AssertionError(f"{name}: bf16 card path vs float32 plain path: {bf16}")
    torch.cuda.synchronize()
    return totals, profiled


# ---------------- the slice: TargetDiarizationStream.infer_stream ----------------

STREAM_SEEDS = (13, 14, 15, 16)  # s1 is the first; s4 runs all four at once
PROFILE_STREAM_S = 6.0  # the profiled synchronous session's length


def load_stream(compute_dtype: str | None = None, device: str = "cuda"):
    """The server's model (`serve/server.py::build_model`) on `device`, in
    the card's types unless `compute_dtype`."""
    from unittest import mock

    from targetdiarization_tpu_torch.serve.server import build_model

    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": compute_dtype} if compute_dtype
                         else {}):
        return build_model(device=device)


def record_session(model) -> dict:
    """Wraps `model.asr_audio_streaming` and the analyzer's `analyze_chunk`
    (until `unrecord`): "flushes" holds each flush's (start s, seconds,
    whether the overlap check fired), in order (a session's flushes run in
    order on one worker), and "decisions" each chunk decision's (buffer
    seconds, speaker cosine)."""
    rec = {"flushes": [], "decisions": []}
    run, analyze = model.asr_audio_streaming, model._stream_analyzer.analyze_chunk

    def recording(audio, is_overlap, state, *a, **k):
        rec["flushes"].append((round(state.current_time, 3), round(len(audio) / SR, 3),
                               bool(is_overlap)))
        return run(audio, is_overlap, state, *a, **k)

    def analyzing(combined, chunk):
        out = analyze(combined, chunk)
        rec["decisions"].append((round(len(combined) / SR, 3), out["similarity"]))
        return out

    model.asr_audio_streaming = recording
    model._stream_analyzer.analyze_chunk = analyzing
    return rec


def unrecord(model) -> None:
    del model.asr_audio_streaming
    del model._stream_analyzer.analyze_chunk


def cosine_moves(got: list, want: list) -> dict:
    """The speaker cosines of two runs' decisions, where their buffers are
    the same length in the same order (until the first that is not)."""
    n = 0
    while n < min(len(got), len(want)) and got[n][0] == want[n][0]:
        n += 1
    diffs = [abs(g[1] - w[1]) for g, w in zip(got[:n], want[:n])]
    return {"decisions": [len(got), len(want)], "aligned": n,
            "cos_max_abs_diff": max(diffs, default=None)}


def stream_session(model, audio: np.ndarray, enroll: np.ndarray, pace: float = 0.0,
                   t_start: float | None = None) -> dict:
    """One `infer_stream` session: `audio` as 1 s int16 chunks, the k-th fed
    at t_start + k * pace (unpaced with pace 0), with `enroll` as the
    target. Intake is how long the pipeline holds each chunk before it
    asks for the next; emission is the pipeline's own `emission_s`."""
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)
    intake, metrics = [], {}

    def chunks():
        t0 = t_start if t_start is not None else time.perf_counter()
        for k, s in enumerate(range(0, len(pcm), SR)):
            if pace:
                time.sleep(max(0.0, t0 + k * pace - time.perf_counter()))
            t = time.perf_counter()
            yield pcm[s: s + SR]
            intake.append(time.perf_counter() - t)

    t = time.perf_counter()
    results = [r for _, res, _ in model.infer_stream(chunks(), target_file=enroll,
                                                      metrics=metrics) for r in res]
    wall = time.perf_counter() - t
    for r in results:
        if set(r) != {"speaker", "timerange", "text", "type"} or r["speaker"] not in ("0", "1") \
                or r["type"] not in ("single", "overlap") or not r["text"] \
                or not r["timerange"][0] <= r["timerange"][1] <= len(audio) / SR + 1e-6:
            raise AssertionError(f"infer_stream: bad result {r}")
    return {"results": [(r["speaker"], r["type"], r["timerange"], r["text"]) for r in results],
            "wall_s": wall, "intake_s": intake, "emission_s": metrics.get("emission_s", [])}


def pct_ms(values: list, q: float) -> float | None:
    return float(np.percentile(np.asarray(values) * 1e3, q)) if values else None


def session_summary(run: dict, audio_s: float, flushes: list) -> dict:
    return {"audio_s": audio_s, "wall_s": run["wall_s"], "rtfx": audio_s / run["wall_s"],
            "intake_ms_p50": pct_ms(run["intake_s"], 50), "intake_ms_p99": pct_ms(run["intake_s"], 99),
            "emission_ms_p50": pct_ms(run["emission_s"], 50),
            "emission_ms_p99": pct_ms(run["emission_s"], 99),
            "chunks": len(run["intake_s"]), "flushes": len(flushes),
            "overlap_flushes": sum(f[2] for f in flushes), "segments": len(run["results"])}


def session_agreement(got: dict, want: dict, got_flushes: list, want_flushes: list) -> dict:
    """One session against another: the same flushes (start, length,
    overlap check), the same results' speakers and types, the largest
    timerange gap, and the CER of all texts joined (every flush goes
    through the separator in stream mode)."""
    g, w = got["results"], want["results"]
    same = len(g) == len(w) and all(a[:2] == b[:2] for a, b in zip(g, w))
    gap = max((abs(x - y) for a, b in zip(g, w) for x, y in zip(a[2], b[2])),
              default=0.0) if same else None
    text_g = "".join(strip_punct(r[3]) for r in g)
    text_w = "".join(strip_punct(r[3]) for r in w)
    return {"flushes_equal": got_flushes == want_flushes,
            "flushes": [len(got_flushes), len(want_flushes)],
            "results": [len(g), len(w)], "speakers_types_equal": same,
            "timerange_max_gap_s": gap, "texts_equal": [r[3] for r in g] == [r[3] for r in w],
            "cer": cer(text_w, text_g)}


def within_s1_limits(a: dict) -> bool:
    """s1's limits: the same flushes, speakers and types, timeranges within
    10 ms, CER <= 0.03 (a stream difference of one int16 step can flip an
    argmax of the bootstrap Paraformer; the limit of `check_infer`)."""
    return (a["flushes_equal"] and a["speakers_types_equal"] and a["results"][0] > 0
            and a["timerange_max_gap_s"] <= 0.01 and a["cer"] <= 0.03)


def mb_stats(model) -> dict:
    """The MicroBatchers' counts: the analyzer's, the ASR's, the separator's."""
    return {name: eng._mb.stats() for name, eng in (
        ("stream_chunk", model._stream_analyzer), ("asr", model.tasr.asrp.asr),
        ("separator", model.ap.separator)) if eng._mb is not None}


def mb_delta(after: dict, before: dict) -> dict:
    out = {}
    for name, a in after.items():
        b = before.get(name, {"batches": 0, "items": 0, "sizes": {}})
        sizes = {k: v - b["sizes"].get(k, 0) for k, v in a["sizes"].items()
                 if v - b["sizes"].get(k, 0)}
        out[name] = {"dispatches": a["batches"] - b["batches"], "items": a["items"] - b["items"],
                     "coalesced_dispatches": sum(v for k, v in sizes.items() if k > 1),
                     "items_per_dispatch": sizes}
    return out


def concurrent_sessions(model, inputs: list, enroll: np.ndarray) -> tuple[list, list, float]:
    """The sessions of `inputs` in threads at once, each paced at real
    time from one start; (runs, flushes per session, wall seconds)."""
    import threading

    runs, flushes, errors = [None] * len(inputs), [[] for _ in inputs], []
    run = model.asr_audio_streaming
    owner = threading.local()

    def recording(audio, is_overlap, state, *a, **k):
        flushes[state.session].append((round(state.current_time, 3), round(len(audio) / SR, 3),
                                       bool(is_overlap)))
        return run(audio, is_overlap, state, *a, **k)

    model.asr_audio_streaming = recording
    t_start = time.perf_counter() + 0.5

    def one(i):
        owner.i = i
        try:
            runs[i] = stream_session(model, inputs[i], enroll, pace=1.0, t_start=t_start)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    from targetdiarization_tpu_torch.pipeline import streaming

    state_init = streaming.StreamState.__init__

    def tagged(self, *a, **k):  # each session's state knows its session
        state_init(self, *a, **k)
        self.session = getattr(owner, "i", 0)

    streaming.StreamState.__init__ = tagged
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(inputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        streaming.StreamState.__init__ = state_init
        del model.asr_audio_streaming
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a concurrent session did not finish in 600 s")
    return runs, flushes, time.perf_counter() - t_start


def check_stream(seconds: float = 20.0, device: str = "cuda") -> dict:
    import torch

    audio = dialogue(seconds, seed=STREAM_SEEDS[0], overlap=True)
    enroll = enrollment(8.0, seed=9)
    audio_s = len(audio) / SR
    t = time.time()
    model = load_stream(device=device)
    load_s = time.time() - t
    sep = model.ap.separator
    layers = len(sep.model.mask_net.layers)
    dtypes = {"separator": str(sep.compute_dtype), "paraformer": str(model.tasr.asrp.asr.compute_dtype),
              "vad": str(model.tasr.asrp.vad.compute_dtype)}
    emit("stream_load", load_s=load_s, separator_layers=layers,
         separator_width=sep.model.mask_net.in_norm.weight.shape[0], **dtypes,
         async_flush=model.async_flush, max_inflight=model.max_inflight_flushes,
         microbatch=model._stream_analyzer._mb is not None)
    if device == "cuda" and (layers != 24 or dtypes["separator"] != "torch.bfloat16"
                             or not model.async_flush):
        raise AssertionError(f"build_model did not give the 512/24 bf16 async system: {dtypes}")
    t = time.time()
    passes = model.prewarm_streaming(max_sessions=4)
    torch.cuda.synchronize()
    emit("stream_prewarm", max_sessions=4, passes=passes, prewarm_s=time.time() - t)

    # s1, the main path: one session, async flushes, unpaced
    counter = PathCounter(model)
    per = counter.per_forward
    rec = record_session(model)
    reset_launches()
    s1 = stream_session(model, audio, enroll)
    s1_launches = read_launches()
    s1_flushes, s1_decisions = list(rec["flushes"]), list(rec["decisions"])
    emit("stream_s1", path="bf16 kernels, async flushes",
         **session_summary(s1, audio_s, s1_flushes), launches=s1_launches,
         flush_list=s1_flushes, results=s1["results"])
    if not s1["results"] or not any(f[2] for f in s1_flushes) or any(
            s1_launches[k] == 0 for k in ("ffconvm", "flash_gated", "dwconv")):
        raise AssertionError(f"s1: no result, no overlap flush or a kernel never launched: "
                             f"{s1_launches}, {s1_flushes}")

    # the same session with synchronous flushes: the same results; its
    # launches by span against those its models' forwards imply
    rec["flushes"].clear()
    model.async_flush = False
    counter.start()
    s1_sync = stream_session(model, audio, enroll)
    launches = counter.stop()
    fw, spans = counter.forwards, counter.spans
    sync_flushes = list(rec["flushes"])
    agree = session_agreement(s1_sync, s1, sync_flushes, s1_flushes)

    def span_sum(suffix):
        rows = [r for name, r in spans.items() if name.endswith(suffix)]
        return {k: sum(r[k] for r in rows) for k in ("calls", *launches)}

    chunk_span, sep_span = span_sum("fused/stream_chunk"), span_sum("audio/separate_dispatch")
    rest_span, vad_span = span_sum("audio/restore_audio"), span_sum("asr/vad_detection")
    asr_span = span_sum("asr/asr_detection")
    want = {"ffconvm": 5 * layers * fw["separator"], "flash_gated": layers * fw["separator"],
            "flash_group": 0, "dwconv": sum(per[k] * fw[k] for k in fw)}
    flush_launches = {k: launches[k] - chunk_span[k] for k in launches}
    emit("stream_launches", path="bf16 kernels, sync flushes", forwards=fw, per_forward=per,
         launches=launches, spans=spans, decisions=chunk_span["calls"],
         flushes=len(sync_flushes),
         per_decision={k: chunk_span[k] / max(chunk_span["calls"], 1) for k in launches},
         per_flush={k: flush_launches[k] / max(len(sync_flushes), 1) for k in launches},
         apollo_dw_shapes=sorted(counter.apollo_shapes), sync_vs_async=agree,
         sync_session=session_summary(s1_sync, audio_s, sync_flushes))
    if launches != want:
        raise AssertionError(f"stream: kernel launches {launches}, want {want} from {fw}")
    checks = {
        "stream_chunk: 8 dwconv a decision": chunk_span["dwconv"] == 8 * chunk_span["calls"] > 0
        and chunk_span["ffconvm"] == 0,
        "separator: 120/24/48 a forward": sep_span["calls"] == fw["separator"] > 0
        and (sep_span["ffconvm"], sep_span["flash_gated"], sep_span["dwconv"])
        == (5 * layers * sep_span["calls"], layers * sep_span["calls"], 2 * layers * sep_span["calls"]),
        "Apollo: 12 dwconv a forward": rest_span["dwconv"] == per["apollo"] * fw["apollo"] > 0,
        "VAD: 4 dwconv a forward": vad_span["dwconv"] == per["vad"] * vad_span["calls"] > 0,
        "Paraformer: 12 dwconv a forward": asr_span["dwconv"] == per["paraformer"] * fw["paraformer"] > 0,
        "per-forward counts": (per["separator"], per["apollo"], per["vad"], per["paraformer"])
        == (2 * layers, 12, 4, 12),
    }
    if not all(checks.values()):
        raise AssertionError(f"stream launches by span: {checks}, {spans}")
    if not counter.apollo_shapes <= APOLLO_DW_SHAPES:
        raise AssertionError(f"Apollo's convs ran at {sorted(counter.apollo_shapes)}; "
                             f"check_dwconv holds {sorted(APOLLO_DW_SHAPES)}")
    if not within_s1_limits(agree):
        raise AssertionError(f"s1: the synchronous session against the async one: {agree}")
    # profiled: s1's first PROFILE_STREAM_S seconds (the profiler's own work
    # after the call grows with the session: 86-91 s for the whole 20 s)
    profile_call(lambda: stream_session(model, audio[: int(PROFILE_STREAM_S * SR)], enroll),
                 f"TargetDiarizationStream.infer_stream, s1 sync, first {PROFILE_STREAM_S:g} s",
                 top=12, spans=True)
    model.async_flush = True
    unrecord(model)

    # s4 on the main path: four sessions at once, paced at real time (one
    # repetition, async flushes, so the whole run keeps inside 450 s)
    inputs = [audio] + [dialogue(seconds, seed=s, overlap=True) for s in STREAM_SEEDS[1:]]
    before = mb_stats(model)
    runs, _, wall = concurrent_sessions(model, inputs, enroll)
    emit("stream_s4", path="bf16 kernels, async flushes, 4 sessions paced at real time",
         wall_s=wall, microbatch=mb_delta(mb_stats(model), before),
         intake_ms_p50=pct_ms([x for r in runs for x in r["intake_s"]], 50),
         intake_ms_p99=pct_ms([x for r in runs for x in r["intake_s"]], 99),
         emission_ms_p50=pct_ms([x for r in runs for x in r["emission_s"]], 50),
         emission_ms_p99=pct_ms([x for r in runs for x in r["emission_s"]], 99),
         segments=[len(r["results"]) for r in runs])
    bf16_s1 = s1
    del model, counter

    # float32: kernels against plain on s1; s4 against each session alone
    model32 = load_stream("float32", device=device)
    rec = record_session(model32)
    alone, alone_flushes = [], []
    for x in inputs:
        rec["flushes"].clear()
        rec["decisions"].clear()
        alone.append(stream_session(model32, x, enroll))
        alone_flushes.append(list(rec["flushes"]))
    rec["flushes"].clear()
    rec["decisions"].clear()
    with plain_kernels():
        plain = stream_session(model32, audio, enroll)
    plain_flushes, plain_decisions = list(rec["flushes"]), list(rec["decisions"])
    f32 = session_agreement(alone[0], plain, alone_flushes[0], plain_flushes)
    bf16 = session_agreement(bf16_s1, plain, s1_flushes, plain_flushes)
    emit("stream_agreement", f32_kernels_vs_f32_plain=f32, bf16_kernels_vs_f32_plain=bf16,
         bf16_r5_cosines=cosine_moves(s1_decisions, plain_decisions),
         bf16_flushes=s1_flushes, f32_plain_flushes=plain_flushes,
         bf16_results=bf16_s1["results"], f32_plain_results=plain["results"])
    if not within_s1_limits(f32):
        raise AssertionError(f"s1: float32 kernels vs float32 plain: {f32}")
    # bf16 moves the analyzer's speech probabilities and cosines, so flush
    # boundaries (and every later buffer) may move; a broken path shows as
    # no results, a flush count off by a factor of 2, or texts unrelated
    # to the float32 ones (a CER near 1)
    if not (bf16["results"][0] > 0 and 0.5 <= bf16["flushes"][0] / bf16["flushes"][1] <= 2.0
            and bf16["cer"] <= 0.6):
        raise AssertionError(f"s1: bf16 kernels vs float32 plain: {bf16}")
    unrecord(model32)
    before = mb_stats(model32)
    runs, flushes4, wall = concurrent_sessions(model32, inputs, enroll)
    together = [session_agreement(r, a, f, af) for r, a, f, af in
                zip(runs, alone, flushes4, alone_flushes)]
    emit("stream_s4_f32", path="float32 kernels, 4 sessions paced at real time", wall_s=wall,
         microbatch=mb_delta(mb_stats(model32), before), vs_alone=together,
         intake_ms_p50=pct_ms([x for r in runs for x in r["intake_s"]], 50),
         intake_ms_p99=pct_ms([x for r in runs for x in r["intake_s"]], 99),
         emission_ms_p50=pct_ms([x for r in runs for x in r["emission_s"]], 50),
         emission_ms_p99=pct_ms([x for r in runs for x in r["emission_s"]], 99))
    if not all(within_s1_limits(a) for a in together):
        raise AssertionError(f"s4: a session with three others against it alone: {together}")
    coalesced = mb_delta(mb_stats(model32), before)
    if not any(v["coalesced_dispatches"] for v in coalesced.values()):
        raise AssertionError(f"s4: the MicroBatchers coalesced nothing: {coalesced}")
    torch.cuda.synchronize()
    return s1_launches


# ---------------- the surface: build_model's enhancer and emotion engine, forced alignment ----------------


SURFACE_CHECKPOINTS = {name: os.path.join(ROOT, "checkpoints", f"{name}-bootstrap")
                       for name in ("enh", "emo")}
# emotion in bf16 against float32: the most a probability may move, and the
# float32 lead of the top class under which the argmax counts as a tie
EMO_TIE = 0.1


def enhancer_flops(enhancer, n: int) -> float:
    """Multiply-add work (2 flops each) of one FlowEnhancer forward on an
    n-sample piece, counted on this run's shapes by hooks on its
    convolutions; a transposed conv at its non-zero work (each input pixel
    times the kernel), as the stride-dilated zeros cost nothing."""
    import torch

    from targetdiarization_tpu_torch.models.enhancement import HOP, N_FFT
    from targetdiarization_tpu_torch.ops.conv import ConvTranspose2d

    total = [0.0]

    def count(mod, args, out):
        kh, kw = mod.kernel_size
        pix = args[0].shape[-2] * args[0].shape[-1] if isinstance(mod, ConvTranspose2d) \
            else out.shape[-2] * out.shape[-1]
        total[0] += 2.0 * mod.in_channels * mod.out_channels * kh * kw * pix * out.shape[0]

    model = enhancer.model
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    frames = n // HOP + 1
    with torch.inference_mode():
        z = torch.zeros(1, frames, N_FFT // 2 + 1, device=enhancer.device)
        model(z, torch.zeros(1, device=enhancer.device), z)
    for h in hooks:
        h.remove()
    return total[0]


def check_surface(device: str = "cuda") -> dict:
    """`build_model()`'s enhancer and emotion engine, and the ASR stage's
    forced alignment and VAD helpers, on the card: the enhancer timed on a
    10 s clip at quality 2 (nfe 64), nfe 1 and nfe 128 against its float32
    FMA bound, and held at tau 0 against its own CPU run; emotion in bf16
    against float32 (the same argmax where float32's top class leads by more
    than EMO_TIE); timestamp_prediction, get_speech_timestamps and
    is_speech with their dwconv launches counted per forward and held
    against the plain kernels."""
    import torch

    from targetdiarization_tpu_torch.models.emotion import EmotionEngine
    from targetdiarization_tpu_torch.models.enhancement import EnhancerEngine

    t = time.time()
    model = load_stream(device=device)
    ap, asrp = model.ap, model.tasr.asrp
    emit("surface_load", load_s=time.time() - t, quality=ap.quality,
         enhancer=type(ap.enhancer).__name__, emotion=type(asrp.emotion).__name__,
         emotion_dtype=str(getattr(asrp.emotion, "compute_dtype", None)))
    if not (isinstance(ap.enhancer, EnhancerEngine) and isinstance(asrp.emotion, EmotionEngine)
            and ap.enhancer.device.type == device and ap.quality == 2):
        raise AssertionError("build_model did not load the enhancer and the emotion engine "
                             f"on {device} at quality 2")

    # the enhancer: one 10 s piece (the top bucket), warmed at that shape
    clip = conversation(10.0, seed=31)
    clip = clip + (0.01 * np.random.default_rng(31).standard_normal(len(clip))).astype(np.float32)
    flops = enhancer_flops(ap.enhancer, len(clip))
    ap.enhance_audio(clip, SR, nfe=1)
    timings = {}
    for label, nfe in (("quality 2", None), ("nfe 1", 1), ("nfe 128", 128)):
        steps = nfe or 64
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = ap.enhance_audio(clip, SR, nfe=nfe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if out.shape != clip.shape or not np.isfinite(out).all():
            raise AssertionError(f"enhance_audio {label}: shape {out.shape} or non-finite output")
        timings[label] = {"nfe": steps, "forwards": 2 * steps, "wall_s": wall,
                          "ms_per_forward": wall / (2 * steps) * 1e3,
                          "fma_bound_s": 2 * steps * flops / PEAK_FLOPS["float32"]}
    emit("surface_enhance", clip_s=len(clip) / SR, gflop_per_forward=flops / 1e9, **timings)
    profile_call(lambda: ap.enhance_audio(clip, SR, nfe=4), "enhance_audio 10 s, nfe 4", top=12)

    # the card's enhance against the port's own CPU run: tau 0 takes the
    # prior noise out, nfe 2, 1 s
    one = clip[:SR]
    got = ap.enhancer.enhance(one, nfe=2, tau=0.0)
    cpu = EnhancerEngine.from_pretrained(SURFACE_CHECKPOINTS["enh"], device="cpu").enhance(one, nfe=2, tau=0.0)
    sdr = si_sdr(got, cpu)
    emit("surface_enhance_vs_cpu", si_sdr_db=sdr, max_abs_err=float(np.abs(got - cpu).max()))
    if not sdr >= 40.0:
        raise AssertionError(f"enhance on the card vs the CPU: {sdr:.1f} dB < 40 dB")

    # emotion: the bf16 engine against a float32 one on the card
    emo32 = EmotionEngine.from_pretrained(SURFACE_CHECKPOINTS["emo"], device=device,
                                          compute_dtype="float32")
    data = asr_inputs()
    clips = {"0.5 s": data["utts"][0][: SR // 2], **{f"{len(u) / SR:.2f} s": u
                                                     for u in data["utts"]},
             "12 s": data["long"][: 12 * SR]}
    asrp.emotion_detection(clips["12 s"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    asrp.emotion_detection(clips["12 s"])
    torch.cuda.synchronize()
    emo_ms = (time.perf_counter() - t) * 1e3
    rows = {}
    for name, c in clips.items():
        from targetdiarization_tpu_torch.models.emotion import _SAMPLE_LADDER
        from targetdiarization_tpu_torch.models.features import num_frames

        padded = np.pad(c, (0, _SAMPLE_LADDER.bucket(len(c)) - len(c)))[None]
        pb, pf = asrp.emotion.probs(padded, [num_frames(len(c))])[0], \
            emo32.probs(padded, [num_frames(len(c))])[0]
        top2 = np.sort(pf)[-2:]
        rows[name] = {"argmax_bf16": int(pb.argmax()), "argmax_f32": int(pf.argmax()),
                      "f32_top2_margin": float(top2[1] - top2[0]),
                      "max_abs_diff": float(np.abs(pb - pf).max())}
    emit("surface_emotion", emotion_detection_12s_ms=emo_ms, clips=rows)
    # one bf16 step of a logit near 20 is 0.125, which moves a probability
    # by a few hundredths: a near tie in float32 may resolve either way
    decisive = [r for r in rows.values() if r["f32_top2_margin"] > EMO_TIE]
    if (len(decisive) < 4 or any(r["argmax_bf16"] != r["argmax_f32"] for r in decisive)
            or any(r["max_abs_diff"] > EMO_TIE for r in rows.values())):
        raise AssertionError(f"emotion: bf16 against float32: {rows}")

    # forced alignment and the VAD helpers, counted
    def run_align():
        ts = [asrp.timestamp_prediction(u, text) for u, text in zip(data["utts"], data["texts"])]
        speech = asrp.vad.get_speech_timestamps(data["long"])
        speech_s = asrp.vad.get_speech_timestamps(data["long"], return_seconds=True)
        flags = [asrp.vad.is_speech(data["long"]), asrp.vad.is_speech(np.zeros(SR, np.float32))]
        return ts, speech, speech_s, flags

    run_align()
    forwards = {"asr": 0, "vad": 0}
    hooks = [asrp.asr.model.register_forward_hook(
                 lambda *_: forwards.__setitem__("asr", forwards["asr"] + 1)),
             asrp.vad.model.register_forward_hook(
                 lambda *_: forwards.__setitem__("vad", forwards["vad"] + 1))]
    reset_launches()
    ts, speech, speech_s, flags = run_align()
    launches = read_launches()
    for h in hooks:
        h.remove()
    with plain_kernels():
        ts_p, speech_p, _, flags_p = run_align()
    branch = ["forced alignment" if len(asrp.asr.force_align(u, len(text))) == len(text)
              else "VAD split" for u, text in zip(data["utts"], data["texts"])]
    emit("surface_align", texts=data["texts"], branch=branch, timestamps=ts,
         speech_segments=len(speech), speech_s=speech_s, is_speech=flags, forwards=forwards,
         launches=launches)
    want = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0,
            "dwconv": 12 * forwards["asr"] + 4 * forwards["vad"]}
    if launches != want or not forwards["asr"] or not forwards["vad"]:
        raise AssertionError(f"surface: launches {launches} with {forwards} forwards, want {want}")
    for u, text, r, rp in zip(data["utts"], data["texts"], ts, ts_p):
        flat = [x for se in r for x in se]
        if len(r) != len(text) or flat != sorted(flat) or flat[0] < 0 \
                or flat[-1] > len(u) / SR * 1000:
            raise AssertionError(f"timestamp_prediction of {text!r}: {r}")
        if len(rp) != len(r) or max(abs(a - b) for a, b in
                                    zip(flat, [x for se in rp for x in se])) > 60:
            raise AssertionError(f"timestamp_prediction kernels vs plain: {r} vs {rp}")
    if flags != [True, False] or flags_p != flags or len(speech_p) != len(speech) or any(
            abs(a[k] - b[k]) > 0.1 * SR for a, b in zip(speech, speech_p) for k in a):
        raise AssertionError(f"VAD helpers: {speech} / {flags} vs plain {speech_p} / {flags_p}")
    torch.cuda.synchronize()
    return launches


# ---------------- the engines: SenseVoice, whisper and CAM++ through build_model ----------------


ENGINE_SETTINGS = {"ASR_ENGINE": "sensevoice",
                   "EMBEDDING_MODEL": os.path.join(ROOT, "checkpoints", "campp-bootstrap")}
WHISPER_TIE = 1e-3  # a CPU top-two margin under which the card may take the other id


def load_engines(compute_dtype: str | None = None, device: str = "cuda"):
    """`build_model()` as a user selects SenseVoice and CAM++: ASR_ENGINE and
    EMBEDDING_MODEL in the environment, in the card's types unless
    `compute_dtype`."""
    from unittest import mock

    from targetdiarization_tpu_torch.serve.server import build_model

    env = dict(ENGINE_SETTINGS, **({"TD_COMPUTE_DTYPE": compute_dtype} if compute_dtype else {}))
    with mock.patch.dict(os.environ, env):
        return build_model(device=device)


def seeded_sensevoice(device: str = "cuda", seed: int = 5):
    """SenseVoice at its class defaults (dim 512, ffn 2048, 50 SAN-M layers,
    vocab 21001: the SenseVoice-Small geometry), its weights drawn on
    `device` from a seeded generator: Linear weights N(0, 1/fan_in), the
    memories' taps N(0, 1/11), LayerNorm scales 1 + N(0, 0.01), biases and
    the tag rows N(0, 0.02^2)."""
    import torch

    from targetdiarization_tpu_torch.models.asr import SenseVoice

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        model = SenseVoice()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("fsmn"):
                p.normal_(0.0, 11 ** -0.5, generator=gen)
            elif p.dim() == 2 and name != "tag_queries":
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif ".ln" in name or name.startswith("encoder.out_ln"):
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1, generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def write_whisper_checkpoint(path: str, seed: int = 3) -> dict:
    """A WhisperStyleASR checkpoint at the class defaults (dim 256, ffn 1024,
    6 + 4 layers, 224 positions) under `path`: seeded numpy float32 weights
    in the JAX package's layout (`params.npz`), `model.json` and
    asr-bootstrap's `vocab.txt`. Returns the torch state dict it holds."""
    import shutil

    import torch

    from targetdiarization_tpu_torch.models.whisper_style import WhisperStyleASR

    rng = np.random.default_rng(seed)
    state, flat = {}, {}
    for name, p in WhisperStyleASR().state_dict().items():
        parts = name.split(".")
        keys = []  # the JAX names: a list entry's index joins its list's name
        for part in parts[:-1]:
            if part.isdigit():
                keys[-1] += f"_{part}"
            else:
                keys.append(part)
        leaf, module = parts[-1], keys[-1] if keys else name
        shape = tuple(p.shape)
        if leaf == "bias":
            v = 0.02 * rng.standard_normal(shape)
        elif "ln" in module:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif module == "tok_embed":
            v = rng.standard_normal(shape)
        elif module == "dec_pos":
            v = 0.1 * rng.standard_normal(shape)
        else:  # Linear (out, in) and Conv1d (out, in, k) weights
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        v = v.astype(np.float32)
        state[name] = torch.from_numpy(v)
        if module == "dec_pos":
            flat["params/dec_pos"] = v
            continue
        if module in ("query", "key", "value"):  # (h*hd, dim) -> (dim, h, hd); 4 heads
            v = v.T.reshape(v.shape[1], 4, -1) if leaf == "weight" else v.reshape(4, -1)
        elif module == "out" and leaf == "weight":  # (dim, h*hd) -> (h, hd, dim)
            v = v.T.reshape(4, -1, v.shape[0])
        elif module in ("conv1", "conv2") and leaf == "weight":
            v = v.transpose(2, 1, 0)
        elif leaf == "weight" and module not in ("tok_embed",) and "ln" not in module:
            v = v.T
        if leaf == "weight":
            leaf = "embedding" if module == "tok_embed" else "scale" if "ln" in module \
                else "kernel"
        flat["/".join(["params", *keys, leaf])] = np.ascontiguousarray(v)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flat)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"model_name": "WhisperStyleASR", "model_args": {}}, f)
    shutil.copy(os.path.join(ROOT, "checkpoints", "asr-bootstrap", "vocab.txt"), path)
    return state


def greedy_with_margins(eng, batch: np.ndarray, n_frames: list) -> tuple[np.ndarray, np.ndarray]:
    """The engine's greedy loop, step by step, with each step's top-two
    logit margin per row: (ids, margins), both (rows, max_decode)."""
    import torch

    eos = eng.tokenizer.eos_id
    with torch.inference_mode():
        enc, enc_mask = eng.encode(batch, n_frames)
        toks = torch.full((enc.shape[0], 1), eng.tokenizer.sos_id, dtype=torch.long,
                          device=enc.device)
        done = torch.zeros(enc.shape[0], dtype=torch.bool, device=enc.device)
        margins = []
        for _ in range(eng.max_decode):
            logits = eng.model.decode(toks, enc, enc_mask, last_only=True)
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            nxt = torch.where(done, eos, torch.argmax(logits, dim=-1))
            toks = torch.cat([toks, nxt[:, None]], dim=1)
            done = done | (nxt == eos)
    return toks[:, 1:].cpu().numpy(), np.stack(margins, axis=1)


def engines_system(device: str) -> dict:
    """`build_model()` with SenseVoice and CAM++ on `infer` (a) and one
    unpaced `infer_stream` session of (a)'s twenty 1 s chunks: bf16 (the
    main path, counted), float32 kernels against float32 plain."""
    import torch

    from targetdiarization_tpu_torch.models.speaker import CAMPlusPlus

    calls, enroll = infer_inputs()
    name = "a: overlapped dialogue 20 s"
    audio = calls[name][0]
    audio_s = len(audio) / SR
    t = time.time()
    td = load_engines(device=device)
    asr, spk = td.tasr.asrp.asr, td.tasr.spk
    emit("engines_load", load_s=time.time() - t, settings={k: os.path.relpath(v, ROOT)
                                                          if os.path.isabs(v) else v
                                                          for k, v in ENGINE_SETTINGS.items()},
         asr=type(asr.model).__name__, asr_dtype=str(asr.compute_dtype),
         speaker=type(spk.model).__name__, speaker_dtype=str(spk.compute_dtype),
         sensevoice_layers=len(asr.model.encoder.blocks), fused_asr=td.fused_asr is not None)
    if not (asr.engine == "sensevoice" and isinstance(spk.model, CAMPlusPlus)
            and asr.compute_dtype == torch.bfloat16 and td.fused_asr is None):
        raise AssertionError("build_model did not load SenseVoice and CAM++ in bf16")
    counter = PathCounter(td, asr_name="sensevoice")
    per, layers = counter.per_forward, len(td.ap.separator.model.mask_net.layers)
    if per["sensevoice"] != len(asr.model.encoder.blocks):
        raise AssertionError(f"SenseVoice holds {per['sensevoice']} memory convs, want one a layer")
    seen = record_target_pieces(td)
    td.infer(audio, enroll)  # warm-up: the rungs' cuDNN, cuFFT and cuBLAS set-up
    counter.start()
    out, wall = timed(lambda: td.infer(audio, enroll))
    infer_launches = counter.stop()
    fw = dict(counter.forwards)
    main = infer_summary(out, seen["pieces"])
    emit("engines_infer", path="bf16 kernels", call=name, audio_s=audio_s, wall_s=wall,
         rtfx=audio_s / wall, target_spk=out[0], entries=main["entries"], forwards=fw,
         launches=infer_launches)
    want = {"ffconvm": 5 * layers * fw["separator"], "flash_gated": layers * fw["separator"],
            "flash_group": 0, "dwconv": sum(per[k] * fw[k] for k in fw)}
    if infer_launches != want or not fw["sensevoice"] or not fw["separator"] or not out[1]:
        raise AssertionError(f"infer with SenseVoice: launches {infer_launches}, want {want} "
                             f"from forwards {fw}, results {out[1]}")
    rec = record_session(td)
    counter.start()
    s1 = stream_session(td, audio, enroll)
    stream_launches = counter.stop()
    fw_s = dict(counter.forwards)
    unrecord(td)
    emit("engines_stream", path="bf16 kernels, async flushes",
         **session_summary(s1, audio_s, rec["flushes"]), forwards=fw_s,
         launches=stream_launches, results=s1["results"])
    if not s1["results"] or not fw_s["sensevoice"] or stream_launches["dwconv"] < \
            per["sensevoice"] * fw_s["sensevoice"] or not stream_launches["ffconvm"]:
        raise AssertionError(f"infer_stream with SenseVoice: {stream_launches}, {fw_s}, "
                             f"{s1['results']}")
    data = asr_inputs()
    tags = asr.asr_detection_batch(data["utts"])
    emit("engines_tags", texts=data["texts"], results=tags,
         cer_vs_rendered_text=[cer(t, r["text"]) for t, r in zip(data["texts"], tags)])
    if not all({"language", "emotion", "event"} <= set(r) for r in tags):
        raise AssertionError(f"SenseVoice gave no tags: {tags}")
    main_launches = {k: infer_launches[k] + stream_launches[k] for k in infer_launches}
    bf16_s1 = s1
    del td, counter

    # float32: kernels against plain on infer (a) and the session
    td32 = load_engines("float32", device=device)
    seen = record_target_pieces(td32)
    kern = infer_summary(td32.infer(audio, enroll), seen["pieces"])
    with plain_kernels():
        plain = infer_summary(td32.infer(audio, enroll), seen["pieces"])
    f32, bf16 = infer_agreement(kern, plain), infer_agreement(main, plain)
    rec = record_session(td32)
    k_run = stream_session(td32, audio, enroll)
    k_flushes = list(rec["flushes"])
    rec["flushes"].clear()
    with plain_kernels():
        p_run = stream_session(td32, audio, enroll)
    p_flushes = list(rec["flushes"])
    unrecord(td32)
    s_f32 = session_agreement(k_run, p_run, k_flushes, p_flushes)
    emit("engines_agreement", infer_f32_kernels_vs_f32_plain=f32,
         infer_bf16_kernels_vs_f32_plain=bf16, stream_f32_kernels_vs_f32_plain=s_f32,
         f32_plain_entries=plain["entries"], stream_bf16_results=bf16_s1["results"],
         stream_f32_plain_results=p_run["results"])
    # the limits of check_infer and check_stream: where the separator ran, a
    # stream one int16 step apart can flip an argmax, so CER <= 0.03 there
    texts_ok = f32["texts_equal"] or f32["cer"] <= 0.03
    if not (f32["target_spk_equal"] and f32["speakers_equal"] and f32["entries_equal"]
            and texts_ok and f32["timerange_max_gap_s"] <= 0.01):
        raise AssertionError(f"infer with SenseVoice: float32 kernels vs float32 plain: {f32}")
    if not within_s1_limits(s_f32):
        raise AssertionError(f"infer_stream with SenseVoice: float32 kernels vs plain: {s_f32}")
    if not (bf16["target_spk_equal"] and bf16["speakers_equal"] and main["entries"]):
        raise AssertionError(f"infer with SenseVoice: bf16 vs float32 plain: {bf16}")
    del td32
    return main_launches


def engines_sensevoice(device: str) -> dict:
    """SenseVoice at full width with seeded weights on the card: one
    asr_detection_batch of the ASR phase's utterances and one 30 s clip,
    counted (50 dwconv a forward); kernels against plain on the same."""
    import torch

    from targetdiarization_tpu_torch.models.asr import LFR_N, ASREngine
    from targetdiarization_tpu_torch.models.features import num_frames

    t = time.time()
    eng = ASREngine(seeded_sensevoice(device), device=device, compute_dtype="float32")
    data = asr_inputs()
    clip = data["long"][: 30 * SR]
    n_params = sum(p.numel() for p in eng.model.parameters())

    def run():
        return eng.asr_detection_batch(data["utts"]), eng.asr_detection(clip)[0]

    run()  # warm-up
    forwards = [0]
    hook = eng.model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    reset_launches()
    (batch, long), wall = timed(run)
    launches = read_launches()
    hook.remove()
    _, batch_s = timed(lambda: eng.asr_detection_batch(data["utts"]))
    _, clip_s = timed(lambda: eng.asr_detection(clip))
    padded = clip[None]
    t_lfr = [-(-num_frames(len(clip)) // LFR_N)]
    with torch.inference_mode():
        logits_k = eng.forward_device(padded, t_lfr)["ctc_logits"]
        ids_k = eng._dispatch(padded, t_lfr)
        with plain_kernels():
            logits_p = eng.forward_device(padded, t_lfr)["ctc_logits"]
            ids_p = eng._dispatch(padded, t_lfr)
            batch_p, long_p = run()
    err, rel = rel_err(logits_k, logits_p)
    same_ids = all(np.array_equal(ids_k[k], ids_p[k]) for k in ids_k)
    per_forward = launches["dwconv"] / max(forwards[0], 1)
    emit("engines_sensevoice_full", path="float32 kernels", params=n_params,
         layers=len(eng.model.encoder.blocks), dim=eng.model.encoder.dim, load_s=time.time() - t,
         forwards=forwards[0], launches=launches, dwconv_per_forward=per_forward,
         wall_s=wall, batch_ms=batch_s * 1e3, clip_30s_ms=clip_s * 1e3,
         memory_rows=t_lfr[0] + 4, ctc_logits_max_abs_err=err, ctc_logits_rel_err=rel,
         ctc_ids_equal=same_ids, results_equal=(batch, long) == (batch_p, long_p),
         texts=[r["text"][:12] for r in batch])
    if per_forward != 50 or launches["ffconvm"] or launches["flash_gated"] or not forwards[0]:
        raise AssertionError(f"full-width SenseVoice: launches {launches} for {forwards[0]} "
                             "forwards, want 50 dwconv a forward")
    if not (same_ids and (batch, long) == (batch_p, long_p) and rel <= TOL["float32"]):
        raise AssertionError(f"full-width SenseVoice: kernels vs plain: ids equal {same_ids}, "
                             f"rel err {rel:.3g}")
    del eng, logits_k, logits_p
    torch.cuda.empty_cache()
    return launches


def engines_whisper(device: str) -> None:
    """Whisper at its class defaults from a seeded checkpoint, loaded as a
    user would (ASRProcessor, asr_engine="whisper_v3"): the card's float32
    greedy ids against the port's on the CPU."""
    import tempfile

    import torch

    from targetdiarization_tpu_torch.models.features import num_frames
    from targetdiarization_tpu_torch.models.whisper_style import _SAMPLE_LADDER, WhisperStyleEngine
    from targetdiarization_tpu_torch.ops.kernels._build import BUILD_DIR
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor

    os.makedirs(BUILD_DIR, exist_ok=True)
    data = asr_inputs()
    bucket = max(_SAMPLE_LADDER.bucket(len(u)) for u in data["utts"])
    batch = np.stack([np.pad(u, (0, bucket - len(u))) for u in data["utts"]])
    frames = [num_frames(len(u)) for u in data["utts"]]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as path:
        state = write_whisper_checkpoint(path)
        kw = {"asr_model": path, "asr_engine": "whisper_v3", "compute_dtype": "float32"}
        card, cpu = ASRProcessor(**kw, device=device), ASRProcessor(**kw, device="cpu")
    if not isinstance(card.asr, WhisperStyleEngine) or any(
            not torch.equal(cpu.asr.model.state_dict()[k], v) for k, v in state.items()):
        raise AssertionError("the whisper checkpoint did not load as written")
    reset_launches()
    ids = card.asr.greedy(batch, frames)
    launches = read_launches()
    ids_cpu, margins = greedy_with_margins(cpu.asr, batch, frames)
    if not np.array_equal(ids_cpu, cpu.asr.greedy(batch, frames)):
        raise AssertionError("the CPU's stepped greedy loop is not the engine's")
    firsts = []
    for row in range(len(ids)):
        diff = np.flatnonzero(ids[row] != ids_cpu[row])
        firsts.append(None if not diff.size else
                      {"row": row, "step": int(diff[0]),
                       "cpu_top2_margin": float(margins[row, diff[0]])})
    one = data["utts"][0]
    card.asr_detection(one)
    _, call_s = timed(lambda: card.asr_detection(one))
    emit("engines_whisper", path="float32, no kernel of the port (attention, LayerNorm, convs "
         "and GEMMs in plain torch)", geometry={"dim": 256, "ffn": 1024, "enc_layers": 6,
                                                "dec_layers": 4, "max_tokens": 224},
         steps=card.asr.max_decode, ms_per_call=call_s * 1e3, launches=launches,
         ids_equal=bool(np.array_equal(ids, ids_cpu)), first_differences=firsts,
         min_cpu_margin=float(margins.min()), eos_rows=int((ids == card.asr.tokenizer.eos_id)
                                                           .any(axis=1).sum()))
    if any(launches.values()):
        raise AssertionError(f"whisper launched a kernel: {launches}")
    if any(f is not None and f["cpu_top2_margin"] >= WHISPER_TIE for f in firsts):
        raise AssertionError(f"whisper: card ids part from the CPU's outside a near tie: {firsts}")


def engines_campp(device: str) -> None:
    """CAM++ (`campp-bootstrap`) on the card: the 8 s enrollment and the 46 s
    conversation's 1.5 s windows (hop 0.75 s), float32 against the port on
    the CPU and bf16 against float32."""
    from targetdiarization_tpu_torch.models.speaker import SpeakerEngine

    path = ENGINE_SETTINGS["EMBEDDING_MODEL"]
    conv, clip = conversation(46.0, seed=8), enrollment(8.0, seed=9)
    wins = [conv[i: i + 3 * SR // 2] for i in range(0, len(conv) - 3 * SR // 2 + 1, 3 * SR // 4)]
    engines = {name: SpeakerEngine.from_pretrained(path, device=dev, compute_dtype=dt)
               for name, dev, dt in (("bf16", device, None), ("f32", device, "float32"),
                                     ("cpu", "cpu", "float32"))}
    out, ms = {}, {}
    for name, eng in engines.items():
        eng.embed_batch(wins[:2])  # warm-up
        out[name], wall = timed(lambda: (eng.embed_batch(wins), eng.get_speaker_embedding(clip)))
        ms[name] = wall * 1e3
    cos_cpu = min(cosines(out["f32"][0], out["cpu"][0]).min(),
                  cosines(out["f32"][1], out["cpu"][1]).min())
    cos_bf16 = min(cosines(out["bf16"][0], out["f32"][0]).min(),
                   cosines(out["bf16"][1], out["f32"][1]).min())
    emit("engines_campp", windows=len(wins), enrollment_s=len(clip) / SR,
         ms={"bf16 card": ms["bf16"], "f32 card": ms["f32"], "f32 cpu": ms["cpu"]},
         min_cos_f32_card_vs_cpu=float(cos_cpu), min_cos_bf16_vs_f32=float(cos_bf16))
    if not (cos_cpu >= 0.9999 and cos_bf16 >= 0.95):
        raise AssertionError(f"CAM++: card f32 vs CPU {cos_cpu:.6f}, bf16 vs f32 {cos_bf16:.4f}")


def check_engines(device: str = "cuda") -> dict:
    """The engines a user selects with ASR_ENGINE and EMBEDDING_MODEL: the
    system with SenseVoice and CAM++, SenseVoice at full width, whisper at
    its class defaults, CAM++ against the CPU. Returns the main path's
    launches: the bf16 system's `infer` and session and the full-width
    SenseVoice calls."""
    import torch

    system = engines_system(device)
    full = engines_sensevoice(device)
    engines_whisper(device)
    engines_campp(device)
    torch.cuda.synchronize()
    return {k: system[k] + full[k] for k in system}


# ---------------- the zoo: ten separators behind SeparationEngine ----------------

ZOO_KERNEL_CLASSES = ("ConvTasNet", "MossFormer")  # the classes that run kernels


def kernel_forward(model) -> dict:
    """Kernel launches of one forward of `model` (after `prepare_kernels`):
    an FFConvM launch per FFConvM module, a gated FLASH per FlashBlock, and
    `dw_per_forward`'s dwconv launches: for the zoo, a dwconv for each
    depthwise conv of ConvTasNet's TCN blocks (24 at the class defaults),
    three FFConvM and one gated FLASH for each of MossFormer's FlashBlocks
    (72 and 24)."""
    from targetdiarization_tpu_torch.models.separation import FFConvM, FlashBlock

    mods = list(model.modules())
    return {"ffconvm": sum(isinstance(m, FFConvM) for m in mods),
            "flash_gated": sum(isinstance(m, FlashBlock) for m in mods),
            "flash_group": 0, "dwconv": dw_per_forward(model)}


def seeded_zoo_model(name: str, args: dict | None = None, seed: int = 11):
    """The zoo class `name` (at its class defaults unless `args`) with
    numpy-seeded weights at the JAX initializers' scales: kernels normal
    with variance 1 / fan-in (flax's lecun_normal), biases zero, norm
    scales one, PReLU slopes 0.25, MossFormer's offset scales normal(0.02)."""
    import torch
    from torch import nn

    from targetdiarization_tpu_torch.models import zoo

    model = getattr(zoo, name)(**(args or {}))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in model.modules():
            for leaf, p in module.named_parameters(recurse=False):
                shape = tuple(p.shape)
                if leaf == "alpha":
                    v = np.full(shape, 0.25)
                elif leaf == "os_gamma":
                    v = 0.02 * rng.standard_normal(shape)
                elif leaf.startswith("bias") or leaf in ("b", "beta", "os_beta"):
                    v = np.zeros(shape)
                elif leaf in ("w", "weight") and len(shape) == 1 or leaf in ("gamma", "g"):
                    v = np.ones(shape)
                else:
                    if isinstance(module, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
                        fan = shape[0] * int(np.prod(shape[2:]))  # (in, out, k...)
                    elif leaf in ("kernel", "dwk", "w", "in_w"):  # (K, m, C), (G, in, out), (3D, D)
                        fan = shape[0] * shape[1] if len(shape) == 3 else shape[0]
                    else:  # Linear, Conv and LSTM weights: (out, in, k...)
                        fan = int(np.prod(shape[1:]))
                    v = rng.standard_normal(shape) / np.sqrt(fan)
                p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model.eval()


def best_pairing_si_sdr(got: np.ndarray, want: np.ndarray) -> float:
    """The smallest stream SI-SDR of `got` against `want` (both (spk, T)) in
    the pairing of streams that makes it largest (loudness ordering may
    swap two streams of near-equal loudness)."""
    import itertools

    return max(min(si_sdr(got[i], want[j]) for i, j in enumerate(perm))
               for perm in itertools.permutations(range(len(want))))


def zoo_engine(name: str, path: str, device: str):
    """The class's checkpoint through `SeparationEngine.from_pretrained` in
    float32 and in bf16, each recording its forwards' (rows, samples,
    lengths)."""
    from targetdiarization_tpu_torch.models.separation import SeparationEngine

    engines = {}
    for dtype in ("float32", "bfloat16"):
        eng = SeparationEngine.from_pretrained(path, device=device, compute_dtype=dtype)
        eng.calls = []
        forward = eng._forward

        def recorded(batch, lengths, eng=eng, forward=forward):
            eng.calls.append([int(batch.shape[0]), int(batch.shape[1]),
                              [int(x) for x in lengths]])
            return forward(batch, lengths)

        eng._forward = recorded
        engines[dtype] = eng
    if type(engines["float32"].model).__name__ != name:
        raise AssertionError(f"{path} loaded {type(engines['float32'].model).__name__}")
    return engines


def zoo_cpu_reference(path: str, audio: np.ndarray, threads: int) -> tuple:
    """The port's own CPU float32 run of the checkpoint under `path` on
    `audio`, on `threads` of the host's cores, and its ms (in the zoo
    phase's worker process)."""
    import torch

    from targetdiarization_tpu_torch.models.separation import SeparationEngine
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    torch.set_num_threads(threads)
    cpu = SeparationEngine(from_pretrained(path), device="cpu", compute_dtype="float32")
    t = time.perf_counter()
    out = cpu.separate(audio)
    return out, (time.perf_counter() - t) * 1e3


def zoo_class(name: str, root: str, args: dict | None, device: str, seconds: tuple,
              cpu_pool, cpu_threads: int) -> tuple:
    """One class: a seeded checkpoint written through the inverse converter,
    `separate` (4 s) and `separate_batch` (1.5, 2.5, 4 s) through the
    float32 and bf16 engines with their forwards, bf16 against float32
    plain, and for the classes with kernels float32 kernels against
    float32 plain. The CPU run of the 2 s clip goes to `cpu_pool` as soon
    as the checkpoint is written. Returns the main path's launches (the
    bf16 engine's calls) and the card's float32 run of the 2 s clip with
    the pending CPU run."""
    import torch

    from targetdiarization_tpu_torch.runtime.registry import save_checkpoint

    t0 = time.time()
    path = os.path.join(root, name)
    save_checkpoint(path, seeded_zoo_model(name, args), name, args)
    long_s, *batch_s, cpu_s = seconds
    short = two_voice_mix(cpu_s, seed=26)
    reference = cpu_pool.submit(zoo_cpu_reference, path, short, cpu_threads)
    engines = zoo_engine(name, path, device)
    e32, e16 = engines["float32"], engines["bfloat16"]
    mix = two_voice_mix(long_s, seed=21)
    clips = [two_voice_mix(s, seed=22 + i) for i, s in enumerate(batch_s + [long_s])]
    e16.separate(mix)  # warm-up: the rung's cuDNN, cuFFT and cuBLAS set-up
    torch.cuda.synchronize()
    e16.calls.clear()
    reset_launches()
    t = time.perf_counter()
    main = e16.separate(mix)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    separate_calls = list(e16.calls)
    e16.calls.clear()
    main_batch = e16.separate_batch(clips)
    torch.cuda.synchronize()
    launches = read_launches()
    batch_calls = list(e16.calls)
    per = kernel_forward(e16.model)
    want = {k: n * len(separate_calls + batch_calls) for k, n in per.items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want} from "
                             f"{separate_calls + batch_calls}")
    f32 = e32.separate(mix)
    with plain_kernels():
        plain = e32.separate(mix)
    card = e32.separate(short)
    outs = [main, f32, plain, card, *main_batch]
    if not all(np.isfinite(o).all() for o in outs) or main.shape != (e16.num_spks, mix.size) \
            or [b.shape for b in main_batch] != [(e16.num_spks, c.size) for c in clips]:
        raise AssertionError(f"{name}: bad outputs {[o.shape for o in outs]}")
    agree = {"bf16_vs_f32_plain_db": best_pairing_si_sdr(main, plain)}
    if name in ZOO_KERNEL_CLASSES:
        agree["f32_kernels_vs_f32_plain_db"] = best_pairing_si_sdr(f32, plain)
    emit("zoo_class", name=name, args=args or "class defaults",
         params=sum(p.numel() for p in e32.model.parameters()), pad_safe=e16.pad_safe,
         num_spks=e16.num_spks, sample_rate=e16.sample_rate, per_forward=per, separate_ms=ms,
         audio_s=long_s, rtfx=long_s / (ms / 1e3),
         forwards={"separate": separate_calls, "separate_batch": batch_calls},
         launches=launches, **agree, phase_s=time.time() - t0)
    limits = {"bf16_vs_f32_plain_db": 10.0, "f32_kernels_vs_f32_plain_db": 40.0}
    missed = {k: v for k, v in agree.items() if not v >= limits[k]}
    if missed:
        raise AssertionError(f"{name}: below the limits {limits}: {missed}")
    # the ladder for the pad-safe classes, exact lengths clip by clip otherwise
    sizes = [len(x) for x in clips]
    if e16.pad_safe:  # the batcher pads a forward's rows to a row rung
        rows = [1] * (4 - len(sizes)) if e16._mb is not None else []
        expect = [[1, e16.ladder.bucket(mix.size), [mix.size]],
                  [len(sizes + rows), e16.ladder.bucket(max(sizes)), sizes + rows]]
    else:
        expect = [[1, mix.size, [mix.size]]] + [[1, n, [n]] for n in sizes]
    if e16.sample_rate == SR and separate_calls + batch_calls != expect:
        raise AssertionError(f"{name}: forwards {separate_calls + batch_calls}, want {expect}")
    del engines, e32, e16
    return launches, (name, card, reference)


def zoo_infer(name: str, path: str, device: str = "cuda") -> dict:
    """`build_model()` with TD_SEP_CHECKPOINT naming the class's checkpoint:
    `infer` on (a) in bf16 (the main path, counted), then float32 kernels
    against float32 plain with `check_infer`'s limits."""
    from unittest import mock

    import torch

    from targetdiarization_tpu_torch.serve.server import build_model

    calls, enroll = infer_inputs()
    audio = calls["a: overlapped dialogue 20 s"][0]
    out = {}
    for dtype in ("bfloat16", "float32"):
        with mock.patch.dict(os.environ, {"TD_SEP_CHECKPOINT": path, "TD_COMPUTE_DTYPE": dtype}):
            td = build_model(device=device)
        if type(td.ap.separator.model).__name__ != name:
            raise AssertionError(f"build_model loaded {type(td.ap.separator.model).__name__}")
        seen = record_target_pieces(td)
        forwards = []
        hook = td.ap.separator.model.register_forward_hook(
            lambda m, a, o: forwards.append(list(a[0].shape)))
        if dtype == "bfloat16":
            reset_launches()
            res, wall = timed(lambda: td.infer(audio, enroll))
            out["launches"] = read_launches()
            out["main"] = infer_summary(res, seen["pieces"])
            emit("zoo_infer", name=name, path="bf16 kernels", wall_s=wall,
                 rtfx=len(audio) / SR / wall, separator_forwards=forwards,
                 entries=out["main"]["entries"], launches=out["launches"])
            want = {k: n * len(forwards) for k, n in kernel_forward(td.ap.separator.model).items()}
            if not forwards or any(out["launches"][k] < n for k, n in want.items()):
                raise AssertionError(f"{name} infer: launches {out['launches']}, separator "
                                     f"forwards {forwards}")
        else:
            kern = infer_summary(td.infer(audio, enroll), seen["pieces"])
            with plain_kernels():
                plain = infer_summary(td.infer(audio, enroll), seen["pieces"])
            f32 = infer_agreement(kern, plain)
            emit("zoo_infer_agreement", name=name, f32_kernels_vs_f32_plain=f32,
                 separator_forwards=forwards, bf16_vs_f32_plain=infer_agreement(
                     out["main"], plain))
            # check_infer's float32 limits for a call whose target went
            # through the separator
            if not (f32["target_spk_equal"] and f32["speakers_equal"] and f32["cer"] <= 0.03
                    and f32["entries_equal"] and f32["timerange_max_gap_s"] <= 0.01
                    and (f32["target_audio_equal"]
                         or (f32["target_audio_si_sdr_db"] or 0.0) >= 40.0)
                    and f32["target_entries"]["unpaired"] == [[], []]
                    and min_at_least(f32["target_entries"]["min_si_sdr_db"], 40.0)):
                raise AssertionError(f"{name} infer: float32 kernels vs float32 plain: {f32}")
        hook.remove()
        del td
        torch.cuda.synchronize()
    return out["launches"]


def check_zoo(device: str = "cuda", args: dict | None = None,
              seconds: tuple = (4.0, 1.5, 2.5, 2.0),
              infer: tuple = ("ConvTasNet", "MossFormer")) -> dict:
    """The zoo phase: every class at its class defaults (or `args[name]`)
    through the engine, then `build_model()` + `infer` on two of them.
    Each class's CPU run of the 2 s clip (the card's float32 run must
    agree with it) runs in one worker process while the card goes on with
    the next classes: a process, so that it holds no lock the thread that
    drives the card waits for, on half the host's cores, so that neither
    side's threads wait for a core. The seeded
    checkpoints live in a temporary directory for the run. Returns the
    main path's launches: the bf16 engines' and infers'."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from targetdiarization_tpu_torch.models.zoo import CLASSES

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="td_zoo_")
    cpu_threads = max(1, min(torch.get_num_threads(), len(os.sched_getaffinity(0)) // 2))
    totals = {k: 0 for k in read_launches()}
    pending = []
    try:
        with ProcessPoolExecutor(1, multiprocessing.get_context("spawn")) as cpu_pool:
            for name in CLASSES:
                launches, p = zoo_class(name, root, (args or {}).get(name), device, seconds,
                                        cpu_pool, cpu_threads)
                pending.append(p)
                for k, v in launches.items():
                    totals[k] += v
            for name in infer:
                for k, v in zoo_infer(name, os.path.join(root, name), device).items():
                    totals[k] += v
            card_s = time.time() - t0
            missed = {}
            for name, card, reference in pending:
                on_cpu, cpu_ms = reference.result()
                db = best_pairing_si_sdr(card, on_cpu)
                emit("zoo_cpu_reference", name=name, cpu_separate_ms=cpu_ms,
                     cpu_audio_s=seconds[-1], cpu_threads=cpu_threads,
                     card_f32_vs_cpu_f32_db=db)
                if not (np.isfinite(on_cpu).all() and on_cpu.shape == card.shape and db >= 40.0):
                    missed[name] = db
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    emit("zoo", phase_s=time.time() - t0, card_s=card_s, launches=totals)
    if missed:
        raise AssertionError(f"the card's float32 runs below 40 dB against the CPU's: {missed}")
    if not all(totals[k] > 0 for k in ("ffconvm", "flash_gated", "dwconv")):
        raise AssertionError(f"the zoo's main path missed a kernel: {totals}")
    return totals


# ---------------- training: SeparationTrainer through the kernels' Functions ----------------

# train/recipes.py:147-171's settings (bootstrap_separator) on the 512/24 separator
TRAIN_SETTINGS = dict(optimizer="adam", learning_rate=5e-4, grad_clip=5.0, save_every=0)
# (name, B, T, K, C, dilation, pads or None for SAME) of dwconv's dx launches:
# the separator's conv0 at batch 8 of 1 s (2000 encoder frames padded to
# 2048), ConvTasNet's K 3 TCN convs at batch 2 of 1 s (1999 frames; 64 and
# 128 run on phase tiles), and the recipes' m = 1 convs at their training
# steps' shapes (DWCONV_SHAPES)
DX_SHAPES = (("separator conv0", 8, 2048, 39, 256, 1, None),
             *((f"ConvTasNet TCN, dilation {d}", 2, 1999, 3, 512, d, None)
               for d in (1, 32, 64, 128)),
             ("recipe: VAD memory, 16 x 2 s", 16, 198, 13, 64, 1, (10, 2)),
             ("recipe: SAN-M memory, Paraformer 16 x 4 s", 16, 67, 11, 256, 1, None),
             ("recipe: SenseVoice memory, 16 x 4 s", 16, 71, 11, 192, 1, None),
             ("recipe: Apollo ConvActNorm, 8 x 2 s", 640, 201, 7, 96, 1, None),
             ("recipe: separator 64/4 conv0, 8 x 1 s", 8, 2048, 39, 64, 1, None))


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def check_dx() -> list[dict]:
    """dwconv's dx through the kernel (the backward's `_dx`: taps flipped and
    made per call, one launch) against autograd of `dwconv_plain` on the
    card, in float32 and bf16, SAME pads unless the row gives its own:
    host-inclusive ms of `_dx`, device ms of its launch alone, the plain
    dx's ms, the bytes bound and the library's `torch.nn.grad.conv1d_input`
    on the padded input (host-inclusive and device ms)."""
    import torch
    import torch.nn.functional as F

    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwmod

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, batch, t, k, c, dil, pads in DX_SHAPES:
        span = (k - 1) * dil
        pad_l, pad_r = pads or (span // 2, span - span // 2)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(batch, t, c, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, 1, c, generator=gen, device="cuda") * 0.2).to(dtype)
            g = torch.randn(batch, t, c, generator=gen, device="cuda").to(dtype)
            xr = x.clone().requires_grad_()
            (want,) = torch.autograd.grad(dwmod.dwconv_plain(xr, w, dil, pad_l, pad_r), xr, g)
            before = dwmod.dwconv.backward_launches
            got = dwmod._dx(g, w, dil, pad_l, pad_r, t)
            if dwmod.dwconv.backward_launches != before + 1:
                raise AssertionError("dwconv's dx did not launch its kernel")
            sync("cuda")
            err, rel = rel_err(got, want)
            dname = str(dtype).split(".")[1]
            taps = dwmod.prepare_taps(w.flip(0).contiguous())
            flipped = w.flip(0)
            isz = x.element_size()
            flops = 2.0 * batch * t * c * k
            nbytes = isz * (2 * batch * t * c + k * c)
            bound_ms, bound_by = bound(flops, nbytes, "float32")
            gt = g.transpose(1, 2)
            wt = w.permute(2, 1, 0).contiguous()
            size = (batch, c, t + pad_l + pad_r)

            def library():
                return torch.nn.grad.conv1d_input(size, wt, gt, dilation=dil, groups=c)

            row = {"shape": name, "dtype": dname, "B": batch, "T": t, "K": k, "C": c,
                   "dilation": dil, "pads": [pad_l, pad_r], "flops": flops, "bytes": nbytes,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": time_ms(lambda: dwmod._dx(g, w, dil, pad_l, pad_r, t)),
                   "device_ms": graph_ms(lambda: dwmod._launch(g, taps, dil, span - pad_l,
                                                               span - pad_r)),
                   "plain_ms": time_ms(lambda: dwmod.dwconv_plain(g, flipped, dil,
                                                                  span - pad_l, span - pad_r)),
                   "library_ms": time_ms(library), "library_device_ms": graph_ms(library),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit("dwconv_dx", **row)
            if not rel <= TOL[dname]:
                raise AssertionError(f"dwconv dx {name} {dname}: kernel vs plain rel err "
                                     f"{rel:.3g} > {TOL[dname]}")
            rows.append(row)
            del x, w, g, xr, want, got, taps
    return rows


def training_speakers(seed: int = 21, per_speaker: int = 3) -> dict:
    """Two synthetic voices (the second `voice_b`), three utterances of 8-12
    characters each, as DynamicMixDataset's speaker pools."""
    rng = np.random.default_rng(seed)
    pools = {"a": [], "b": []}
    for name in pools:
        for _ in range(per_speaker):
            text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                           for _ in range(int(rng.integers(8, 13))))
            utt = synth_utterance(text, rng)[0]
            pools[name].append(voice_b(utt) if name == "b" else utt)
    return pools


def flat_grads(grads: list):
    import torch

    return torch.cat([g.reshape(-1).double() for g in grads])


def plain_forwards(kernels: tuple = ("ffconvm", "flash_gated", "dwconv")):
    """The kernels' Functions with the plain forwards of `kernels`: the
    backward is the card's (the recomputes, dwconv's dx on its kernel), the
    forward values of those kernels the plain path's."""
    from contextlib import ExitStack
    from unittest import mock

    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwmod
    from targetdiarization_tpu_torch.ops.kernels import ffconvm as ffmod
    from targetdiarization_tpu_torch.ops.kernels import flash as flmod

    patches = {"ffconvm": (ffmod, "_forward", lambda x, na, nb, w, b, k, norm, prepared:
                           ffmod.ffconvm_plain(x, na, nb, w, b, k, norm)),
               "flash_gated": (flmod, "_gated_forward", flmod.flash_gated_plain),
               "dwconv": (dwmod, "_forward", lambda x, k, d, pad_l, pad_r, taps:
                          dwmod.dwconv_plain(x, k, d, pad_l, pad_r))}
    stack = ExitStack()
    for name in kernels:
        stack.enter_context(mock.patch.object(*patches[name]))
    return stack


def grad_agreement(a: tuple, b: tuple) -> dict:
    """Loss and gradient of step a against step b ((loss, flat gradient))."""
    import torch

    norm_a, norm_b = float(a[1].norm()), float(b[1].norm())
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "grad_norm_rel": abs(norm_a - norm_b) / norm_b,
            "grad_cosine": float(torch.dot(a[1], b[1]) / (norm_a * norm_b)),
            "grad_norms": [norm_a, norm_b]}


def within(agree: dict, loss: float, norm: float, cosine: float) -> bool:
    return agree["loss_rel"] <= loss and agree["grad_norm_rel"] <= norm \
        and agree["grad_cosine"] >= cosine


# step 1 against plain: the issue's limits, and (the kernels' forwards on,
# MossFormer2) gross ones: sep-bootstrap-512's float32 gradient moves by more
# than the issue's limits when the input alone is scaled by 1 + 1e-7 (PERF.md
# §6, PR 14), so no float32 path that is not bit for bit the plain one meets
# them; the backward is held to them with the plain forwards
GRAD_LIMITS = dict(loss=1e-3, norm=1e-3, cosine=0.9999)
KERNEL_FORWARD_LIMITS = {"MossFormer2": dict(loss=1e-3, norm=2e-2, cosine=0.995),
                         "ConvTasNet": GRAD_LIMITS}


def grads_against_plain(trainer, batch: dict, label: str) -> dict:
    """Step 1's loss and gradients three ways against the same step under
    `plain_kernels()`: the Functions with plain forwards (the card's
    backward, dwconv's dx on its kernel) within the issue's limits (loss
    and grad global norm within 1e-3 relative, the flattened gradients'
    cosine at least 0.9999); the kernels' forwards on, within
    `KERNEL_FORWARD_LIMITS`; and, to show the model's conditioning, the plain
    path on the mix scaled by 1 + 1e-7."""
    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv

    def step(ctx=None, b=batch):
        from contextlib import nullcontext

        with ctx or nullcontext():
            loss, grads = trainer.loss_and_grads(b)
        flat = flat_grads(grads)
        del grads
        return float(loss), flat

    plain = step(plain_kernels())
    dx_before = dwconv.backward_launches
    backward = grad_agreement(step(plain_forwards()), plain)
    dx_launches = dwconv.backward_launches - dx_before
    kernels = grad_agreement(step(), plain)
    scaled = {"mix": (np.asarray(batch["mix"], np.float64) * (1 + 1e-7)).astype(np.float32),
              "src": batch["src"]}
    conditioning = grad_agreement(step(plain_kernels(), scaled), plain)
    out = {"backward_vs_plain": backward, "backward_dx_launches": dx_launches,
           "kernels_vs_plain": kernels, "plain_on_mix_x_1e-7_vs_plain": conditioning}
    emit("train_grads", model=label, **out)
    limits = KERNEL_FORWARD_LIMITS[label]
    if not (within(backward, **GRAD_LIMITS) and within(kernels, **limits) and dx_launches):
        raise AssertionError(f"{label}: step 1's gradients depart from plain: {out} (limits "
                             f"{GRAD_LIMITS}, with the kernels' forwards {limits})")
    return out


def timed_step(trainer, batch: dict, device: str) -> dict:
    """One more optimizer step, `SeparationTrainer.train_step`'s parts timed
    apart (host clock, synchronized): forward and loss, backward, optimizer
    and `prepare_kernels`."""
    import torch

    from targetdiarization_tpu_torch.ops.kernels import prepare_kernels
    from targetdiarization_tpu_torch.train.optim import apply_updates

    params = list(trainer.params.values())
    (b,) = trainer._place(batch)  # one slot
    sync(device)
    t0 = time.perf_counter()
    loss = trainer._loss(trainer.model(b["mix"]), b["src"])
    sync(device)
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, params)
    sync(device)
    t2 = time.perf_counter()
    with torch.no_grad():
        updates, trainer.state["opt"] = trainer.opt.update(list(grads), trainer.state["opt"],
                                                           params)
        apply_updates(params, updates)
    prepare_kernels(trainer.model)
    sync(device)
    t3 = time.perf_counter()
    trainer.step += 1
    return {"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "optimizer_and_prepare_ms": (t3 - t2) * 1e3, "step_ms": (t3 - t0) * 1e3,
            "loss": float(loss.detach())}


def check_train(device: str = "cuda", checkpoint: str = CHECKPOINT, batch: int = 8,
                seconds: float = 1.0, steps: int = 4, convtasnet_args: dict | None = None,
                convtasnet_batch: int = 2) -> dict:
    """The training phase. dwconv's dx rows (on the card), then the main
    path: `SeparationTrainer` on `checkpoint` in float32 with the bootstrap
    recipe's settings, a fixed batch of `batch` two-voice mixes of
    `seconds` from DynamicMixDataset over synthesized utterances: step 1's
    gradients with the kernels against plain, `steps` fit steps counted
    (per step: FFConvM 120, gated FLASH 24, dwconv 48 forward and 24 dx at
    512/24), one step timed by parts, `evaluate`, save and restore,
    the inference export through `SeparationEngine.from_pretrained` against
    the trained model. Then ConvTasNet (class defaults unless
    `convtasnet_args`): gradients against plain and 2 steps. Returns the
    main path's launches, dx included."""
    import shutil
    import tempfile

    import torch

    from targetdiarization_tpu_torch.models.separation import SeparationEngine
    from targetdiarization_tpu_torch.models.zoo import ConvTasNet
    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
    from targetdiarization_tpu_torch.runtime.params import tree_leaves
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained
    from targetdiarization_tpu_torch.train import SeparationTrainer, TrainConfig
    from targetdiarization_tpu_torch.train.data import DynamicMixDataset, MixConfig

    t0 = time.time()
    dx_rows = check_dx() if device == "cuda" else []
    root = tempfile.mkdtemp(prefix="td_train_")
    try:
        model = from_pretrained(checkpoint)
        layers = len(model.mask_net.layers)
        trainer = SeparationTrainer(model, params=model.state_dict(), cfg=TrainConfig(
            **TRAIN_SETTINGS, checkpoint_dir=os.path.join(root, "state")), device=device)
        pools = training_speakers()
        fixed = next(DynamicMixDataset(pools, MixConfig(segment_seconds=seconds),
                                       seed=0).batches(batch, 1))
        held = next(DynamicMixDataset(pools, MixConfig(segment_seconds=seconds),
                                      seed=1).batches(batch, 1))
        grads = grads_against_plain(trainer, fixed, "MossFormer2")

        # the main path, counted: `steps` fit steps on the fixed batch
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        fit_ms = []
        mark = [time.perf_counter()]

        def log(_):
            fit_ms.append((time.perf_counter() - mark[0]) * 1e3)  # float() synchronized
            mark[0] = time.perf_counter()

        history = trainer.fit([fixed] * steps, log_every=1, log_fn=log)
        sync(device)
        launches = {**read_launches(), "dwconv_dx": dwconv.backward_launches}
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        want = {"ffconvm": 5 * layers * steps, "flash_gated": layers * steps, "flash_group": 0,
                "dwconv": 2 * layers * steps, "dwconv_dx": layers * steps}
        losses = [h["loss"] for h in history]
        emit("launches", path="train", steps=steps, per_step={
            k: v / steps for k, v in launches.items()}, **launches)
        if launches != want:
            raise AssertionError(f"kernel launches {launches} in {steps} training steps, "
                                 f"want {want}")
        if not (len(losses) == steps and np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"training losses {losses}: not finite or not falling")
        parts = timed_step(trainer, fixed, device)
        eval_loss = trainer.evaluate([held])

        # save -> restore: the same parameters and optimizer state
        trainer.save()
        saved = [t.clone() if isinstance(t, torch.Tensor) else t
                 for t in tree_leaves(trainer.state)]
        with torch.no_grad():
            for p in trainer.params.values():
                p.add_(1.0)
        stale_raises = None
        if device == "cuda":  # the kernels' operands now predate the weights: a call raises
            try:
                with torch.no_grad():
                    trainer.model(torch.from_numpy(held["mix"][:1]).to(device))
                stale_raises = False
            except RuntimeError as e:
                stale_raises = "prepare_kernels" in str(e)
            if not stale_raises:
                raise AssertionError("a forward after an in-place weight change did not raise")
        restored_step = trainer.restore()
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(saved, tree_leaves(trainer.state)))
        del saved
        if restored_step != trainer.step or not same:
            raise AssertionError("save -> restore did not give the saved state back")

        # the inference export through the engine, against the trained model
        path = trainer.export_inference_checkpoint(os.path.join(root, "export"))
        engine = SeparationEngine.from_pretrained(path, device=device, compute_dtype="float32")
        clip = two_voice_mix(3.0, seed=5)
        bucket = engine.ladder.bucket(len(clip))
        wav = np.pad(clip, (0, bucket - len(clip)))[None]
        lengths = np.array([len(clip)])
        exported = engine._forward(wav, lengths)[0, :, :len(clip)]
        with torch.no_grad():
            trained = trainer.model(torch.from_numpy(wav).to(device),
                                    torch.from_numpy(lengths).to(device))
        trained = trained.float().cpu().numpy()[0, :, :len(clip)]
        export_db = min(si_sdr(exported[i], trained[i]) for i in range(len(trained)))
        del engine
        main = {"steps": steps, "batch": batch, "seconds": seconds, "losses": losses,
                "fit_step_ms": fit_ms, **parts, "eval_loss": eval_loss,
                "max_memory_allocated": peak, "export_vs_trained_db": export_db,
                "stale_operands_raise": stale_raises}
        emit("train", model="MossFormer2", checkpoint=os.path.relpath(checkpoint, ROOT), **main)
        if not (np.isfinite(exported).all() and export_db >= 40.0):
            raise AssertionError(f"the exported separator departs from the trained one: "
                                 f"{export_db:.1f} dB")
        del trainer, model

        # ConvTasNet: dwconv's dx at dilations up to 128 (phase tiles) on a training path
        tcn = SeparationTrainer(ConvTasNet(**(convtasnet_args or {})), cfg=TrainConfig(
            **TRAIN_SETTINGS), seed=3, device=device)
        n_dw = kernel_forward(tcn.model)["dwconv"]
        small = next(DynamicMixDataset(pools, MixConfig(segment_seconds=seconds),
                                       seed=2).batches(convtasnet_batch, 1))
        tcn_grads = grads_against_plain(tcn, small, "ConvTasNet")
        reset_launches()
        tcn_history = tcn.fit([small] * 2, log_every=1, log_fn=lambda _: None)
        sync(device)
        tcn_launches = {**read_launches(), "dwconv_dx": dwconv.backward_launches}
        emit("train", model="ConvTasNet", losses=[h["loss"] for h in tcn_history],
             launches=tcn_launches, depthwise_convs=n_dw)
        if tcn_launches["dwconv"] != 2 * n_dw or tcn_launches["dwconv_dx"] != 2 * n_dw \
                or not np.isfinite([h["loss"] for h in tcn_history]).all():
            raise AssertionError(f"ConvTasNet training: launches {tcn_launches} for {n_dw} "
                                 "depthwise convs, or a loss that is not finite")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("train_phase", phase_s=time.time() - t0, grads=grads, convtasnet_grads=tcn_grads)
    return launches, dx_rows


# ---------------- the bootstrap recipes: training through the kernels ----------------

# the shipped checkpoints' configurations (their model.json; sep-bootstrap's
# is not in the card's copy of the repository)
RECIPE_MODELS = {
    "vad": {},
    "sep": dict(dim=256, enc_channels=256, num_blocks=12, kernel_size=16, num_spks=2,
                group_size=128, qk_dim=128, fsmn_inner=256, sample_rate=16000),
    "rest": dict(sr=16000, win_ms=20, feature_dim=96, layer=4),
    "asr": dict(vocab_size=21001, dim=256, heads=4, ffn=1024, enc_layers=8, dec_layers=4),
    "sv": dict(vocab_size=21001, dim=192, heads=4, ffn=768, enc_layers=6),
}
# bootstrap_separator's own default model (train/recipes.py), the 64/4
RECIPE_SEP_DEFAULT = dict(dim=64, enc_channels=64, num_blocks=4, group_size=64, qk_dim=32,
                          fsmn_inner=64)
# (label, recipe, its arguments, the checkpoint whose configuration it
# trains): full width, 5 steps, the recipes' batches; only the step and
# eval counts are cut
RECIPE_RUNS = (
    ("vad", "bootstrap_vad", dict(steps=5, batch=16, seconds=2.0), "vad"),
    ("sep 256/12", "bootstrap_separator", dict(steps=5, batch=8, seconds=1.0), "sep"),
    ("sep 64/4", "bootstrap_separator", dict(steps=5, batch=8, seconds=1.0), None),
    ("rest", "bootstrap_restorer", dict(steps=5, batch=8, seconds=2.0, feature_dim=96, layer=4),
     "rest"),
    ("asr", "bootstrap_asr", dict(steps=5, batch=16, seconds=4.0, eval_utts=4, dim=256,
                                  enc_layers=8, dec_layers=4, ffn=1024, device_synth=True,
                                  aug_frac=0.25), "asr"),
    ("sv", "bootstrap_sensevoice", dict(steps=5, batch=16, seconds=4.0, eval_utts=4, dim=192,
                                        enc_layers=6, ffn=768), "sv"),
)
# step 5's loss, kernels against plain, for the recipes whose only kernel is
# dwconv: the recipes run with cuDNN's deterministic algorithms, and over
# seeds 0-3 the gap read at most 3.7e-6 (tools/recipe_repeat.py, PERF.md);
# a CIF token counted differently moves the Paraformer's loss by about
# 1e-3. The separator's fifth step is only held finite (PERF.md: the
# 512/24 MossFormer2's float32 gradient is ill-conditioned)
STEP5_RTOL = 1e-4


def recipe_fixtures(root: str) -> str:
    """The recipes' two fixture recordings, synthesized: `chat_mix.wav` (two
    voices taking turns, 10 s) and `female_a.wav` (the second voice alone,
    8 s), at 16 kHz."""
    from targetdiarization_tpu_torch.utils.audio_io import write_wav

    os.makedirs(root, exist_ok=True)
    write_wav(os.path.join(root, "chat_mix.wav"), conversation(10.0, seed=41), SR)
    write_wav(os.path.join(root, "female_a.wav"), enrollment(8.0, seed=42), SR)
    return root


def recipe_launches(recipe: str, args: dict) -> dict:
    """Kernel launches a training step of `recipe` makes at model `args`:
    each depthwise conv forward once and, at m = 1, its dx once; the
    separator's FFConvM (5 a layer pair) and gated FLASH (1) forward only
    (their backward recomputes the plain version)."""
    zero = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0}
    if recipe == "bootstrap_separator":
        n = args["num_blocks"]
        return {**zero, "ffconvm": 5 * n, "flash_gated": n, "dwconv": 2 * n, "dwconv_dx": n}
    convs = {"bootstrap_vad": args.get("n_layers", 4),
             "bootstrap_restorer": 3 * args.get("layer", 4),
             "bootstrap_asr": args.get("enc_layers", 4) + args.get("dec_layers", 2),
             "bootstrap_sensevoice": args.get("enc_layers", 6)}[recipe]
    return {**zero, "dwconv": convs, "dwconv_dx": convs}


class RecipeProbe:
    """Reads a recipe's training steps as it runs: each step's loss
    unrounded (the log prints 3-4 decimals), the time between step ends and
    the kernel launches between them; every initial draw, and every model
    the recipe saves (its state as saved, where its tensors lay)."""

    def __init__(self, device: str):
        self.device = device
        self.losses, self.ends, self.launches, self.inits, self.saves = [], [], [], [], []

    def _end(self, loss) -> None:
        from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv

        sync(self.device)
        self.losses.append(float(loss))
        self.ends.append(time.perf_counter())
        self.launches.append({**read_launches(), "dwconv_dx": dwconv.backward_launches})

    def patches(self):
        from contextlib import ExitStack
        from unittest import mock

        from targetdiarization_tpu_torch.runtime import registry
        from targetdiarization_tpu_torch.train import recipes, trainer

        stack = ExitStack()
        probe = self
        vag, apply, step = recipes._value_and_grad, recipes._apply, trainer.SeparationTrainer.train_step
        init, save = trainer.init_params, registry.save_checkpoint
        pending = {}

        def value_and_grad(loss_fn, params):
            out, grads = vag(loss_fn, params)
            pending["loss"] = out[0] if isinstance(out, tuple) else out
            return out, grads

        def apply_(*a, **k):
            out = apply(*a, **k)
            probe._end(pending.pop("loss"))
            return out

        def train_step(self_, batch):
            out = step(self_, batch)
            probe._end(out["loss"])
            return out

        def init_params(model, seed=0):
            sd = init(model, seed)
            probe.inits.append({k: v.clone() for k, v in sd.items()})
            return sd

        def save_checkpoint(path, model, model_name, model_args=None):
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            probe.saves.append({"path": path, "name": model_name, "state": state,
                                "devices": sorted({v.device.type for v in state.values()})})
            return save(path, model, model_name, model_args)

        for obj, name, value in ((recipes, "_value_and_grad", value_and_grad),
                                 (recipes, "_apply", apply_),
                                 (trainer.SeparationTrainer, "train_step", train_step),
                                 (trainer, "init_params", init_params),
                                 (registry, "save_checkpoint", save_checkpoint)):
            stack.enter_context(mock.patch.object(obj, name, value))
        return stack

    def per_step(self, start: dict) -> list[dict]:
        marks = [start] + self.launches
        return [{k: b[k] - a[k] for k in b} for a, b in zip(marks, marks[1:])]


def run_recipe(label: str, recipe: str, args: dict, root: str, device: str,
               plain: bool) -> dict:
    """One recipe run into `root`, probed; under `plain_kernels()` if `plain`."""
    from contextlib import nullcontext

    import torch

    from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
    from targetdiarization_tpu_torch.train import recipes

    probe = RecipeProbe(device)
    logs: list = []
    ckpt = os.path.join(root, label.replace(" ", "_").replace("/", "_") + ("_plain" if plain else ""))
    kwargs = dict(args)
    if recipe == "bootstrap_separator":
        from targetdiarization_tpu_torch.models.separation import MossFormer2

        kwargs["model"] = MossFormer2(**args["model"]) if "model" in args else None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = {**read_launches(), "dwconv_dx": dwconv.backward_launches}
    t0 = time.perf_counter()
    with probe.patches(), (plain_kernels() if plain else nullcontext()):
        metrics = getattr(recipes, recipe)(checkpoint_dir=ckpt, log_fn=logs.append,
                                           device=device, **kwargs)
    sync(device)
    return {"metrics": metrics, "logs": logs, "losses": probe.losses, "inits": probe.inits,
            "saves": probe.saves,
            "step_ms": [(b - a) * 1e3 for a, b in zip(probe.ends, probe.ends[1:])],
            "per_step": probe.per_step(start), "total_s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
            "launches": {**read_launches(), "dwconv_dx": dwconv.backward_launches},
            "checkpoint": ckpt}


def served_agreement(recipe: str, path: str, device: str) -> dict:
    """The recipe's checkpoint loaded through the registry and served by its
    engine in float32, the kernels against plain, with the limits the
    script uses for that engine: VAD probabilities within 1e-4, separated
    and restored audio at 40 dB, ASR texts and timestamps equal."""
    import torch

    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    def both(fn):
        got = fn()
        with plain_kernels():
            want = fn()
        return got, want

    clip = conversation(3.0, seed=43)
    if recipe == "bootstrap_vad":
        from targetdiarization_tpu_torch.models.vad import VADEngine

        eng = VADEngine(from_pretrained(path), device=device, compute_dtype="float32")
        got, want = both(lambda: eng.frame_probs(clip))
        err = float(np.abs(got - want).max())
        return {"engine": "VADEngine.frame_probs", "max_abs": err, "ok": err <= 1e-4}
    if recipe == "bootstrap_separator":
        from targetdiarization_tpu_torch.models.separation import SeparationEngine

        eng = SeparationEngine.from_pretrained(path, device=device, compute_dtype="float32")
        got, want = both(lambda: np.stack(eng.separate(clip)))
        db = min(si_sdr(got[i], want[i]) for i in range(len(want)))
        return {"engine": "SeparationEngine.separate", "min_si_sdr_db": db, "ok": db >= 40.0}
    if recipe == "bootstrap_restorer":
        from targetdiarization_tpu_torch.models.restoration import RestorationEngine

        eng = RestorationEngine(from_pretrained(path), device=device, compute_dtype="float32")
        got, want = both(lambda: eng.restore(clip))
        db = si_sdr(got, want)
        return {"engine": "RestorationEngine.restore", "si_sdr_db": db, "ok": db >= 40.0}
    from targetdiarization_tpu_torch.models.asr import ASREngine

    eng = ASREngine.from_pretrained(path, device=device, compute_dtype="float32")
    rng = np.random.default_rng(44)
    utts = [synth_utterance("".join(BOOT_CHARS[int(i)] for i in rng.integers(0, 32, n)), rng)[0]
            for n in (4, 7, 10)]
    got, want = both(lambda: [eng.asr_detection(u)[0] for u in utts])
    return {"engine": "ASREngine.asr_detection", "texts": [r["text"] for r in got],
            "ok": got == want}


def params_moved(run: dict) -> bool:
    """The checkpoint's parameters all finite, and some differ from the
    initial draw."""
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    saved = from_pretrained(run["checkpoint"]).state_dict()
    finite = all(bool(v.isfinite().all()) for v in saved.values())
    return finite and any(not np.array_equal(saved[k].numpy(), v.cpu().numpy())
                          for k, v in run["inits"][0].items())


def check_recipes(device: str = "cuda", runs: tuple = RECIPE_RUNS) -> dict:
    """The recipes phase: each recipe of `runs` on the device from the
    synthesized fixtures, with the kernels and then under `plain_kernels()`
    from the same seed: step 1's loss within 1e-4 (relative), step 5's within
    STEP5_RTOL for the dwconv-only recipes, every logged loss finite, the
    saved parameters moved, the launches a training step as
    `recipe_launches` predicts, a run with `aug_frac` scored through the
    preprocess chain (`preprocess_ran`), and the checkpoint served by its
    engine, kernels against plain. Returns the launches of the kernel runs."""
    import shutil
    import tempfile

    from targetdiarization_tpu_torch.train import recipes

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="td_recipes_")
    total: dict = {}
    try:
        recipes.ASSETS = recipe_fixtures(os.path.join(root, "assets"))
        for label, recipe, args, config in runs:
            args = dict(args)
            model_args = RECIPE_MODELS[config] if config else {}
            if recipe == "bootstrap_separator":
                args.setdefault("model", model_args or RECIPE_SEP_DEFAULT)
                model_args = args["model"]
            want = recipe_launches(recipe, {**model_args, **args})
            kern = run_recipe(label, recipe, args, root, device, plain=False)
            plain = run_recipe(label, recipe, args, root, device, plain=True)
            served = served_agreement(recipe, kern["checkpoint"], device)
            steps = args["steps"]
            step1 = abs(kern["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
            step5 = abs(kern["losses"][-1] - plain["losses"][-1]) / abs(plain["losses"][-1])
            logged = [float(x) for line in kern["logs"] if "loss=" in line
                      for x in [line.split("loss=")[1].split()[0]]]
            row = {"recipe": recipe, "label": label, "model": model_args, "steps": steps,
                   "batch": args["batch"], "seconds": args["seconds"],
                   "ms_per_step": statistics.median(kern["step_ms"]),  # steps 2 to the last
                   "step_ms": kern["step_ms"],
                   "plain_ms_per_step": statistics.median(plain["step_ms"]),
                   "peak_bytes": kern["peak_bytes"], "recipe_s": kern["total_s"],
                   "plain_recipe_s": plain["total_s"],
                   "launches_per_step": kern["per_step"][:steps], "predicted_per_step": want,
                   "losses": kern["losses"], "plain_losses": plain["losses"],
                   "step1_rel": step1, "step5_rel": step5, "metrics": kern["metrics"],
                   "plain_metrics": plain["metrics"], "served": served}
            emit("recipe", **row)
            fails = []
            if len(kern["losses"]) != steps or len(logged) != steps \
                    or not np.isfinite(kern["losses"] + plain["losses"] + logged).all():
                fails.append(f"losses {kern['losses']} (logged {logged}) not {steps} finite")
            if not step1 <= 1e-4:
                fails.append(f"step 1's loss {step1:.3g} from plain")
            if recipe != "bootstrap_separator" and not step5 <= STEP5_RTOL:
                fails.append(f"step {steps}'s loss {step5:.3g} from plain")
            if any(p != want for p in kern["per_step"][:steps]) or any(
                    any(p.values()) for p in plain["per_step"]):
                fails.append(f"launches a step {kern['per_step'][:steps]}, want {want}")
            if not params_moved(kern):
                fails.append("the saved parameters did not move or are not finite")
            if not preprocess_ran(args, kern["metrics"]):
                fails.append("no held-out CER through the preprocess chain")
            if not served["ok"]:
                fails.append(f"served kernels against plain: {served}")
            if fails:
                raise AssertionError(f"recipe {label}: " + "; ".join(fails))
            for k, v in kern["launches"].items():
                total[k] = total.get(k, 0) + v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("recipes_phase", phase_s=time.time() - t0, launches=total)
    return total


# ---------------- the bootstrap recipes whose models run no kernel ----------------

# the shipped checkpoints' configurations (their model.json), the models the
# runs below train: ERes2NetV2 is the "eres2netv2_large" preset (24 wide,
# blocks 2/2/2/2), the MOS nets the class defaults
RECIPE_PLAIN_MODELS = {
    "spk": dict(channels=24, blocks=[2, 2, 2, 2]), "campp": {}, "seg": {},
    "enh": dict(ch=48, sample_rate=16000), "mos": dict(n_out=3), "sigmos": dict(n_out=7),
    "den": dict(channels=8, depth=3, growth=4),
    "punc": dict(vocab_size=21001, dim=128, ffn=256, n_layers=2), "emo": {},
    "whisper": dict(vocab_size=21001, dim=128, heads=4, ffn=512, enc_layers=3, dec_layers=2),
}
# (label, recipe, its arguments, the checkpoint whose configuration it
# trains): full width, the recipes' batches and clip lengths, 3 steps.
# Cut: the step counts; the evals' `eval_utts` to 4; the MOS recipes' pools
# to 16 samples (240 and 512 by default); whisper's corpus to 32 and 16
# utterances (2000), once on the corpus alone and once with no corpus phase
# on fresh device batches (`phase1_steps=0`; a phase 1 of a step would not
# reach the fresh batches within 3 steps), a quarter of each through the
# preprocess chain on `checkpoints/den-bootstrap`
RECIPE_RUNS_PLAIN = (
    ("spk eres2netv2", "bootstrap_speaker",
     dict(steps=3, batch=16, seconds=2.0, model_name="eres2netv2_large"), "spk"),
    ("spk campp", "bootstrap_speaker", dict(steps=3, batch=16, seconds=2.0, model_name="campp"),
     "campp"),
    ("seg", "bootstrap_segmentation", dict(steps=3, batch=8, seconds=4.0), "seg"),
    ("enh", "bootstrap_enhancer", dict(steps=3, batch=8, seconds=2.0, ch=48), "enh"),
    ("mos", "bootstrap_mos", dict(steps=3, batch=8, pool=16), "mos"),
    ("sigmos", "bootstrap_sigmos", dict(steps=3, batch=16, pool=16), "sigmos"),
    ("den", "bootstrap_denoiser", dict(steps=3, batch=2), "den"),
    ("punc", "bootstrap_punc", dict(steps=3, batch=32, eval_utts=4), "punc"),
    ("emo", "bootstrap_emotion", dict(steps=3, batch=32, seconds=2.0, eval_utts=4), "emo"),
    ("whisper corpus", "bootstrap_whisper",
     dict(steps=3, batch=16, seconds=4.0, eval_utts=4, n_corpus=32), "whisper"),
    ("whisper device", "bootstrap_whisper",
     dict(steps=3, batch=16, seconds=4.0, eval_utts=4, n_corpus=16, device_synth=True,
          fresh_source="device", phase1_steps=0, aug_frac=0.25,
          denoiser_dir=os.path.join(ROOT, "checkpoints", "den-bootstrap")), "whisper"),
)
RELOAD_RTOL = 1e-6


def preprocess_ran(args: dict, metrics: dict) -> bool:
    """False where a run asked for the preprocess chain (`aug_frac` > 0) and
    its held-out CER through the chain is missing: `bootstrap_asr` and
    `bootstrap_whisper` leave the chain out without a word when the
    denoiser's checkpoint is not there."""
    return not args.get("aug_frac") or metrics.get("eval_cer_preprocessed") is not None


def plain_recipe_input(model, device: str) -> tuple:
    """One seeded input for a forward of `model` (a class a plain recipe
    saves), on `device`."""
    import torch

    from targetdiarization_tpu_torch.models import diarization, emotion, enhancement, speaker
    from targetdiarization_tpu_torch.models.denoise import DIM_F, DIM_T, TDFUNet
    from targetdiarization_tpu_torch.models.punctuation import CTTransformerPunc
    from targetdiarization_tpu_torch.models.whisper_style import WhisperStyleASR
    from targetdiarization_tpu_torch.train.mos import DNSMOSNet, SigMOSNet

    gen = torch.Generator().manual_seed(45)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    lengths = torch.tensor([200, 131], device=device)
    frames = (torch.arange(200, device=device)[None, :] < lengths[:, None]).float()
    if isinstance(model, (speaker.ERes2NetV2, speaker.CAMPlusPlus, diarization.SegmentationNet,
                          emotion.EmotionNet)):
        return 3 * randn(2, 200, 80), lengths
    if isinstance(model, enhancement.FlowEnhancer):
        return randn(2, 63, 257), torch.tensor([0.25, 0.75], device=device), randn(2, 63, 257).abs()
    if isinstance(model, DNSMOSNet):
        return (randn(1, 900, 120),)
    if isinstance(model, SigMOSNet):
        return (randn(1, 3, 67, 481),)
    if isinstance(model, TDFUNet):
        return (randn(1, 4, DIM_F, DIM_T),)
    ids = torch.randint(1, 21000, (2, 16), generator=gen).to(device)
    if isinstance(model, CTTransformerPunc):
        return ids, (torch.arange(16, device=device)[None, :] < torch.tensor(
            [[16], [9]], device=device)).float()
    if isinstance(model, WhisperStyleASR):
        return 3 * randn(2, 200, 80), frames, ids[:, :8]
    raise TypeError(f"no input for {type(model).__name__}")


def reload_saved(name: str, path: str, device: str):
    """A saved checkpoint loaded back as the port loads it: the MOS nets
    through their estimators, every other model through the registry that
    the engines' `from_pretrained` use."""
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained
    from targetdiarization_tpu_torch.train import mos

    if name == "DNSMOSNet":
        head = os.path.basename(path) == "p808"
        est = mos.MOSEstimator.from_pretrained(os.path.dirname(path) if head else path,
                                               device=device)
        return est.net808 if head else est.net
    if name == "SigMOSNet":
        return mos.SigMOSEstimator.from_pretrained(path, device=device).net
    return from_pretrained(path).to(device).eval()


def saved_agreement(run: dict, device: str) -> list[dict]:
    """Each checkpoint the run saved: where its tensors lay, whether its
    parameters (all finite) moved from the initial draw made in the same
    order, and the reloaded model's forward on one input against the same
    network holding the state as saved (max |difference| over max
    |output|)."""
    import copy

    import torch

    out = []
    for i, saved in enumerate(run["saves"]):
        model = reload_saved(saved["name"], saved["path"], device)
        state = model.state_dict()
        init = run["inits"][i] if i < len(run["inits"]) else {}
        finite = all(bool(v.float().isfinite().all()) for v in state.values())
        moved = any(not torch.equal(state[k].cpu(), v.cpu()) for k, v in init.items())
        as_saved = copy.deepcopy(model)
        as_saved.load_state_dict(saved["state"], strict=True)
        x = plain_recipe_input(model, device)
        with torch.no_grad():
            got, want = model(*x), as_saved(*x)
        err = float((got - want).abs().max() / torch.clamp_min(want.abs().max(), 1e-30))
        out.append({"name": saved["name"], "path": os.path.basename(saved["path"]),
                    "devices": saved["devices"], "finite": finite, "moved": moved,
                    "reload_rel_err": err})
    return out


def check_recipes_plain(device: str = "cuda", runs: tuple = RECIPE_RUNS_PLAIN) -> dict:
    """The plain recipes phase: each recipe of `runs` (the nine recipes of
    `train/recipes_plain.py`, the speaker one with ERes2NetV2 and CAM++, the
    whisper one on its corpus and on device batches) on the device from the
    synthesized fixtures. Holds, each failure loud: every parameter and
    buffer of each saved model on the device; every step's loss and every
    logged loss finite; the saved parameters finite and moved from the
    initial draw; no kernel launched; a run with `aug_frac` scored through
    the preprocess chain (`preprocess_ran`); each checkpoint reloaded (the
    registry, or the MOS estimators) giving the saved model's outputs within
    RELOAD_RTOL on one input. Prints each run's ms a step (median of steps 2
    to the last), peak memory and phase_s. Returns the launches (all 0)."""
    import shutil
    import tempfile

    from targetdiarization_tpu_torch.train import recipes

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="td_recipes_plain_")
    total: dict = {}
    try:
        recipes.ASSETS = recipe_fixtures(os.path.join(root, "assets"))
        for label, recipe, args, config in runs:
            run = run_recipe(label, recipe, args, root, device, plain=False)
            saved = saved_agreement(run, device)
            steps = args["steps"]
            logged = [float(x) for line in run["logs"] if "loss=" in line
                      for x in [line.split("loss=")[1].split()[0]]]
            row = {"recipe": recipe, "label": label, "model": RECIPE_PLAIN_MODELS.get(config),
                   "args": {k: v for k, v in args.items() if k != "denoiser_dir"},
                   "ms_per_step": statistics.median(run["step_ms"]) if run["step_ms"] else None,
                   "step_ms": run["step_ms"],
                   "peak_gb": None if run["peak_bytes"] is None else run["peak_bytes"] / 1e9,
                   "recipe_s": run["total_s"], "losses": run["losses"],
                   "launches": run["launches"], "saved": saved, "metrics": run["metrics"]}
            emit("recipe_plain", **row)
            fails = []
            if len(run["losses"]) != steps or not logged \
                    or not np.isfinite(run["losses"] + logged).all():
                fails.append(f"losses {run['losses']} (logged {logged}) not {steps} finite")
            if any(run["launches"].values()):
                fails.append(f"kernel launches {run['launches']}")
            if not saved:
                fails.append("no checkpoint saved")
            if not preprocess_ran(args, run["metrics"]):
                fails.append("no held-out CER through the preprocess chain")
            for s in saved:
                if s["devices"] != [device]:
                    fails.append(f"{s['path']}: tensors on {s['devices']}")
                if not (s["finite"] and s["moved"]):
                    fails.append(f"{s['path']}: parameters finite {s['finite']}, "
                                 f"moved {s['moved']}")
                if not s["reload_rel_err"] <= RELOAD_RTOL:
                    fails.append(f"{s['path']}: reloaded {s['reload_rel_err']:.3g} from saved")
            if fails:
                raise AssertionError(f"recipe {label}: " + "; ".join(fails))
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("recipes_plain_phase", phase_s=time.time() - t0, launches=total)
    return total


# ---------------- reference checkpoints: port_rules.py and onnx_io.py ----------------

REST_CHECKPOINT = os.path.join(ROOT, "checkpoints", "rest-bootstrap")
# (port class, checkpoint whose model.json gives the width, or None for the
# class defaults) of the separators converted from reference-layout dicts
PORT_RULES_MODELS = (("MossFormer2", CHECKPOINT), ("Apollo", REST_CHECKPOINT), ("ConvTasNet", None))
# (estimator, n_out, ch, input shape): DNSMOS's SIG/BAK/OVRL and P.808 nets
# on one 9.01 s mel (900 frames), SigMOS's on 200 frames, at the class widths
MOS_NETS = (("DNSMOSNet", 3, 32, (1, 900, 120)), ("DNSMOSNet", 1, 32, (1, 900, 120)),
            ("SigMOSNet", 7, 32, (1, 3, 200, 481)))
MOS_TOL = 2e-4  # |card - evaluate_onnx| <= MOS_TOL (1 + |evaluate_onnx|)


def port_rules_models() -> list:
    def args(path):
        if path is None:
            return {}
        with open(os.path.join(path, "model.json")) as f:
            return json.load(f)["model_args"]

    return [(name, args(path)) for name, path in PORT_RULES_MODELS]


def port_rules_separator(name: str, args: dict, wav, device: str) -> dict:
    """One architecture: a seeded reference-layout state dict, converted by
    `port_rules`, strict-loaded into the port class, placed, its kernels
    prepared; one float32 forward with the kernels (counted) and one under
    `plain_kernels()`. Returns the kernels' launches."""
    import torch

    from targetdiarization_tpu_torch.ops.kernels import prepare_kernels
    from targetdiarization_tpu_torch.runtime import port_rules
    from targetdiarization_tpu_torch.runtime.registry import get_model_cls
    from targetdiarization_tpu_torch.tools.reference_layout import reference_state_dict

    t = time.perf_counter()
    ref = reference_state_dict(name, args, seed=41)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    sd = port_rules.RULES[name](ref)
    convert_s = time.perf_counter() - t
    t = time.perf_counter()
    model = get_model_cls(name)(**args)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    prepare_kernels(model)
    sync(device)
    load_s = time.perf_counter() - t
    want = kernel_forward(model)

    def forward():
        with torch.inference_mode():
            out = model(wav)
        sync(device)
        return out.float().cpu().numpy()

    def timed():
        t = time.perf_counter()
        out = forward()
        return out, (time.perf_counter() - t) * 1e3

    forward()  # warm-up: the shapes' cuDNN and cuBLAS set-up
    reset_launches()
    kern, kern_ms = timed()
    launches = read_launches()
    with plain_kernels():
        forward()
        plain, plain_ms = timed()
    streams = list(zip(kern.reshape(-1, kern.shape[-1]), plain.reshape(-1, plain.shape[-1])))
    db = min(si_sdr(k, p) for k, p in streams)
    emit("port_rules_model", name=name, args=args or "class defaults",
         params=sum(p.numel() for p in model.parameters()), reference_keys=len(ref),
         build_s=build_s, convert_s=convert_s, load_prepare_s=load_s, audio_s=wav.shape[-1] / SR,
         out_shape=list(kern.shape), kernels_ms=kern_ms, plain_ms=plain_ms,
         launches=launches, predicted=want, f32_kernels_vs_f32_plain_db=db)
    fails = []
    if not (np.isfinite(kern).all() and np.isfinite(plain).all()) or kern.shape != plain.shape \
            or kern.shape[-1] != wav.shape[-1]:
        fails.append(f"outputs {kern.shape}, {plain.shape} not finite of the input's length")
    if launches != want or not any(want.values()):
        fails.append(f"launches {launches}, predicted {want}")
    if not db >= 40.0:
        fails.append(f"kernels against plain {db} dB < 40 dB")
    if fails:
        raise AssertionError(f"port_rules {name}: " + "; ".join(fails))
    return launches


def port_rules_mos(cls_name: str, n_out: int, ch: int, shape: tuple, seed: int,
                   device: str) -> None:
    """One MOS net from a synthetic graph in the released layout: written
    with `save_onnx`, read back with `load_onnx`, loaded by
    `onnx_to_state_dict`, scored on the device against `evaluate_onnx`."""
    import torch

    from targetdiarization_tpu_torch.runtime import onnx_io
    from targetdiarization_tpu_torch.tools import reference_layout
    from targetdiarization_tpu_torch.train import mos

    rng = np.random.default_rng(seed)
    build = reference_layout.dnsmos_graph if cls_name == "DNSMOSNet" \
        else reference_layout.sigmos_graph
    t = time.perf_counter()
    data = onnx_io.save_onnx(build(rng, ch=ch, n_out=n_out))
    graph = onnx_io.load_onnx(data)
    net = getattr(mos, cls_name)(n_out=n_out, ch=ch)
    onnx_io.onnx_to_state_dict(graph, net)
    net = net.to(device).eval()
    convert_s = time.perf_counter() - t
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    t = time.perf_counter()
    want = onnx_io.evaluate_onnx(graph, {"input_1": x[:, None] if len(shape) == 3 else x})
    want = want["output_1"]
    evaluate_s = time.perf_counter() - t
    inp = torch.from_numpy(x).to(device)

    def score():
        with torch.inference_mode():
            out = net(inp)
        sync(device)
        return out.cpu().numpy()

    score()  # warm-up
    t = time.perf_counter()
    got = score()
    ms = (time.perf_counter() - t) * 1e3
    err = float(np.abs(got - want).max())
    emit("port_rules_mos", net=cls_name, n_out=n_out, ch=ch, input=list(shape),
         onnx_bytes=len(data), convert_s=convert_s, evaluate_onnx_s=evaluate_s, ms=ms,
         max_abs_err=err, max_abs_out=float(np.abs(want).max()))
    if got.shape != want.shape or not np.all(np.abs(got - want) <= MOS_TOL * (1 + np.abs(want))):
        raise AssertionError(f"port_rules {cls_name}({n_out}): {got.shape} against "
                             f"evaluate_onnx {want.shape}, max |diff| {err}")


def check_port_rules(device: str = "cuda", models: list | None = None, seconds: float = 4.0,
                     mos_nets: tuple = MOS_NETS) -> dict:
    """The reference-checkpoint phase: the 512/24 MossFormer2, Apollo
    (`rest-bootstrap`'s width) and ConvTasNet (class defaults) from seeded
    reference-layout state dicts through `runtime/port_rules.py`, each one
    float32 forward on a two-voice mix with the kernels (launches held
    against the model's prediction) and under `plain_kernels()` (SI-SDR at
    least 40 dB); then the MOS nets from synthetic ONNX graphs through
    `runtime/onnx_io.py`, scored against `evaluate_onnx`. Returns the
    kernels' launches."""
    import torch

    t0 = time.time()
    wav = torch.from_numpy(two_voice_mix(seconds, seed=31))[None].to(device)
    totals = {k: 0 for k in read_launches()}
    for name, args in models if models is not None else port_rules_models():
        for k, v in port_rules_separator(name, args, wav, device).items():
            totals[k] += v
    for i, (cls_name, n_out, ch, shape) in enumerate(mos_nets):
        port_rules_mos(cls_name, n_out, ch, shape, 51 + i, device)
    emit("port_rules", phase_s=time.time() - t0, launches=totals)
    if not all(totals[k] > 0 for k in ("ffconvm", "flash_gated", "dwconv")):
        raise AssertionError(f"the converted models missed a kernel: {totals}")
    return totals


# ---------------- data parallelism: the mesh ----------------


def check_mesh(mesh=None, separator: str = CHECKPOINT) -> dict:
    """The mesh phase: tools/dryrun_multichip.py's four checks in float32
    with no TF32 on `mesh`, by default two slots of cuda:0 when one card is
    visible (the sharding, the row padding, the gradient reduction and the
    replicas' kernel operands, but no copies between cards) and every card
    (`make_mesh()`) when more are: `SeparationTrainer` on `separator` over
    the mesh (4 rows of 1 s a slot, 2 steps) against one slot on the whole
    batch (loss and grad norm within 1e-3, updates at cosine 0.9999),
    `SeparationEngine(mesh=).separate_batch` on 5 clips against one slot
    (relative 1e-5), the fused analyze on 4 rows at 32000 against the
    per-row analyze, the fused ASR on 4 tracks against the unsharded call
    (ids equal). Each check holds its sharded run's launches to the
    model's forwards on every shard (120 FFConvM, 24 gated FLASH and 48
    dwconv a 512/24 forward, 24 dx a step) and raises on a departure.
    Returns the sharded runs' launches."""
    import torch

    from targetdiarization_tpu_torch.parallel.mesh import Mesh, make_mesh
    from targetdiarization_tpu_torch.tools import dryrun_multichip as dry

    t0 = time.time()
    count = torch.cuda.device_count()
    if mesh is None:
        mesh = Mesh(["cuda:0", "cuda:0"]) if count == 1 else make_mesh()
    cards = len(set(mesh))
    emit("mesh_setup", visible_cards=count, slots=[str(d) for d in mesh],
         copies_between_cards=cards > 1,
         note=("two slots on one card: copies between cards not exercised" if cards == 1
               else f"{cards} cards: gradients reduced by torch.cuda.comm"))
    results = dry.run(mesh, separator=separator, emit=lambda r: emit("mesh", **r))
    mesh.close()
    totals = {"ffconvm": 0, "flash_gated": 0, "flash_group": 0, "dwconv": 0, "dwconv_dx": 0}
    for r in results:
        for k, v in r["launches"].items():
            totals[k] += v
    emit("mesh_phase", phase_s=time.time() - t0, launches=totals)
    return totals


def kernel_line(rows: dict, path_launches: dict) -> dict:
    """One entry per kernel, in the type the main path calls it in: the
    bf16 engine's promoted float32 stream, so ffconvm on float32
    activations with bf16-exact weights (two tensor-core passes) and
    flash_gated and the separator's dwconv in float32, each summed over one
    512/24 layer pair's calls at the 160k bucket (B 2, T 20224);
    flash_group, which no model calls, at the gated kernel's shape in bf16.
    The bound is that of the calls taken together (for ffconvm and FLASH
    the larger of their tensor-core passes, ffconvm's taps on the float32
    units and their bytes; `fma_bound_ms` is the same work on the float32
    units alone; dwconv's float32 FMA work or its bytes);
    `launches` sums the main-path runs of every slice, `launches_by_path`
    splits them; for dwconv `launches` also counts the dx launches of the
    training phase's backward (`dx_launches_by_path`), and `dx_shapes`
    holds its dx rows."""
    per_layer = {"to_hidden": 1, "to_qk": 1, "to_out": 1, "to_u": 2,  # to_v = to_u's shape
                 "separator conv0": 1, "separator conv1": 1}

    def entry(name, source, replaces, kind, weight, dtype, per, peak=None):
        sel = [(r, weight(r)) for r in rows[kind] if weight(r)]

        def total(key):
            return sum(r.get(key, 0.0) * w for r, w in sel)

        if peak is None:  # the design's bound, its parts summed
            ops_ms = max(total("tensor_core_ms"), total("taps_ms"))
            bound_ms = max(ops_ms, total("bytes_ms"))
            bound_by = "operations" if ops_ms >= total("bytes_ms") else "bytes"
            extra = {"fma_bound_ms": bound(total("flops"), total("bytes"), "float32")[0]}
        else:
            bound_ms, bound_by = bound(total("flops"), total("bytes"), peak)
            extra = {}
        library = [r["library_ms"] for r, _ in sel]
        by_path = {p: n[name] for p, n in path_launches.items()}
        dx = {p: n.get(f"{name}_dx", 0) for p, n in path_launches.items()}
        extra |= {"dx_launches_by_path": dx} if any(dx.values()) else {}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()) + sum(dx.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs_err"] for r, _ in sel),
                "ms": total("ms"), "device_ms": total("device_ms"),
                "plain_ms": total("plain_ms"), "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None if None in library else total("library_ms"),
                **extra, "dtype": dtype, "per": per}

    pair = "one 512/24 layer pair, B 2, T 20224"

    def shape_rows(prefix):
        return [{k: r[k] for k in ("shape", "dtype", "B", "T", "K", "C", "dilation",
                                   "max_abs_err", "rel_err", "ms", "device_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms", "library_device_ms")}
                for r in rows["dwconv"] if r["shape"].startswith(prefix)]

    apollo, sensevoice = shape_rows("Apollo"), shape_rows("SenseVoice")
    return {"kernels": [
        entry("ffconvm", "targetdiarization_tpu_torch/csrc/ffconvm.cu",
              "targetdiarization_tpu/ops/pallas/ffconvm.py:117", "ffconvm",
              lambda r: per_layer[r["shape"]] if r["variant"] == "main" else 0,
              "float32, bf16-exact weights", pair)
        | {"recipe_shapes": [{k: r[k] for k in ("shape", "dtype", "B", "T", "cin", "cout", "norm",
                                                 "max_abs_err", "rel_err", "ms", "device_ms",
                                                 "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}
                             for r in rows["ffconvm"] if r["shape"].startswith("recipe")]},
        entry("flash_gated", "targetdiarization_tpu_torch/csrc/flash_gated.cu",
              "targetdiarization_tpu/ops/pallas/flash.py:97", "flash_gated",
              lambda r: r["dtype"] == "float32" and r["shape"] == FLASH_SHAPES[0][0], "float32",
              pair)
        | {"recipe_shapes": [{k: r[k] for k in ("shape", "dtype", "B", "G", "g", "d", "e",
                                                 "max_abs_err", "rel_err", "ms", "device_ms",
                                                 "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}
                             for r in rows["flash_gated"] if r["shape"] != FLASH_SHAPES[0][0]]},
        entry("dwconv", "targetdiarization_tpu_torch/csrc/dwconv.cu",
              "targetdiarization_tpu/ops/pallas/dwconv.py:98", "dwconv",
              lambda r: per_layer.get(r["shape"], 0) if r["dtype"] == "float32" else 0,
              "float32", pair + " (FSMN conv0 + conv1; float32 FMA work)", "float32")
        | {"apollo_shapes": apollo, "sensevoice_shapes": sensevoice,
           "convtasnet_shapes": shape_rows("ConvTasNet"), "recipe_shapes": shape_rows("recipe"),
           "dx_shapes": [{k: r[k] for k in ("shape", "dtype", "B", "T", "K", "C", "dilation",
                                             "max_abs_err", "rel_err", "ms", "device_ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "library_device_ms")}
                         for r in rows["dwconv_dx"]]},
        entry("flash_group", "targetdiarization_tpu_torch/csrc/flash_gated.cu",
              "targetdiarization_tpu/ops/pallas/flash.py:205", "flash_group",
              lambda r: r["dtype"] == "bfloat16", "bfloat16",
              "B 2, G 79, g 256, d 128, e 1024 (public op; no model calls it)"),
    ]}


def main() -> None:
    torch = require_cuda()
    # float32 means float32 here: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = environment()
    build_report()
    check_host()
    rows = {"ffconvm": check_ffconvm(), "flash_gated": check_flash(),
            "dwconv": check_dwconv(), "flash_group": check_flash_group(),
            "flash_range": check_flash_range()}
    path_launches = {"separate_speaker": check_slice(), "ASRProcessor": check_asr(),
                     "FusedFrontend": check_frontend()}
    path_launches["TargetDiarization.infer"], path_launches["infer a under device_profile"] = \
        check_infer()
    path_launches |= {"TargetDiarizationStream.infer_stream": check_stream(),
                      "surface": check_surface(), "engines": check_engines(),
                      "zoo": check_zoo()}
    path_launches["train"], rows["dwconv_dx"] = check_train()
    path_launches["recipes"] = check_recipes()
    path_launches["recipes_plain"] = check_recipes_plain()
    path_launches["port_rules"] = check_port_rules()
    path_launches["mesh"] = check_mesh()
    print(json.dumps(kernel_line(rows, path_launches)), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)


if __name__ == "__main__":
    main()
