#!/usr/bin/env python3
"""Card check of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, and drive `AudioProcessor.separate_speaker` on the
512/24 MossFormer2 (`checkpoints/sep-bootstrap-512`).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Each phase prints one JSON line with `elapsed_s` since the start. The line
before the last holds every kernel's launches, error and times; the last line
is `{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits nonzero and prints no result. It needs CUDA and the repository: with no
card, or with no port beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "sep-bootstrap-512")

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

FFCONVM_SHAPES = (  # (name, cin, cout, norm) at 512/24
    ("to_hidden", 512, 2048, "scalenorm"),
    ("to_qk", 512, 128, "scalenorm"),
    ("to_out", 1024, 512, "scalenorm"),
    ("to_u", 256, 256, "layernorm"),
)


def check_ffconvm(batch: int = 2, t: int = 20224) -> list[dict]:
    import torch

    from targetdiarization_tpu_torch.ops.kernels.ffconvm import TAPS, ffconvm, ffconvm_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, cin, cout, norm in FFCONVM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

            x = rnd(batch, t, cin)
            na = rnd(1, scale=0.3) + 1 if norm == "scalenorm" else rnd(cin, scale=0.1) + 1
            nb = torch.zeros(1, device="cuda", dtype=dtype) if norm == "scalenorm" \
                else rnd(cin, scale=0.1)
            w = rnd(cout, cin, scale=cin ** -0.5)
            b = rnd(cout, scale=0.1)
            dwk = rnd(TAPS, 1, cout, scale=0.2)
            args = (x, na, nb, w, b, dwk, norm)
            got = ffconvm(*args)
            want = ffconvm_plain(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            dname = str(dtype).split(".")[1]
            isz = x.element_size()
            flops = 2.0 * batch * t * cout * (cin + TAPS + 1)
            nbytes = isz * (batch * t * (cin + cout) + cin * cout + cout * (TAPS + 1) + 2 * cin)
            bound_ms, bound_by = bound(flops, nbytes, dname)
            row = {"shape": name, "dtype": dname, "B": batch, "T": t, "cin": cin,
                   "cout": cout, "norm": norm, "flops": flops, "bytes": nbytes,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": time_ms(lambda: ffconvm(*args)),
                   "plain_ms": time_ms(lambda: ffconvm_plain(*args), iters=5),
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            emit("ffconvm", **row)
            if not rel <= TOL[dname]:
                raise AssertionError(f"ffconvm {name} {dname}: kernel vs plain rel err "
                                     f"{rel:.3g} > {TOL[dname]}")
            rows.append(row)
            del x, w, got, want
    return rows


def check_flash(batch: int = 2, n_groups: int = 79, g: int = 256, d: int = 128,
                e: int = 1024, masked_tail: int = 225) -> list[dict]:
    import torch

    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_gated_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = rnd(batch, n_groups, g, d, scale=4.0), rnd(batch, n_groups, g, d, scale=4.0)
        lq = rnd(batch, n_groups, g, d)
        v, u = rnd(batch, n_groups, g, e), rnd(batch, n_groups, g, e)
        mask = torch.ones(batch, n_groups, 1, g, device="cuda", dtype=dtype)
        mask[:, -1, :, g - masked_tail:] = 0  # a 160k window: 19999 of 20224 frames valid
        kv, ku = rnd(batch, d, e, scale=0.1), rnd(batch, d, e, scale=0.1)
        args = (q, k, v, u, mask, lq, kv, ku)
        got = flash_gated(*args)
        want = flash_gated_plain(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        dname = str(dtype).split(".")[1]
        isz = q.element_size()
        bg = batch * n_groups
        flops = 2.0 * bg * g * (g * d + 2 * (g + d) * e) + 6.0 * bg * g * e
        nbytes = isz * (bg * g * (3 * d + 3 * e + 1) + 2 * batch * d * e)
        bound_ms, bound_by = bound(flops, nbytes, dname)
        row = {"dtype": dname, "B": batch, "G": n_groups, "g": g, "d": d, "e": e,
               "masked_tail": masked_tail, "flops": flops, "bytes": nbytes,
               "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(lambda: flash_gated(*args)),
               "plain_ms": time_ms(lambda: flash_gated_plain(*args), iters=5),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        emit("flash_gated", **row)
        if not rel <= TOL[dname]:
            raise AssertionError(f"flash_gated {dname}: kernel vs plain rel err "
                                 f"{rel:.3g} > {TOL[dname]}")
        rows.append(row)
        del args, q, k, lq, v, u, got, want
    return rows


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


def check_slice() -> dict:
    import torch
    from unittest import mock

    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm, ffconvm_plain
    from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_gated_plain
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    clips = {"12s": two_voice_mix(12.0, seed=0), "3s": two_voice_mix(3.0, seed=1)}
    t = time.time()
    ap = AudioProcessor(CHECKPOINT, device="cuda")
    if not ap.is_separate_speaker or ap.separator.compute_dtype != torch.bfloat16:
        raise AssertionError("the 512/24 separator did not load in bfloat16 on the card")
    layers = len(ap.separator.model.mask_net.layers)
    emit("load", checkpoint=os.path.relpath(CHECKPOINT, ROOT), layers=layers,
         load_s=time.time() - t)
    ap.separate_speaker(clips["3s"][:SR], SR)  # warm-up: cuBLAS and cuDNN set-up

    # the main path, counted: one forward per call (the 12 s clip is two
    # 160k windows in one batch, the 3 s clip one 64k bucket)
    ffconvm.launches = 0
    flash_gated.launches = 0
    main = run_clips(ap, clips, "bf16 kernels")
    launches = {"ffconvm": ffconvm.launches, "flash_gated": flash_gated.launches}
    forwards = len(clips)
    want = {"ffconvm": 5 * layers * forwards, "flash_gated": layers * forwards}
    emit("launches", forwards=forwards, **launches)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on the main path, want {want}")

    ap32 = AudioProcessor(CHECKPOINT, device="cuda", compute_dtype="float32")
    kern32 = run_clips(ap32, clips, "f32 kernels")
    with mock.patch.object(separation, "ffconvm", ffconvm_plain), \
            mock.patch.object(separation, "flash_gated", flash_gated_plain):
        plain32 = run_clips(ap32, clips, "f32 plain")
    for name in clips:
        f32 = [si_sdr(kern32[name][s], plain32[name][s]) for s in range(2)]
        bf16 = [si_sdr(main[name][s], plain32[name][s]) for s in range(2)]
        emit("agreement", clip=name, si_sdr_f32_kernels_vs_plain=f32,
             si_sdr_bf16_kernels_vs_f32_plain=bf16)
        if min(f32) < 40.0:
            raise AssertionError(f"{name}: f32 kernel path vs plain SI-SDR {f32} < 40 dB")
        if min(bf16) < 10.0:
            raise AssertionError(f"{name}: bf16 kernel path vs f32 plain SI-SDR {bf16} < 10 dB")
    return launches


def kernel_line(ff_rows: list, fl_rows: list, launches: dict) -> dict:
    """One entry per kernel: bf16 (the main path's type) at the 160k bucket's
    shapes (B 2, T 20224), summed over one layer pair's calls; the bound is
    that of the layer's calls taken together."""
    per_layer = {"to_hidden": 1, "to_qk": 1, "to_out": 1, "to_u": 2}  # to_v = to_u's shape

    def entry(name, source, replaces, rows, weights):
        bf = [(r, weights(r)) for r in rows if r["dtype"] == "bfloat16"]
        bound_ms, bound_by = bound(sum(r["flops"] * w for r, w in bf),
                                   sum(r["bytes"] * w for r, w in bf), "bfloat16")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] * w for r, w in bf),
                "plain_ms": sum(r["plain_ms"] * w for r, w in bf),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "dtype": "bfloat16", "per": "one layer pair, B 2, T 20224"}

    return {"kernels": [
        entry("ffconvm", "targetdiarization_tpu_torch/csrc/ffconvm.cu",
              "targetdiarization_tpu/ops/pallas/ffconvm.py:117", ff_rows,
              lambda r: per_layer[r["shape"]]),
        entry("flash_gated", "targetdiarization_tpu_torch/csrc/flash_gated.cu",
              "targetdiarization_tpu/ops/pallas/flash.py:97", fl_rows, lambda r: 1),
    ]}


def main() -> None:
    torch = require_cuda()
    # float32 means float32 here: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = environment()
    ff_rows = check_ffconvm()
    fl_rows = check_flash()
    launches = check_slice()
    print(json.dumps(kernel_line(ff_rows, fl_rows, launches)), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)


if __name__ == "__main__":
    main()
