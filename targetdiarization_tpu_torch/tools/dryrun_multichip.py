"""Data parallelism over a mesh, each sharded program against one slot.

Counterpart of `dryrun_multichip` in the JAX package's __graft_entry__.py:
the same four checks, here on a mesh of `parallel/mesh.py`, each printing
one JSON line:

- `train`: `SeparationTrainer` over the mesh (rows_per_slot rows a slot)
  against one slot stepping on the same shards one after the other, and
  against one slot on the whole batch, the same batches from the same
  weights: each step's loss and gradient norm, the cosines of the
  parameter updates and of the parameters after;
- `inference`: `SeparationEngine(mesh=).separate_batch` on 5 clips (the
  batcher's row rung of 8, padded to a multiple of the mesh size) against
  the single-slot engine, on the same shards and on the whole rung;
- `analyze`: `FusedFrontend.build_analyze_sharded` on 4 rows against
  `_analyze_device` of each row;
- `asr`: `FusedASR.build_sharded` on 4 speaker tracks against the unsharded
  `_device` (ids, token counts and punctuation classes equal).

Each check also counts the kernel launches of its sharded run and holds
them against the model's prediction (`forward_launches` on every shard)
and raises on a departure past its limit. Everything runs in float32.

On the card, from the repository root (the shipped checkpoints; a mesh of
all visible cards, or `--slots cuda:0,cuda:0` for two slots on one card):

    python3 -m targetdiarization_tpu_torch.tools.dryrun_multichip --slots cuda:0,cuda:0
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("ffconvm", "flash_gated", "dwconv", "dwconv_dx")
# the training check's limits: loss and gradient norm relative, the
# parameter updates' cosine
TRAIN_LIMITS = dict(loss=1e-3, grad_norm=1e-3, update_cosine=0.9999)
INFERENCE_RTOL = 1e-5
WHOLE_RTOL = 1e-4  # __graft_entry__.py's dry run: 1e-4 of the output's scale


def checkpoint(name: str) -> str:
    return os.path.join(REPO, "checkpoints", name)


def launches() -> dict:
    """The kernel wrappers' launch counters now (dwconv's dx as `dwconv_dx`)."""
    from ..ops.kernels.dwconv import dwconv
    from ..ops.kernels.ffconvm import ffconvm
    from ..ops.kernels.flash import flash_gated

    return {"ffconvm": ffconvm.launches, "flash_gated": flash_gated.launches,
            "dwconv": dwconv.launches, "dwconv_dx": dwconv.backward_launches}


def counted(fn):
    """(fn(), the kernel launches it made)."""
    before = launches()
    out = fn()
    return out, {k: v - before[k] for k, v in launches().items()}


def forward_launches(model, backward: bool = False) -> dict:
    """The launches of one forward of `model` (after `prepare_kernels`): an
    FFConvM launch per FFConvM module, a gated FLASH per FlashBlock, a
    dwconv per depthwise memory (the separator's FSMN convs, the VAD's and
    the Paraformer's memories). With `backward`, also dwconv's dx launches
    of its backward: one per FSMN conv of one input group (m = 1)."""
    from ..models.separation import FFConvM, FlashBlock

    mods = list(model.modules())
    dw = sum(len(getattr(m, "conv_taps", None) or ())
             + int(getattr(m, "memory_taps", None) is not None)
             + int(getattr(m, "fsmn_taps", None) is not None) for m in mods)
    dx = sum(int(k.shape[1] == 1) for m in mods for k in getattr(m, "conv_kernels", ()))
    return {"ffconvm": sum(isinstance(m, FFConvM) for m in mods),
            "flash_gated": sum(isinstance(m, FlashBlock) for m in mods),
            "dwconv": dw, "dwconv_dx": dx if backward else 0}


def times(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def plus(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def _expect(name: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{name}: kernel launches {got}, the model predicts {want}")


def _sync(mesh) -> None:
    import torch

    for dev in dict.fromkeys(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _timed(mesh, fn):
    _sync(mesh)
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, (time.perf_counter() - t0) * 1e3


def voices(rows: int, n: int, seed: int) -> np.ndarray:
    """(rows, n) float32 mixes of two synthesized utterances, the second
    quieter and later."""
    from ..train.synth import random_text, synth_utterance

    rng = np.random.default_rng(seed)
    out = np.zeros((rows, n), np.float32)
    for r in range(rows):
        for gain, start in ((0.5, 0), (0.3, n // 4)):
            utt = synth_utterance(random_text(rng, 8, 14), rng)[0][: n - start]
            out[r, start:start + len(utt)] += gain * utt
    return out


# ---------------- the four checks ----------------


def _cosine(a, b) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def _train_runs(mesh, load_model, batches: list, rows_per_slot: int) -> dict:
    """`train_check`'s three runs: `whole` and `shards` on one slot, `mesh`."""
    import torch

    from ..parallel.mesh import Mesh
    from ..train import SeparationTrainer, TrainConfig

    one = Mesh(mesh[:1])
    same_card = Mesh(mesh[:1] * len(mesh))  # reduce_mean's sums on one card

    def accumulated(trainer, batch):
        parts = [trainer.loss_and_grads({k: v[i * rows_per_slot:(i + 1) * rows_per_slot]
                                         for k, v in batch.items()}) for i in range(len(mesh))]
        return trainer.apply_gradients(torch.stack([loss for loss, _ in parts]).mean(),
                                       same_card.reduce_mean([g for _, g in parts]))

    runs = {}
    for label, slots in (("whole", one), ("shards", one), ("mesh", mesh)):
        model = load_model()
        trainer = SeparationTrainer(model, params=model.state_dict(), cfg=TrainConfig(
            learning_rate=5e-4, save_every=0), mesh=slots)
        per_step = forward_launches(trainer.model, backward=True)
        init = torch.cat([p.detach().reshape(-1).double() for p in trainer.params.values()])

        def fit():
            if label != "shards":
                return trainer.fit(batches, log_every=1, log_fn=lambda _: None)
            return [{k: float(v) for k, v in accumulated(trainer, b).items()} for b in batches]

        (history, ms), counts = counted(lambda: _timed(slots, fit))
        after = torch.cat([p.detach().reshape(-1).double() for p in trainer.params.values()])
        runs[label] = {"history": history, "ms": ms, "launches": counts, "after": after,
                       "update": after - init, "per_step": per_step}
        del trainer, model, init
    return runs


def train_check(mesh, load_model, rows_per_slot: int = 4, seconds: float = 1.0,
                steps: int = 2, limits: dict = TRAIN_LIMITS) -> dict:
    """`SeparationTrainer` over `mesh` on `steps` batches of `len(mesh) *
    rows_per_slot` mixes of `seconds`, from the weights `load_model()`
    gives, against two runs on one slot (`mesh[0]`) from the same weights:
    `shards`, which steps on the mean of the same shards' losses and
    gradients taken one after the other, held to `limits` (each step's
    loss and gradient norm, the cosine of the parameter updates); and
    `whole`, which steps on the whole batch, held to `limits` in step 1's
    loss and in the updated parameters' cosine, its other gaps recorded. A
    float32 gradient of a deep separator parts by more than the limits
    when its batch is split (the GEMMs' sums run in another order at
    another row count, and the model magnifies it), so only `shards` holds
    the mesh itself to them."""
    import torch

    from ..train.data import DynamicMixDataset, MixConfig

    n = int(seconds * 16000)
    pools = {"a": list(voices(3, 2 * n, 1)), "b": list(voices(3, 2 * n, 2))}
    batches = list(DynamicMixDataset(pools, MixConfig(segment_seconds=seconds),
                                     seed=0).batches(len(mesh) * rows_per_slot, steps))
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same run twice, as the recipes run
    try:
        runs = _train_runs(mesh, load_model, batches, rows_per_slot)
    finally:
        torch.backends.cudnn.deterministic = cudnn_was
    multi = runs["mesh"]

    def gaps(ref):
        steps_ = [{"loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                   "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]}
                  for a, b in zip(multi["history"], ref["history"])]
        return {"steps": steps_, "update_cosine": _cosine(multi["update"], ref["update"]),
                "param_cosine": _cosine(multi["after"], ref["after"])}

    against = {label: gaps(runs[label]) for label in ("shards", "whole")}
    out = {"check": "train", "slots": [str(d) for d in mesh], "rows_per_slot": rows_per_slot,
           "seconds": seconds, "steps": steps, "losses": [h["loss"] for h in multi["history"]],
           "vs_shards": against["shards"], "vs_whole": against["whole"], "ms": multi["ms"],
           "whole_ms": runs["whole"]["ms"], "shards_ms": runs["shards"]["ms"],
           "launches": multi["launches"], "want": times(multi["per_step"], steps * len(mesh))}
    _expect("train", multi["launches"], out["want"])
    shards, whole = against["shards"], against["whole"]
    if not (all(g["loss_rel"] <= limits["loss"] and g["grad_norm_rel"] <= limits["grad_norm"]
                for g in shards["steps"]) and shards["update_cosine"] >= limits["update_cosine"]
            and whole["steps"][0]["loss_rel"] <= limits["loss"]
            and whole["param_cosine"] >= limits["update_cosine"]):
        raise AssertionError(f"train: the mesh departs from one slot: {against} (limits {limits})")
    return out


def inference_check(mesh, load_model, clips: int = 5, seconds: float = 4.0,
                    rtol: float = INFERENCE_RTOL, whole_rtol: float = WHOLE_RTOL) -> dict:
    """`SeparationEngine(mesh=).separate_batch` on `clips` clips of
    `seconds` (the batcher's rung of rows, padded to a multiple of the mesh
    size, split over the slots) against the single-slot engine: the
    forward of those rows against the single slot's forwards of the same
    shards in turn within `rtol`, and the separated clips against the
    single engine's `separate_batch` (its one forward of the whole rung)
    within `whole_rtol`, the JAX package's dry-run tolerance: a float32
    forward of a deep separator moves with the rows beside a row (the
    GEMMs' sums at another row count)."""
    from ..models.separation import SeparationEngine
    from ..parallel.mesh import batch_sharding

    def rel(got, want):
        return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                   for g, w in zip(got, want))

    audio = list(voices(clips, int(seconds * 16000), 3))
    single = SeparationEngine(load_model(), device=mesh[0], compute_dtype="float32")
    single.separate_batch(audio)  # each engine's first call is not timed
    want, single_ms = _timed(mesh, lambda: single.separate_batch(audio))
    engine = SeparationEngine(load_model(), compute_dtype="float32", mesh=mesh)
    engine.separate_batch(audio)
    (got, ms), counts = counted(lambda: _timed(mesh, lambda: engine.separate_batch(audio)))
    rows = next(r for r in engine.ROW_LADDER if r >= clips)  # the batcher's rung
    batch, lengths = engine._pad_rows(np.stack(audio), np.full(clips, len(audio[0])), rows)
    shards = np.concatenate([single._forward(batch[r], lengths[r])
                             for _, r in batch_sharding(mesh, len(batch))])
    out = {"check": "inference", "slots": [str(d) for d in mesh], "clips": clips,
           "seconds": seconds, "forward_rows": len(batch),
           "rel_err_vs_shards": rel(engine._forward(batch, lengths), shards),
           "rel_err_vs_whole": rel(got, want), "ms": ms, "single_ms": single_ms,
           "launches": counts, "want": times(forward_launches(engine.model), len(mesh))}
    _expect("inference", counts, out["want"])
    if not (out["rel_err_vs_shards"] <= rtol and out["rel_err_vs_whole"] <= whole_rtol):
        raise AssertionError(f"inference: the mesh departs from one slot: {out} (limits {rtol} "
                             f"against the shards, {whole_rtol} against the whole rung)")
    return out


def analyze_check(mesh, engines: dict, rows: int = 4, bucket: int = 32000,
                  rtol: float = INFERENCE_RTOL) -> dict:
    """`FusedFrontend.build_analyze_sharded` on `rows` rows at `bucket`
    against `_analyze_device` of each row; `engines`: den (or None), vad,
    seg (or None) and spk engines on slot 0."""
    import torch

    from ..pipeline.fused import FusedFrontend

    fe = FusedFrontend(engines.get("den"), engines["vad"], engines.get("seg"), engines["spk"])
    audio = voices(rows, bucket, 4)
    a_i16 = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    n_valid = np.array([bucket - 3000 * i for i in range(rows)], np.int64)
    with torch.inference_mode():
        rows_dev = torch.from_numpy(a_i16).to(mesh[0])

        def per_row():
            return [fe._analyze_device(rows_dev[i], int(n_valid[i]), bucket) for i in range(rows)]

        per_row()  # the first calls are not timed
        want, single_ms = _timed(mesh, per_row)
    sharded = fe.build_analyze_sharded(bucket, mesh)
    sharded(a_i16, n_valid)
    (got, ms), counts = counted(lambda: _timed(mesh, lambda: sharded(a_i16, n_valid)))
    errs = {}
    for k in got:
        g = got[k].cpu().double()
        w = torch.stack([r[k] for r in want]).cpu().double()
        errs[k] = float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
    per_row = plus(*(forward_launches(e.model) for e in engines.values() if e is not None))
    out = {"check": "analyze", "slots": [str(d) for d in mesh], "rows": rows, "bucket": bucket,
           "rel_err": errs, "audio_i16_max_diff": float(
               (got["audio_i16"].cpu().int() - torch.stack([r["audio_i16"] for r in want])
                .cpu().int()).abs().max()),
           "ms": ms, "single_ms": single_ms, "launches": counts, "want": times(per_row, rows)}
    _expect("analyze", counts, out["want"])
    floats = {k: e for k, e in errs.items() if k != "audio_i16"}
    if not (all(e <= rtol for e in floats.values()) and out["audio_i16_max_diff"] <= 1):
        raise AssertionError(f"analyze: the mesh departs from the per-row analyze: {out}")
    return out


def asr_check(mesh, asr, punc, tracks: int = 4, bucket: int = 32000, max_segs: int = 2) -> dict:
    """`FusedASR.build_sharded` on `tracks` speaker tracks of one synthesized
    utterance's audio against the unsharded `_device`: ids, token counts,
    fire frames and punctuation classes equal."""
    import torch

    from ..models import features
    from ..models.asr import LFR_N
    from ..pipeline.fused import FusedASR
    from ..runtime.precision import exact_float32

    fasr = FusedASR(asr, punc)
    audio = np.clip(voices(1, bucket, 5)[0] * 32768.0, -32768, 32767).astype(np.int16)
    ranges = np.zeros((tracks, max_segs, 2), np.float32)
    for i in range(tracks):
        ranges[i, 0] = (i * 1000.0, bucket - i * 1000.0)
    n_lfr = np.full(tracks, max(-(-features.num_frames(bucket) // LFR_N), 1), np.int64)
    with torch.inference_mode(), exact_float32():
        def unsharded():
            return fasr._device(*(torch.from_numpy(a).to(mesh[0]) for a in (audio, ranges, n_lfr)))

        unsharded()  # the first calls are not timed
        want, single_ms = _timed(mesh, unsharded)
    sharded = fasr.build_sharded(bucket, tracks, max_segs, mesh)
    sharded(audio, ranges, n_lfr)
    (got, ms), counts = counted(lambda: _timed(mesh, lambda: sharded(audio, ranges, n_lfr)))
    equal = {k: bool(torch.equal(got[k].cpu(), want[k].cpu())) for k in want}
    per_shard = plus(forward_launches(asr.model),
                     *([forward_launches(fasr.punc.model)] if fasr.punc is not None else []))
    out = {"check": "asr", "slots": [str(d) for d in mesh], "tracks": tracks, "bucket": bucket,
           "equal": equal, "n_tokens": got["n_tokens"].cpu().tolist(), "ms": ms,
           "single_ms": single_ms, "launches": counts, "want": times(per_shard, len(mesh))}
    _expect("asr", counts, out["want"])
    if not all(equal.values()):
        raise AssertionError(f"asr: the mesh's outputs differ from the unsharded call: {equal}")
    return out


def run(mesh, separator: str = checkpoint("sep-bootstrap-512"), emit=print) -> list:
    """The four checks on `mesh`, in float32: training and inference on the
    separator checkpoint under `separator`, the analyze and the ASR on the
    shipped den-, vad-, seg-, spk-, asr- and punc-bootstrap. Each result is
    passed to `emit`; returns them."""
    from ..models.asr import ASREngine
    from ..models.denoise import DenoiseEngine
    from ..models.diarization import SegmentationEngine
    from ..models.punctuation import PunctuationEngine
    from ..models.speaker import SpeakerEngine
    from ..models.vad import VADEngine
    from ..runtime.registry import from_pretrained

    def load_separator():
        return from_pretrained(separator)

    dev, f32 = mesh[0], "float32"
    results = [train_check(mesh, load_separator)]
    emit(results[-1])
    results.append(inference_check(mesh, load_separator))
    emit(results[-1])
    engines = {"den": DenoiseEngine.from_pretrained(checkpoint("den-bootstrap"), device=dev,
                                                    compute_dtype=f32),
               "vad": VADEngine.from_pretrained(checkpoint("vad-bootstrap"), device=dev,
                                                compute_dtype=f32),
               "seg": SegmentationEngine.from_pretrained(checkpoint("seg-bootstrap"),
                                                         device=dev, compute_dtype=f32),
               "spk": SpeakerEngine.from_pretrained(checkpoint("spk-bootstrap"), device=dev,
                                                    compute_dtype=f32)}
    results.append(analyze_check(mesh, engines))
    emit(results[-1])
    asr = ASREngine.from_pretrained(checkpoint("asr-bootstrap"), device=dev, compute_dtype=f32)
    punc = PunctuationEngine.from_pretrained(checkpoint("punc-bootstrap"), device=dev,
                                             compute_dtype=f32)
    results.append(asr_check(mesh, asr, punc))
    emit(results[-1])
    return results


def main() -> None:
    import torch

    from ..parallel.mesh import Mesh, make_mesh

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slots", default="",
                        help="the mesh's slots, comma-separated (default: every visible card)")
    args = parser.parse_args()
    mesh = Mesh(args.slots.split(",")) if args.slots else make_mesh()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run(mesh, emit=lambda r: print(json.dumps(r), flush=True))
    mesh.close()


if __name__ == "__main__":
    main()
