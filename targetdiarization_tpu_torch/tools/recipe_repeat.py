"""Run-to-run spread of the training recipes' step losses on the card.

chip_smoke.py's recipes phase holds each recipe's step losses with the
kernels against the same run under `plain_kernels()`. This tool shows
where a gap between the two comes from. For each of chip_smoke.py's
RECIPE_RUNS it runs the recipe from one seed with the kernels, plain, with
the kernels again and plain again, and prints each step's losses, the
spread within the kernel runs and within the plain runs (run-to-run
nondeterminism of the same code), and the kernel-plain gap. For every run
it also prints a checksum of each `features.fbank` input (the CMVN pass's
batches, then each step's audio) and, for the Paraformer, each forced
step's CIF token count against its characters (the CIF fires
floor(sum + 1e-6) tokens on the scaled alphas, a threshold that a last-bit
change of the alphas can cross). Then each recipe twice more with the
kernels under `torch.use_deterministic_algorithms(True, warn_only=True)`,
with the ops that warned (those without a deterministic CUDA path), and
the kernel-plain gap of each step over further seeds for the recipes
whose only kernel is dwconv. (The recipes themselves run with cuDNN's
deterministic algorithms: `train/recipes.py::_reproducible`.)

Run from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.recipe_repeat [--labels asr,vad] [--seeds 1,2,3]

With `--trace N` it runs each recipe N times with the kernels only, every
dwconv launch's input and output checksums recorded, and prints the first
launch whose output differs between the runs and whether its input did.

Each result is one JSON line on standard output and in
`chiprun_out/recipe_repeat.jsonl`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import warnings
from contextlib import ExitStack, contextmanager
from unittest import mock

DWCONV_ONLY = ("vad", "rest", "asr", "sv")


@contextmanager
def data_probe(record: dict):
    """Records each fbank input's checksum and each forced Paraformer
    forward's token counts into `record`."""
    import torch

    from ..models import asr, features

    fbank, forward = features.fbank, asr.Paraformer.forward

    def fbank_probe(audio, *a, **k):
        x = audio.detach().double()
        record["fbank_in"].append([float(x.sum()), float(x.abs().sum())])
        return fbank(audio, *a, **k)

    def forward_probe(self, feats, mask, target_len=None):
        out = forward(self, feats, mask, target_len)
        if target_len is not None and torch.is_grad_enabled():
            record["cif"].append({"n_tokens": out["n_tokens"].tolist(),
                                  "n_chars": target_len.int().tolist()})
        return out

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(features, "fbank", fbank_probe))
        stack.enter_context(mock.patch.object(asr.Paraformer, "forward", forward_probe))
        yield


@contextmanager
def deterministic(seen: list):
    """torch's deterministic algorithms (warnings only) and cuDNN's
    deterministic mode; the messages of the ops that warned go to `seen`."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was[0])
            torch.backends.cudnn.deterministic = was[1]
            seen.extend(sorted({str(w.message).split("\n")[0][:200] for w in caught
                                if "determinis" in str(w.message)}))


def one_run(label: str, recipe: str, args: dict, root: str, plain: bool, seed: int,
            det: list | None = None) -> dict:
    import chip_smoke

    record = {"fbank_in": [], "cif": []}
    with data_probe(record), (deterministic(det) if det is not None else ExitStack()):
        run = chip_smoke.run_recipe(label, recipe, {**args, "seed": seed}, root, "cuda", plain)
    shutil.rmtree(run["checkpoint"], ignore_errors=True)
    return {"losses": run["losses"], **record}


@contextmanager
def launch_probe(record: list):
    """Records each dwconv launch's input and output checksums (float64
    sum and sum of squares) and shapes into `record`."""
    from ..ops.kernels import dwconv as dwmod

    launch = dwmod._launch

    def probe(x, taps, *a):
        out = launch(x, taps, *a)
        xs, os_ = x.detach().double(), out.detach().double()
        record.append([list(x.shape), [float(xs.sum()), float(xs.square().sum())],
                       [float(os_.sum()), float(os_.square().sum())]])
        return out

    with mock.patch.object(dwmod, "_launch", probe):
        yield


def first_divergence(traces: list[list]) -> dict:
    """The first launch whose output differs between the runs, and whether
    its input differed too."""
    for i, calls in enumerate(zip(*traces)):
        if any(c[2] != calls[0][2] for c in calls):
            return {"launch": i, "of": len(traces[0]), "shape": calls[0][0],
                    "inputs_equal": all(c[1] == calls[0][1] for c in calls),
                    "outputs": [c[2] for c in calls]}
    return {"launch": None, "of": len(traces[0])}


def spread(runs: list[dict]) -> list[float]:
    """Each step's largest relative distance between the runs' losses."""
    return [(max(s) - min(s)) / abs(min(s)) for s in zip(*(r["losses"] for r in runs))]


def main() -> None:
    import chip_smoke

    parser = argparse.ArgumentParser()
    parser.add_argument("--labels", default=",".join(r[0] for r in chip_smoke.RECIPE_RUNS))
    parser.add_argument("--seeds", default="1,2,3")
    parser.add_argument("--trace", type=int, default=0,
                        help="only run each recipe this many times with the kernels, every "
                             "dwconv launch's checksums recorded, and print where they part")
    opts = parser.parse_args()
    labels = opts.labels.split(",")
    seeds = [int(s) for s in opts.seeds.split(",") if s]

    torch = chip_smoke.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = chip_smoke.environment()
    os.makedirs("chiprun_out", exist_ok=True)
    out = open(os.path.join("chiprun_out", "recipe_repeat.jsonl"), "w")

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    emit(kind="environment", nvidia_smi=env["nvidia_smi"], torch=env["torch"])
    from ..train import recipes

    root = tempfile.mkdtemp(prefix="td_recipe_repeat_")
    try:
        recipes.ASSETS = chip_smoke.recipe_fixtures(os.path.join(root, "assets"))
        for label, recipe, args, config in chip_smoke.RECIPE_RUNS:
            if label not in labels:
                continue
            args = dict(args)
            if recipe == "bootstrap_separator":
                args["model"] = (chip_smoke.RECIPE_MODELS[config] if config
                                 else chip_smoke.RECIPE_SEP_DEFAULT)
            if opts.trace:
                traces, losses = [], []
                for _ in range(opts.trace):
                    traces.append([])
                    with launch_probe(traces[-1]):
                        losses.append(one_run(label, recipe, args, root, False, 0)["losses"])
                emit(kind="trace", label=label, losses=losses,
                     first_divergence=first_divergence(traces))
                continue
            runs = [one_run(label, recipe, args, root, plain, 0)
                    for plain in (False, True, False, True)]
            kern, plain = runs[0::2], runs[1::2]
            emit(kind="repeat", label=label, seed=0, order="kernel, plain, kernel, plain",
                 losses=[r["losses"] for r in runs], kernel_spread=spread(kern),
                 plain_spread=spread(plain),
                 kernel_plain_gap=[spread([a, b]) for a, b in zip(kern, plain)],
                 fbank_in_equal=all(r["fbank_in"] == runs[0]["fbank_in"] for r in runs),
                 fbank_in=[r["fbank_in"] for r in runs],
                 cif=[r["cif"] for r in runs])
            det: list = []
            det_runs = [one_run(label, recipe, args, root, False, 0, det) for _ in range(2)]
            emit(kind="deterministic", label=label, seed=0, losses=[r["losses"] for r in det_runs],
                 spread=spread(det_runs), against_default=spread([det_runs[0], kern[0]]),
                 warned=sorted(set(det)), cif=[r["cif"] for r in det_runs])
            if label not in DWCONV_ONLY:
                continue
            for seed in seeds:
                pair = [one_run(label, recipe, args, root, plain, seed) for plain in (False, True)]
                emit(kind="seed", label=label, seed=seed, losses=[r["losses"] for r in pair],
                     kernel_plain_gap=spread(pair), cif=[r["cif"] for r in pair])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        out.close()


if __name__ == "__main__":
    main()
