"""Shared pieces of the recipe tests (`tests/test_torch_recipes_*.py`).

Both packages' recipes read `chat_mix.wav` and `female_a.wav` from their
module's `ASSETS`; `fixture_dir` writes two synthesized voices (the port's
`train/synth.py`, the second voice played 1.25 x faster, as chip_smoke.py's
`voice_b`) under those names, and `run_both` points both packages at them.

`run_both` runs the JAX recipe, then the port's from the same initial
parameters: the JAX `Module.init` is wrapped to keep what the recipe drew
(or `jax_init` gives it), and the port's seeded draw
(`train/trainer.py::init_params`) is patched to return it converted. It
records every step's loss unrounded in both packages: in the JAX step
through a `jax.debug.callback` on `jax.value_and_grad`'s loss, in the
port through `recipes._value_and_grad` (the separator: `train_step`).
"""

from __future__ import annotations

import contextlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import asr as jasr
from targetdiarization_tpu.models import features as jfeatures
from targetdiarization_tpu.train import recipes as jrecipes
from targetdiarization_tpu_torch.models import asr as tasr
from targetdiarization_tpu_torch.models import features as tfeatures
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.train import recipes as trecipes
from targetdiarization_tpu_torch.train import synth
from targetdiarization_tpu_torch.train import trainer as ttrainer
from targetdiarization_tpu_torch.utils.audio_io import write_wav

SR = 16000
LOSS_RTOL = 1e-4
FORWARD_RTOL = 1e-4


def _voice(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out, n = [], int(seconds * SR)
    while sum(map(len, out)) < n:
        audio, _ = synth.synth_utterance(synth.random_text(rng, 2, 10), rng)
        out += [audio, np.zeros(int(0.2 * SR), np.float32)]
    return np.concatenate(out)[:n]


def _voice_b(audio: np.ndarray) -> np.ndarray:
    return np.interp(np.arange(0, len(audio), 1.25), np.arange(len(audio)),
                     audio).astype(np.float32)


def fixture_dir(root: str, chat_seconds: float = 4.8) -> str:
    """`chat_mix.wav` (the second voice over the first, `chat_seconds`) and
    `female_a.wav` (the first voice alone, 4 s) under `root`."""
    os.makedirs(root, exist_ok=True)
    write_wav(os.path.join(root, "female_a.wav"), _voice(4.0, 1), SR)
    mix = _voice_b(_voice(1.25 * chat_seconds, 2)) + _voice(chat_seconds, 3)
    write_wav(os.path.join(root, "chat_mix.wav"), 0.5 * mix, SR)
    return root


@contextlib.contextmanager
def _jax_losses(mp, losses: list):
    orig = jax.value_and_grad

    def value_and_grad(fun, *args, **kwargs):
        inner = orig(fun, *args, **kwargs)

        def call(*a, **k):
            out = inner(*a, **k)
            loss = out[0][0] if kwargs.get("has_aux") else out[0]
            jax.debug.callback(lambda v: losses.append(float(v)), loss)
            return out

        return call

    mp.setattr(jax, "value_and_grad", value_and_grad)
    yield


def _capture_init(mp, cls, store: dict):
    """`cls.init` kept in `store` as numpy (every call's tree in
    `store["all"]`, in order), and run under jit (the same draws; an eager
    flax init of a model with Pallas kernels in interpret mode takes tens of
    seconds)."""
    orig = cls.init

    def init(self, *args, **kwargs):
        tree = jax.jit(lambda *a: orig(self, *a, **kwargs))(*args)
        store["params"] = jax.tree_util.tree_map(np.asarray, tree)
        store.setdefault("all", []).append(store["params"])
        return tree

    mp.setattr(cls, "init", init)


def _floor_fbank(mp, floor: float) -> None:
    """Both packages' fbank floored at log-energy `floor`. The synthesized
    language has no energy above about 7 kHz; there the mel energies are
    the float32 FFT's rounding noise (about 0.4 in int16 units), which
    differs between XLA's FFT and PyTorch's, so the top bands' log-mel
    differs by up to 0.17 while every band with signal agrees exactly
    (the port's fbank is held against JAX's in tests/test_torch_asr.py)."""
    orig_j, orig_t = jfeatures.fbank, tfeatures.fbank
    mp.setattr(jfeatures, "fbank", lambda *a, **k: jnp.maximum(orig_j(*a, **k), floor))
    mp.setattr(tfeatures, "fbank", lambda *a, **k: torch.clamp_min(orig_t(*a, **k), floor))


def _record_cif_counts(mp, counts: dict) -> None:
    """Each package's CIF token counts, call by call (`cif_fire`'s n_tokens)."""
    orig_j, orig_t = jasr.cif_fire, tasr.cif_fire

    def jax_cif(*args, **kwargs):
        out = orig_j(*args, **kwargs)
        jax.debug.callback(lambda n: counts["jax"].append(np.asarray(n).tolist()), out[3])
        return out

    def port_cif(hidden, alphas, *args, **kwargs):
        out = orig_t(hidden, alphas, *args, **kwargs)
        counts["port"].append(out[2].tolist())
        # with target_len the alphas sum to it within float32 rounding
        counts["targets"].append(torch.round(alphas.sum(dim=1)).int().tolist())
        return out

    mp.setattr(jasr, "cif_fire", jax_cif)
    mp.setattr(tasr, "cif_fire", port_cif)


def run_both(tmp: str, assets: str, name: str, jax_kwargs: dict, port_kwargs: dict,
             jax_cls=None, jax_init=None, fbank_floor: float | None = None,
             patches: tuple = ()) -> dict:
    """The JAX recipe `name` and the port's, from one initial parameter tree
    (`jax_cls.init`'s draw in the recipe, or `jax_init()`; the port's k-th
    seeded draw takes the k-th `jax_cls.init`, and with neither, the
    recipes load theirs), each writing its checkpoint under `tmp`; with `fbank_floor`, both packages' fbank
    floored there (`_floor_fbank`); `patches`, (object, name, value)
    triples, hold for both runs. Returns both runs' metrics, log lines,
    exact step losses and checkpoint paths, CIF token counts, and the
    initial tree."""
    out = {"jax": {"log": [], "losses": []}, "port": {"log": [], "losses": []},
           "cif_counts": {"jax": [], "port": [], "targets": []}}
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_cif_counts(mp, out["cif_counts"])
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        mp.setattr(jrecipes, "ASSETS", assets)
        mp.setattr(trecipes, "ASSETS", assets)
        if fbank_floor is not None:
            _floor_fbank(mp, fbank_floor)
        if jax_cls is not None:
            _capture_init(mp, jax_cls, store)
        with _jax_losses(mp, out["jax"]["losses"]), jax.default_matmul_precision("highest"):
            path = os.path.join(tmp, "jax")
            out["jax"]["metrics"] = getattr(jrecipes, name)(
                checkpoint_dir=path, log_fn=out["jax"]["log"].append, **jax_kwargs)
            out["jax"]["path"] = path
        inits = store["all"] if jax_cls is not None else [jax_init()] if jax_init else []
        out["init"], out["inits"] = (inits[0] if inits else None), inits
        drawn = []

        def port_init(model, seed=0):
            tree = inits[min(len(drawn), len(inits) - 1)]
            drawn.append(seed)
            return CONVERTERS[type(model).__name__](tree)

        if inits:
            mp.setattr(ttrainer, "init_params", port_init)
        orig_vg = trecipes._value_and_grad

        def value_and_grad(loss_fn, params):
            got, grads = orig_vg(loss_fn, params)
            out["port"]["losses"].append(float(got[0] if isinstance(got, tuple) else got))
            return got, grads

        mp.setattr(trecipes, "_value_and_grad", value_and_grad)
        orig_step = ttrainer.SeparationTrainer.train_step

        def train_step(self, batch):
            m = orig_step(self, batch)
            out["port"]["losses"].append(float(m["loss"]))
            return m

        mp.setattr(ttrainer.SeparationTrainer, "train_step", train_step)
        torch.manual_seed(0)
        path = os.path.join(tmp, "port")
        out["port"]["metrics"] = getattr(trecipes, name)(
            checkpoint_dir=path, log_fn=out["port"]["log"].append, device="cpu", **port_kwargs)
        out["port"]["path"] = path
    return out


_NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def check_logs_and_losses(run: dict, steps: int, cif: bool = False,
                          rtol: float = LOSS_RTOL) -> None:
    """The same log lines but for their numbers, and every step's loss
    within LOSS_RTOL of JAX's. For a Paraformer recipe (`cif`), each step's
    CIF runs with target_len, the characters' counts, and both packages
    must fire exactly that many tokens: the scaled alphas sum to the target
    within a few float32 ulps, and n_tokens = floor(sum + 1e-6) drops the
    last token where the sum lands two ulps short, which XLA's fused sum
    under jit does on some batches (eagerly, and in the port, it does not).
    Such a JAX step trains on another target, so the run is not comparable;
    the tests' seeds give batches where it does not happen."""
    jl, pl = run["jax"]["log"], run["port"]["log"]
    assert len(jl) == len(pl), (jl, pl)
    for a, b in zip(jl, pl):
        assert _NUMBER.sub("#", a.split(":")[0]) == _NUMBER.sub("#", b.split(":")[0]), (a, b)
    want, got = run["jax"]["losses"], run["port"]["losses"]
    assert len(want) == len(got) == steps, (want, got)
    if cif:
        counts = run["cif_counts"]
        # the JAX run's first calls are its model.init's
        jax_counts = counts["jax"][len(counts["jax"]) - len(counts["port"]):]
        for i in range(steps):
            assert counts["port"][i] == jax_counts[i] == counts["targets"][i], (i, counts)
    for w, g in zip(want, got):
        assert abs(g - w) <= rtol * abs(w), (want, got)


def saved_state(path: str, name: str) -> dict:
    """A checkpoint's parameters as the port's state dict (either layer
    layout: the JAX recipes save the scan layout, the port the per-layer
    one)."""
    with np.load(os.path.join(path, "params.npz")) as z:
        return CONVERTERS[name](unflatten({k: z[k] for k in z.files}))


# attention key biases and the attentive statistics pool's score bias (the
# softmax is invariant to one shift of all of a query's scores), and
# ERes2NetV2's AFF gate_down bias (its GroupNorm has one channel a group,
# whose mean it subtracts): their gradient is zero in exact arithmetic, so
# Adam moves them by its normalization of rounding noise, about the
# learning rate either way in either package
NOISE_LEAVES = re.compile(
    r"(attn(\.\d+)?\.(k|key)\.bias|asp\.att_v\.bias|aff\.gate_down\.bias)$")


def check_saved_params(run: dict, name: str, init_tree: dict | None = None) -> float:
    """Both checkpoints hold the same parameters, and each leaf's change
    over the steps agrees with JAX's within 10 % of its norm. (Not element
    by element: Adam's first steps move a weight by about the learning rate
    whatever its gradient's size, so a weight whose gradient is rounding
    noise moves either way in either package; FsmnVADNet's step-1 gradient
    at flax's initialization agrees between the packages to about 2e-3 of
    its largest element, on the same features.) Leaves in NOISE_LEAVES are
    held only to the largest change of the others. `init_tree` is the
    initial tree where it is not the run's first draw. Returns that change."""
    got, want = saved_state(run["port"]["path"], name), saved_state(run["jax"]["path"], name)
    init = CONVERTERS[name](run["init"] if init_tree is None else init_tree)
    assert sorted(got) == sorted(want) == sorted(init)
    moved = max(float((want[k] - init[k]).abs().max()) for k in want
                if not NOISE_LEAVES.search(k))
    assert moved > 0
    for k in want:
        assert got[k].shape == want[k].shape, k
        if NOISE_LEAVES.search(k):
            assert float((got[k] - init[k]).abs().max()) <= moved, k
            continue
        change = float((want[k] - init[k]).double().norm())
        assert float((got[k] - want[k]).double().norm()) <= 0.1 * change, k
    return moved


def check_metrics(run: dict, limits: dict) -> None:
    """Each metric within its absolute limit of JAX's (None where JAX's is
    None); `final_loss` within LOSS_RTOL."""
    want, got = run["jax"]["metrics"], run["port"]["metrics"]
    assert set(got) == set(want)
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_RTOL * abs(want["final_loss"])
    for key, limit in limits.items():
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert abs(got[key] - want[key]) <= limit, (key, got[key], want[key])
