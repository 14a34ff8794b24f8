"""The port's training stack against the JAX package's, on the CPU.

Losses (values and `jax.grad`), the twelve optimizers and the two
schedules (against optax), the dynamic-mixing data, the metrics and the
trainer: the JAX test's small MossFormer2 from one parameter tree in both
packages (`runtime/convert.py`), 3 steps compared, a small ConvTasNet, the
save and restore round trip and the inference export read by the other
package. Inputs are seeded numpy arrays or the port's synthesized speech.
The JAX side runs at full float32 matmul precision.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from targetdiarization_tpu.models import zoo as jzoo
from targetdiarization_tpu.models.separation import MossFormer2 as JaxMossFormer2
from targetdiarization_tpu.parallel.mesh import replicated
from targetdiarization_tpu.runtime.params import upgrade_scan_layout
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import SeparationTrainer as JaxTrainer
from targetdiarization_tpu.train import TrainConfig as JaxConfig
from targetdiarization_tpu.train import data as jdata
from targetdiarization_tpu.train import eval_metrics as jeval
from targetdiarization_tpu.train import losses as jlosses
from targetdiarization_tpu.train import metrics as jmetrics
from targetdiarization_tpu.train import optim as joptim
from targetdiarization_tpu.train import perceptual as jperceptual
from targetdiarization_tpu_torch.models import zoo as tzoo
from targetdiarization_tpu_torch.models.separation import MossFormer2
from targetdiarization_tpu_torch.runtime.convert import (INVERSE_CONVERTERS,
                                                         mossformer2_state_dict, zoo_state_dict)
from targetdiarization_tpu_torch.runtime.params import tree_leaves, unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import SeparationTrainer, TrainConfig
from targetdiarization_tpu_torch.train import data as tdata
from targetdiarization_tpu_torch.train import eval_metrics as teval
from targetdiarization_tpu_torch.train import losses as tlosses
from targetdiarization_tpu_torch.train import metrics as tmetrics
from targetdiarization_tpu_torch.train import optim as toptim
from targetdiarization_tpu_torch.train import perceptual as tperceptual
from targetdiarization_tpu_torch.train import synth
from targetdiarization_tpu_torch.train.trainer import init_params

SMALL = dict(dim=16, enc_channels=16, num_blocks=1, group_size=32, qk_dim=16, kernel_size=8,
             fsmn_inner=8)  # tests/test_train.py's MossFormer2
SECONDS = 0.1
BATCH = 4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------- losses ----------------


def _pair(seed, shape=(3, 2, 800)):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal(shape).astype(np.float32)
    est = (ref[:, ::-1] * 0.7 + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return est, ref


@pytest.mark.parametrize("name", ["si_sdr", "sd_sdr", "snr", "pairwise_neg_si_sdr",
                                  "freq_mae_wav_l1", "pit_si_sdr_loss", "mixit_loss"])
def test_loss_values_and_gradients_match_jax(name):
    est, ref = _pair(1)
    if name == "mixit_loss":
        est = np.concatenate([est, est[:, :1] * 0.5], axis=1)  # 3 sources, 2 mixtures
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)

    def jtotal(e):
        return jnp.sum(jfn(e, jnp.asarray(ref)))

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(est), jnp.asarray(ref)))
        want_grad = np.asarray(jax.jit(jax.grad(jtotal))(jnp.asarray(est)))
    e = _t(est).requires_grad_()
    got = tfn(e, _t(ref))
    got.sum().backward()
    assert got.shape == want.shape
    assert _rel(got.detach(), want) <= 1e-5
    assert _rel(e.grad, want_grad) <= 1e-4


@pytest.mark.parametrize("s", [2, 3, 5])
def test_pit_methods_match_jax(s):
    """Factorial and Hungarian pick the JAX package's permutation and loss;
    the Hungarian loss's gradient goes through the chosen entries, as the
    factorial path's does."""
    rng = np.random.default_rng(40 + s)
    mat = rng.standard_normal((4, s, s)).astype(np.float32)
    methods = ("factorial", "hungarian", "auto") if s <= 4 else ("hungarian", "auto")
    for method in methods:
        jl, jp = jlosses.pit_loss(jnp.asarray(mat), method)
        tl, tp = tlosses.pit_loss(_t(mat), method)
        assert _rel(tl, jl) <= 1e-6 and np.array_equal(tp.numpy(), np.asarray(jp))
    if s <= 4:
        m1, m2 = _t(mat).requires_grad_(), _t(mat).requires_grad_()
        tlosses.pit_loss(m1, "factorial")[0].sum().backward()
        tlosses.pit_loss(m2, "hungarian")[0].sum().backward()
        jg = jax.grad(lambda m: jnp.sum(jlosses.pit_loss(m, "factorial")[0]))(jnp.asarray(mat))
        assert _rel(m1.grad, jg) <= 1e-6 and _rel(m2.grad, jg) <= 1e-6


# ---------------- optimizers ----------------

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "lamb", "lars", "adabelief",
              "radam", "yogi", "novograd", "lion")


def _optimizer_run(make_j, make_t, seed):
    rng = np.random.default_rng(seed)
    shapes = [(8, 5), (5,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 2.0).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jopt, topt = make_j(), make_t()
    jp = {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}
    jstate = jopt.init(jp)
    tp = [_t(p) for p in params]
    tstate = topt.init(tp)
    errs = []
    for g in grads:
        jg = {f"p{i}": jnp.asarray(x) for i, x in enumerate(g)}
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = topt.update([_t(x) for x in g], tstate, tp)
        toptim.apply_updates(tp, tu)
        errs.append(max(_rel(t, jp[f"p{i}"]) for i, t in enumerate(tp)))
    return errs, [sum(float(np.sum(x * x)) for x in g) ** 0.5 for g in grads]


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, clip):
    """3 steps of each optimizer, with the trainer's global-norm clipping
    below the gradients' norms (every step clipped) or above them (none),
    give optax's parameters within 1e-6 of their largest magnitude."""
    grad_clip = 2.0 if clip == "clipped" else 1e4
    errs, norms = _optimizer_run(
        lambda: joptim.make_optimizer(name, 1e-2, 0.0, grad_clip),
        lambda: toptim.make_optimizer(name, 1e-2, 0.0, grad_clip), seed=OPTIMIZERS.index(name))
    assert all((n > grad_clip) == (clip == "clipped") for n in norms)
    assert max(errs) <= 1e-6, errs


@pytest.mark.parametrize("name,kwargs", [
    ("adamw", {"weight_decay": 0.05}), ("lamb", {"weight_decay": 0.05}),
    ("lion", {"weight_decay": 0.05}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"centered": True, "momentum": 0.5, "bias_correction": True}),
    ("adam", {"nesterov": True}),
])
def test_optimizer_options_match_optax(name, kwargs):
    wd = kwargs.pop("weight_decay", 0.0)
    errs, _ = _optimizer_run(lambda: joptim.make_optimizer(name, 1e-2, wd, 0.0, **kwargs),
                             lambda: toptim.make_optimizer(name, 1e-2, wd, 0.0, **kwargs), 99)
    assert max(errs) <= 1e-6, errs


def test_schedules_match_optax():
    for d_model, warmup in ((64, 10), (512, 4000)):
        js, ts = joptim.dptnet_schedule(d_model, warmup, 2.0), toptim.dptnet_schedule(
            d_model, warmup, 2.0)
        for step in (0, 1, 5, 9, 10, 11, 3999, 4000, 12345):
            assert abs(ts(step) - float(js(step))) <= 1e-6 * abs(float(js(step)))
    js, ts = joptim.halving_exponential(1e-3, 10), toptim.halving_exponential(1e-3, 10)
    for step in (0, 1, 9, 10, 19, 20, 25, 100):
        assert abs(ts(step) - float(js(step))) <= 1e-6 * float(js(step))
    # a schedule as the learning rate, counted by the optimizer
    errs, _ = _optimizer_run(
        lambda: joptim.make_optimizer("adam", joptim.halving_exponential(1e-2, 2), 0.0, 0.0),
        lambda: toptim.make_optimizer("adam", toptim.halving_exponential(1e-2, 2), 0.0, 0.0), 7)
    assert max(errs) <= 1e-6
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("adamax")


# ---------------- data ----------------


def _speakers(seed=3):
    rng = np.random.default_rng(seed)
    return {name: [synth.synth_utterance(synth.random_text(rng, 3, 6), rng)[0]
                   for _ in range(2)] for name in ("a", "b", "c")}


@pytest.mark.parametrize("noise", [False, True])
def test_dynamic_mix_draws_equal_jax(noise):
    files = _speakers()
    kw = dict(segment_seconds=0.5, add_noise=noise)
    got = list(tdata.DynamicMixDataset(files, tdata.MixConfig(**kw), seed=5).batches(3, 2))
    want = list(jdata.DynamicMixDataset(files, jdata.MixConfig(**kw), seed=5).batches(3, 2))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------- metrics ----------------


def _clean_and_noisy(seed=11):
    rng = np.random.default_rng(seed)
    clean = synth.synth_utterance("天地人日月水火", rng)[0]
    noisy = (clean + 0.05 * rng.standard_normal(len(clean))).astype(np.float32)
    return clean, np.roll(noisy, 37)


def test_separation_metrics_equal_jax():
    clean, noisy = _clean_and_noisy()
    est = np.stack([noisy, clean * 0.5])
    ref = np.stack([clean, clean[::-1].copy()])
    mix = clean + noisy
    for fn in ("sdr", "si_snr"):
        assert abs(getattr(tmetrics, fn)(est, ref) - getattr(jmetrics, fn)(est, ref)) <= 1e-4
    for fn in ("si_snr_i", "sdr_i"):
        assert abs(getattr(tmetrics, fn)(est, ref, mix) - getattr(jmetrics, fn)(est, ref, mix)) \
            <= 1e-4
    assert abs(tmetrics.stoi_proxy(noisy, clean) - jmetrics.stoi_proxy(noisy, clean)) <= 1e-5
    assert tperceptual.stoi(clean, noisy) == jperceptual.stoi(clean, noisy)
    for mode in ("wb", "nb"):
        assert tperceptual.pesq(clean, noisy, mode=mode) == jperceptual.pesq(clean, noisy,
                                                                            mode=mode)
    assert tperceptual.estimate_delay(clean, noisy, 16000) == \
        jperceptual.estimate_delay(clean, noisy, 16000)


def test_metrics_tracker_rows_equal_jax(tmp_path):
    """Rows, summary and CSV, with duck-typed ASR and MOS hooks."""
    class ASR:
        def asr_detection(self, audio, sr):
            return [{"text": f"{len(audio)}"}]

    class MOS:
        def __call__(self, audio, sr):
            return {"OVRL": 3.1, "SIG": 3.2, "BAK": 3.3, "P808_MOS": float(np.abs(audio).max())}

    class SigMOS:
        def run(self, audio, sr=16000):
            return {k: 2.5 + 0.1 * i for i, k in enumerate(
                ("MOS_COL", "MOS_DISC", "MOS_LOUD", "MOS_NOISE", "MOS_REVERB", "MOS_SIG"))} | {
                "MOS_OVRL": float(audio.mean())}

    clean, noisy = _clean_and_noisy(12)
    rows = []
    for mod, path in ((tmetrics, tmp_path / "t.csv"), (jmetrics, tmp_path / "j.csv")):
        tr = mod.MetricsTracker(str(path), asr_engine=ASR(), mos_estimator=MOS(),
                                sigmos_estimator=SigMOS())
        tr.update("utt1", noisy, clean, clean + noisy)
        tr.update("utt2", clean * 0.9, clean, noisy)
        tr.write_csv()
        rows.append((tr.rows, tr.summary(), path.read_text()))
    (trows, tsum, tcsv), (jrows, jsum, jcsv) = rows
    assert tsum.keys() == jsum.keys() and trows[0].keys() == jrows[0].keys()
    for a, b in zip(trows, jrows):
        for k in a:
            assert a[k] == b[k] or abs(a[k] - b[k]) <= 1.5e-3, (k, a[k], b[k])
    assert tcsv.splitlines()[0] == jcsv.splitlines()[0]


def test_der_cer_wer_equal_jax():
    ref = {"A": [(0.0, 2.0), (5.0, 7.5)], "B": [(1.5, 4.0)]}
    hyps = [{"x": [(0.1, 2.2), (5.0, 7.0)], "y": [(1.4, 4.3)], "z": [(8.0, 9.0)]},
            {"x": [(0.0, 9.0)]}, {}, ref]
    for hyp in hyps:
        for collar in (0.0, 0.25):
            assert teval.der(ref, hyp, collar) == jeval.der(ref, hyp, collar)
    assert teval.der({}, {}) == jeval.der({}, {})
    pairs = [("天地人日月", "天地大日月水"), ("", "人"), ("上 下", "上下"), ("abc", "")]
    for r, h in pairs:
        assert teval.cer(r, h) == jeval.cer(r, h)
    for r, h in [("the cat sat", "the bat sat down"), ("a b", ""), ("", "")]:
        assert teval.wer(r, h) == jeval.wer(r, h)


# ---------------- the trainer ----------------


def _train_files(seed=0, n=32000):
    rng = np.random.default_rng(seed)
    return {"a": [(rng.standard_normal(n) * 0.3).astype(np.float32)],
            "b": [(np.sin(np.linspace(0, 700, n)) * 0.3).astype(np.float32)]}


def _jax_tree(state_dict: dict, name: str):
    """A port state dict as the JAX package's parameter tree (the JAX
    loader's layout)."""
    flat = INVERSE_CONVERTERS[name](state_dict)
    return upgrade_scan_layout(name, unflatten({k: jnp.asarray(v) for k, v in flat.items()}))


def _jax_trainer(model, params):
    """The JAX trainer on one device, its state placed as its step's jit
    places it (replicated), so that the step compiles once, not again for
    the second step's committed state."""
    trainer = JaxTrainer(model, params=params, cfg=JaxConfig(
        learning_rate=1e-3, save_every=0, n_devices=1), example_seconds=SECONDS)
    trainer.state = jax.device_put(trainer.state, replicated(trainer.mesh))
    return trainer


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer, built once: the small MossFormer2 from the port's
    seeded draw (one parameter tree for both packages), 3 steps on the
    JAX test's data; the losses, grad norms and parameters after."""
    params = init_params(MossFormer2(**SMALL), seed=0)
    batches = list(jdata.DynamicMixDataset(_train_files(), jdata.MixConfig(
        segment_seconds=SECONDS), seed=0).batches(BATCH, 3))
    with jax.default_matmul_precision("highest"):
        trainer = _jax_trainer(JaxMossFormer2(**SMALL), _jax_tree(params, "MossFormer2"))
        history = trainer.fit(batches, log_every=1, log_fn=lambda *_: None)
    after = mossformer2_state_dict(jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    return {"init": params, "history": history, "after": after, "trainer": trainer}


def _port_trainer(params=None, **cfg):
    return SeparationTrainer(MossFormer2(**SMALL), params=params,
                             cfg=TrainConfig(save_every=0, **cfg), example_seconds=SECONDS,
                             device="cpu")


def _heldout(seed=9):
    return next(tdata.DynamicMixDataset(_train_files(seed), tdata.MixConfig(
        segment_seconds=SECONDS), seed=seed).batches(BATCH, 1))


def test_trainer_steps_match_jax(jax_run):
    """3 steps from one parameter tree: losses and grad norms within 1e-4;
    the parameters after them give the same loss on held-out data within
    1e-4, and each differs from JAX's by under 10 % of the largest change
    the steps made (Adam divides by sqrt(v): a parameter whose gradient is
    rounding noise, as the FSMN bias before its instance norm is, moves by
    about the learning rate either way in both packages)."""
    torch.set_num_threads(2)
    trainer = _port_trainer(jax_run["init"], learning_rate=1e-3)
    batches = list(tdata.DynamicMixDataset(_train_files(), tdata.MixConfig(
        segment_seconds=SECONDS), seed=0).batches(BATCH, 3))
    history = trainer.fit(batches, log_every=1, log_fn=lambda *_: None)
    for got, want in zip(history, jax_run["history"]):
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    after, init = jax_run["after"], jax_run["init"]
    moved = max(float((after[k] - init[k]).abs().max()) for k in after)
    assert 0 < moved
    for k, p in trainer.params.items():
        assert float((p.detach() - after[k]).abs().max()) <= 0.1 * moved, k
    held = _heldout()
    ref = _port_trainer(after)
    assert abs(trainer.evaluate([held]) - ref.evaluate([held])) <= 1e-4 * abs(
        ref.evaluate([held]))


def test_export_loads_in_both_packages(jax_run, tmp_path):
    """The port's export through the JAX `from_pretrained`, and the JAX
    trainer's export through the port's, give the exporter's output."""
    torch.set_num_threads(2)
    wav = np.random.default_rng(4).standard_normal((2, 1600)).astype(np.float32) * 0.3
    trainer = _port_trainer(jax_run["after"])
    path = trainer.export_inference_checkpoint(str(tmp_path / "port"))
    model, params = jax_from_pretrained(path)
    apply = jax.jit(model.apply)  # one program for both packages' exports (same model)
    with jax.default_matmul_precision("highest"):
        jax_out = np.asarray(apply(params, jnp.asarray(wav)))
    with torch.no_grad():
        port_out = trainer.model(_t(wav)).numpy()
    assert _rel(jax_out, port_out) <= 1e-4
    jpath = jax_run["trainer"].export_inference_checkpoint(str(tmp_path / "jax"))
    with torch.no_grad():
        loaded = from_pretrained(jpath)(_t(wav)).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(apply(jax_run["trainer"].state["params"], jnp.asarray(wav)))
    assert _rel(loaded, want) <= 1e-4
    with open(os.path.join(path, "model.json")) as f:
        assert json.load(f)["model_args"] == {**SMALL, "num_spks": 2, "sample_rate": 16000,
                                              "scan_unroll": 0}


def test_save_restore_round_trip(tmp_path):
    torch.set_num_threads(2)
    ck = str(tmp_path / "ck")
    trainer = _port_trainer(checkpoint_dir=ck)
    ds = tdata.DynamicMixDataset(_train_files(1, 16000), tdata.MixConfig(
        segment_seconds=SECONDS), seed=0)
    trainer.fit(ds.batches(BATCH, 2), log_every=100, log_fn=lambda *_: None)
    trainer.save()
    other = _port_trainer(checkpoint_dir=ck)  # same seed draw, then restored
    with torch.no_grad():
        for p in other.params.values():
            p.add_(1.0)
    assert other.restore() == 2
    for k, p in trainer.params.items():
        assert torch.equal(p, other.params[k]), k
    for a, b in zip(tree_leaves(trainer.state["opt"]), tree_leaves(other.state["opt"])):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    with open(os.path.join(ck, "trainer.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["model_name"] == "MossFormer2"
    # one more step from the restored state equals one more from the original
    batch = _heldout(3)
    trainer.fit([batch], log_every=100, log_fn=lambda *_: None)
    other.fit([batch], log_every=100, log_fn=lambda *_: None)
    for k, p in trainer.params.items():
        assert torch.equal(p, other.params[k]), k
    wrong = SeparationTrainer(MossFormer2(**{**SMALL, "num_blocks": 2}),
                              cfg=TrainConfig(save_every=0, checkpoint_dir=ck), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        wrong.restore()


def test_convtasnet_step_matches_jax():
    """One step of a small ConvTasNet (dwconv's dilated taps in the
    backward) from one parameter tree: loss, grad norm and the held-out
    loss after the step."""
    torch.set_num_threads(2)
    args = dict(enc_channels=32, bottleneck=16, hidden=32, n_blocks=3, n_repeats=1)
    params = init_params(tzoo.ConvTasNet(**args), seed=2)
    batch = _heldout(5)
    with jax.default_matmul_precision("highest"):
        jt = _jax_trainer(jzoo.ConvTasNet(**args), _jax_tree(params, "ConvTasNet"))
        want = jt.fit([batch], log_every=1, log_fn=lambda *_: None)[0]
    tt = SeparationTrainer(tzoo.ConvTasNet(**args), params=params,
                           cfg=TrainConfig(learning_rate=1e-3, save_every=0), device="cpu")
    got = tt.fit([batch], log_every=1, log_fn=lambda *_: None)[0]
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    after = zoo_state_dict(jax.tree_util.tree_map(np.asarray, jt.state["params"]), "ConvTasNet")
    ref = SeparationTrainer(tzoo.ConvTasNet(**args), params=after,
                            cfg=TrainConfig(save_every=0), device="cpu")
    held = _heldout(6)
    assert abs(tt.evaluate([held]) - ref.evaluate([held])) <= 1e-4 * abs(ref.evaluate([held]))


def test_init_draws_at_flax_scales():
    """A seeded draw: Dense and conv kernels with variance 1 / fan_in (the
    JAX layout's), biases zero, norm scales one, PReLU slopes 0.25;
    reproducible from the seed."""
    a, b = init_params(MossFormer2(**SMALL), 3), init_params(MossFormer2(**SMALL), 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = init_params(MossFormer2(dim=256, enc_channels=16, num_blocks=1, group_size=32,
                                qk_dim=16, kernel_size=8, fsmn_inner=8), 0)
    kern = w["mask_net.layers.0.flash.to_hidden.proj.weight"]  # (1024, 256): fan_in 256
    # two standard deviations of the normal before truncation
    assert abs(float(kern.std()) * 16 - 1.0) < 0.02
    assert float(kern.abs().max()) <= 2 / 16 / 0.87962566103423978 + 1e-6
    assert float(w["mask_net.layers.0.flash.to_hidden.proj.bias"].abs().max()) == 0.0
    assert torch.equal(w["mask_net.out_ln.weight"], torch.ones(256))
    assert torch.equal(w["mask_net.prelu"], torch.full((1,), 0.25))


def test_init_draws_embeddings_as_flax():
    """nn.Embed tables: flax's plain (untruncated) normal of variance
    1 / features. The draw's standard deviation and its share beyond two of
    them agree with flax.linen.Embed.init's on a table of the same shape."""
    import flax.linen as fnn

    from targetdiarization_tpu_torch.models.punctuation import CTTransformerPunc

    vocab, dim = 4000, 64
    got = init_params(CTTransformerPunc(vocab_size=vocab, dim=dim, n_layers=1), 5)["embed.weight"]
    want = np.asarray(fnn.Embed(vocab, dim).init(jax.random.PRNGKey(5), jnp.zeros(1, jnp.int32))[
        "params"]["embedding"])
    assert tuple(got.shape) == want.shape == (vocab, dim)
    got = got.double().numpy()
    assert abs(got.std() * dim ** 0.5 - 1.0) < 0.01 and abs(want.std() * dim ** 0.5 - 1.0) < 0.01
    tail = lambda x: float(np.mean(np.abs(x) > 2 * dim ** -0.5))  # noqa: E731
    assert abs(tail(got) - tail(want)) < 0.005 and tail(got) > 0.04  # 0.0455 for a normal


def test_more_than_one_device_raises():
    with pytest.raises(ValueError, match="one card"):
        _port_trainer(n_devices=2)
