"""`bootstrap_sensevoice` against the JAX recipe on the CPU, with the pieces
it needs: the CTC and tag losses against optax, and `apply_if_finite` and
`warmup_cosine_decay_schedule` against optax.

SenseVoice runs 32 wide with one block, 2 steps of 2 x 1 s, one eval
utterance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.asr import SenseVoice as JaxSenseVoice
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import optim, recipes

SV_ARGS = dict(dim=32, enc_layers=1, ffn=64)
SV_SIZE = dict(steps=2, batch=2, seconds=1.0, eval_utts=1)
FBANK_FLOOR = 2.3  # as tests/test_torch_recipes_asr.py


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def sv_run(assets, tmp_path_factory):
    torch.set_num_threads(2)
    kwargs = {**SV_SIZE, **SV_ARGS}
    return cases.run_both(str(tmp_path_factory.mktemp("sv")), assets, "bootstrap_sensevoice",
                          kwargs, kwargs, jax_cls=JaxSenseVoice, fbank_floor=FBANK_FLOOR)


def test_sensevoice_steps_match_jax(sv_run):
    cases.check_logs_and_losses(sv_run, SV_SIZE["steps"])
    cases.check_saved_params(sv_run, "SenseVoice")


def test_sensevoice_metrics_and_checkpoint_match_jax(sv_run):
    """The same CER from the same greedy CTC decodes; each checkpoint's
    forward the same in the other package's registry."""
    cases.check_metrics(sv_run, {"eval_cer": 0.0, "eval_exact": 0.0})
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 17, 560)).astype(np.float32)
    mask = np.ones((2, 17), np.float32)
    mask[1, 11:] = 0
    apply = None
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(sv_run[who]["path"])
        apply = apply or jax.jit(model.apply)
        want = apply(params, jnp.asarray(feats), jnp.asarray(mask))
        with torch.no_grad():
            got = from_pretrained(sv_run[who]["path"])(torch.from_numpy(feats),
                                                       torch.from_numpy(mask))
        for key in ("ctc_logits", "lang_logits"):
            assert _rel(got[key].numpy(), want[key]) <= cases.FORWARD_RTOL, (who, key)


def _ctc_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, t, v, s = 3, 14, 9, 5
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 2
    n_in = np.array([14, 9, 12])
    logit_pad = (np.arange(t)[None] >= n_in[:, None]).astype(np.float32)
    labels = rng.integers(1, v, (b, s)).astype(np.int32)
    labels[0, 1] = labels[0, 2]  # a repeat: CTC needs a blank between them
    n_lab = np.array([5, 3, 1])
    label_pad = (np.arange(s)[None] >= n_lab[:, None]).astype(np.float32)
    labels = np.where(label_pad > 0, 0, labels).astype(np.int32)
    return logits, logit_pad, labels, label_pad


def test_ctc_loss_and_gradient_match_optax():
    """Per-sequence NLL and the gradient of their mean for the logits,
    within 1e-5 (blank 0, paddings as masks, a repeated label)."""
    logits, lp, labels, lab_p = _ctc_inputs()

    def jloss(x):
        return jnp.mean(optax.ctc_loss(x, jnp.asarray(lp), jnp.asarray(labels),
                                       jnp.asarray(lab_p), blank_id=0))

    want_seq = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(lp),
                                         jnp.asarray(labels), jnp.asarray(lab_p), blank_id=0))
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    seq = recipes.ctc_loss(x, torch.from_numpy(lp), torch.from_numpy(labels),
                           torch.from_numpy(lab_p), blank_id=0)
    (grad,) = torch.autograd.grad(seq.mean(), x)
    assert np.allclose(seq.detach().numpy(), want_seq, rtol=1e-5, atol=1e-5)
    assert np.abs(grad.numpy() - want_grad).max() <= 1e-5


def test_tag_cross_entropy_and_gradient_match_optax():
    logits = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32) * 3

    def jloss(x):
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            x, jnp.zeros(4, jnp.int32)))

    x = torch.from_numpy(logits).requires_grad_(True)
    loss = recipes._ce_class0(x)
    (grad,) = torch.autograd.grad(loss, x)
    assert abs(float(loss) - float(jloss(jnp.asarray(logits)))) <= 1e-5
    assert np.abs(grad.numpy() - np.asarray(jax.grad(jloss)(jnp.asarray(logits)))).max() <= 1e-5


def test_warmup_cosine_schedule_matches_optax():
    for args in ((0.0, 1e-3, 1, 5), (0.0, 1e-3, 6, 50), (1e-4, 2e-3, 10, 40, 1e-5, 2.0)):
        want = jax.jit(optax.warmup_cosine_decay_schedule(*args))
        sched = optim.warmup_cosine_decay_schedule(*args)
        for step in range(50):
            assert abs(sched(step) - float(want(jnp.int32(step)))) <= 1e-7, (args, step)
    with pytest.raises(ValueError, match="decay_steps"):
        optim.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)


@pytest.mark.parametrize("max_errors", [1, 3])
def test_apply_if_finite_matches_optax(max_errors):
    """A NaN gradient once, then max_errors + 1 in a row: skipped updates,
    the counters, and the update applied once the run of NaNs is longer
    than max_errors; parameters and state against optax step by step."""
    rng = np.random.default_rng(2)
    params = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(4).astype(np.float32)]
    bad = {2} | set(range(4, 4 + max_errors + 1))
    grads = []
    for i in range(7 + max_errors):
        g = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        if i in bad:
            g[1][2] = np.nan
        grads.append(g)
    jopt = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2)),
                                 max_errors)
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    topt = optim.apply_if_finite(optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-2)),
                                 max_errors)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.update([torch.from_numpy(x) for x in g], ts, tp)
        optim.apply_updates(tp, tupd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        assert ts["notfinite_count"] == int(js.notfinite_count)
        assert ts["total_notfinite"] == int(js.total_notfinite)
        assert ts["last_finite"] == bool(js.last_finite)
    assert ts["total_notfinite"] == len(bad)
    assert np.isnan(tp[1].numpy()).any()  # the longer run's last update went in
