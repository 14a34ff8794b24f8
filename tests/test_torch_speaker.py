"""The port's ERes2NetV2 and SpeakerEngine against the JAX package on the CPU.

One flax variable tree (`params` and `batch_stats`: a small perturbed
random ERes2NetV2, or the shipped `checkpoints/spk-bootstrap`) goes
through `runtime/convert.py` into the port; the same inputs from a seed
go through both. float32 within 1e-4 of the reference's largest magnitude
(the JAX side at full matmul precision); the bf16 engine against the JAX
package's (jitted) bf16 mode within 1e-4 too (both compute in float32
from the same bf16-rounded weights and input, with each BatchNorm's
rsqrt(var + eps) in bf16). Then `embed_batch` over the sample
rungs, verification and cosine.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import speaker as jspk
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import synth
from targetdiarization_tpu_torch.models import speaker as tspk
from targetdiarization_tpu_torch.runtime.convert import eres2netv2_state_dict
from targetdiarization_tpu_torch.runtime.params import load_checkpoint
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "spk-bootstrap")
SMALL = dict(channels=8, blocks=(1, 1, 1, 1))
TOL = BF16_TOL = 1e-4
SR = 16000


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.fixture(scope="module")
def small():
    """A small ERes2NetV2 whose every parameter and running statistic is
    perturbed (variances kept positive)."""
    jm = jspk.ERes2NetV2(**SMALL)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)),
                                 jnp.array([40]))
    rng = np.random.default_rng(1)

    def perturb(path, p):
        p = np.asarray(p)
        if path[-1].key == "var":
            return jnp.asarray(p * rng.uniform(0.5, 2.0, p.shape), jnp.float32)
        return jnp.asarray(p + 0.05 * rng.standard_normal(p.shape), jnp.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
    tm = tspk.ERes2NetV2(**SMALL)
    tm.load_state_dict(eres2netv2_state_dict(variables), strict=True)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def shipped():
    jm, jp = jax_from_pretrained(CKPT)
    return jm, jp, from_pretrained(CKPT)


def _run_both(jm, jp, tm, feats, lengths):
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, f, n: jm.apply(p, f, n, train=False))(
            jp, jnp.asarray(feats), jnp.asarray(lengths)))
    with torch.inference_mode():
        got = tm(_t(feats), _t(lengths)).numpy()
    return got, want


@pytest.mark.parametrize("t,lengths", [(150, (150, 90)), (37, (37, 1))])
def test_eres2netv2_small_matches_jax(small, t, lengths):
    """Each case draws its input from its own seed, so it does not depend on
    which tests ran before it."""
    jm, jp, tm = small
    feats = np.random.default_rng(t).standard_normal((2, t, 80)).astype(np.float32)
    got, want = _run_both(jm, jp, tm, feats, np.array(lengths))
    assert got.shape == want.shape == (2, 192)
    assert _rel(got, want) <= TOL


def _forward(jm):
    return jax.jit(lambda p, f, n: jm.apply(p, f, n, train=False))


@pytest.fixture(scope="module")
def small_f64(small):
    """The witness, independent of the port: the JAX model in float64 (x64
    on, params and input in float64)."""
    jm, jp, _ = small
    with jax.enable_x64(True):
        return _forward(jm), jax.tree_util.tree_map(
            lambda p: jnp.asarray(np.asarray(p, np.float64)), jp)


def _one_frame_row_errors(small, small_f64, fwd, seed):
    """(port, JAX) float32 errors of the 1-frame row of (37, 1) frames
    against the JAX model in float64, relative to the largest float64
    output; `fwd` is the jitted JAX float32 forward."""
    jm, jp, tm = small
    feats = np.random.default_rng(seed).standard_normal((2, 37, 80)).astype(np.float32)
    lengths = np.array([37, 1])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fwd(jp, jnp.asarray(feats), jnp.asarray(lengths)))
    with torch.inference_mode():
        got = tm(_t(feats), _t(lengths)).numpy()
    f64, p64 = small_f64
    with jax.enable_x64(True):
        ref = f64(p64, jnp.asarray(feats, jnp.float64), jnp.asarray(lengths))
        assert ref.dtype == jnp.float64
        ref = np.asarray(ref)
    scale = np.abs(ref).max()
    return tuple(float(np.abs(x[1] - ref[1]).max() / scale) for x in (got, want))


@pytest.fixture(scope="module")
def small_fwd(small):
    return _forward(small[0])


@pytest.mark.parametrize("seed", range(50))
def test_eres2netv2_one_frame_row_against_float64(small, small_f64, small_fwd, seed):
    """The 1-frame row against the JAX model in float64. Over these 50
    seeds the port's float32 row is at most 7.9e-7 from it (mean 4.1e-7);
    the JAX package's float32 row 7.0e-6 to 8.6e-5 (mean 3.1e-5), and one
    whole-suite draw of the test above reached 1.8e-4. So on this row the
    JAX package carries the float32 error; why is the next test."""
    port, jax_err = _one_frame_row_errors(small, small_f64, small_fwd, seed)
    assert port <= 2e-6
    assert jax_err <= 2e-4 and port < jax_err


def test_eres2netv2_one_frame_error_is_flax_fast_variance(small, small_f64, small_fwd,
                                                          monkeypatch):
    """The cause: AFF's `gate_norm` (flax GroupNorm, one channel a group)
    takes its variance as E[x^2] - E[x]^2 (`use_fast_variance`). The 1-frame
    row's maps are near constant (the rest is masked), so that difference
    cancels in float32; torch's GroupNorm takes it about the mean. With the
    two-pass variance the JAX float32 row comes about ten times nearer to
    float64 (over 50 seeds: max 8.3e-6, mean 2.0e-6, against 8.6e-5 and
    3.1e-5), and its intermediates part from float64 first in stage0's
    block (the stem stays within 2e-7)."""
    import functools

    import flax.linen as fnn

    seeds = range(6)
    fast = [_one_frame_row_errors(small, small_f64, small_fwd, s) for s in seeds]
    monkeypatch.setattr(jspk.nn, "GroupNorm",
                        functools.partial(fnn.GroupNorm, use_fast_variance=False))
    fwd = _forward(small[0])  # traced anew with the two-pass variance
    two_pass = [_one_frame_row_errors(small, small_f64, fwd, s) for s in seeds]
    mean_fast, mean_two = (float(np.mean([j for _, j in r])) for r in (fast, two_pass))
    assert mean_two * 5 < mean_fast, (fast, two_pass)
    assert max(j for _, j in two_pass) < 2e-5, two_pass
    assert [p for p, _ in fast] == [p for p, _ in two_pass]  # the port is untouched


def test_eres2netv2_shipped_matches_jax(shipped, rng):
    jm, jp, tm = shipped
    feats = rng.standard_normal((3, 150, 80)).astype(np.float32)
    got, want = _run_both(jm, jp, tm, feats, np.array([150, 120, 33]))
    assert _rel(got, want) <= TOL


def test_bf16_engine_matches_jax_bf16_mode(shipped, rng):
    """In bf16 mode the JAX network computes in float32 from bf16-rounded
    weights (the float32 time mask promotes the bf16 input at once), but
    XLA rounds each BatchNorm's rsqrt(var + eps) to the bf16 type of the
    running statistics; the port's bf16 engine does the same. (JAX's bf16
    mode is 5.5e-3 from its float32 mode here, so 1e-4 tells them apart.)"""
    jm, jp, _ = shipped
    ours = tspk.SpeakerEngine(from_pretrained(CKPT), device="cpu", compute_dtype="bfloat16")
    theirs = jspk.SpeakerEngine(params=jp, model=jm, compute_dtype="bfloat16")
    norms = [m for m in ours.model.modules() if isinstance(m, tspk.BatchNorm)]
    assert {t.dtype for m in norms for t in (*m.parameters(), *m.buffers())} == {torch.bfloat16}
    in_norms = {id(p) for m in norms for p in m.parameters()}
    assert {p.dtype for p in ours.model.parameters() if id(p) not in in_norms} == {torch.float32}
    stem = ours.model.stem.weight
    assert torch.equal(stem, stem.bfloat16().float())
    feats = rng.standard_normal((2, 150, 80)).astype(np.float32)
    lengths = np.array([150, 77])
    with jax.default_matmul_precision("highest"):
        fwd = jax.jit(lambda p, f, n: jm.apply(p, f, n, train=False))
        want = np.asarray(fwd(theirs._params_c, jnp.asarray(feats, jnp.bfloat16),
                              jnp.asarray(lengths))).astype(np.float32)
    got = ours.embed_feats(_t(feats), _t(lengths)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= BF16_TOL


@pytest.fixture(scope="module")
def engines():
    jm, jp = jax_from_pretrained(CKPT)
    return (tspk.SpeakerEngine(from_pretrained(CKPT), device="cpu", compute_dtype="float32"),
            jspk.SpeakerEngine(params=jp, model=jm, compute_dtype="float32"))


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(7)
    utts = [synth.synth_utterance(synth.random_text(rng, n, n), rng)[0] for n in (3, 6, 14)]
    return utts + [np.zeros(200, np.float32)]  # under one fbank frame


@pytest.mark.parametrize("single_dispatch", [False, True])
def test_embed_batch_matches_jax(engines, clips, single_dispatch):
    """Clips in the 1 s, 2 s and 4 s rungs and one too short for a frame
    (zero vector): cosine >= 0.9999 (each package's own float32 fbank)."""
    ours, theirs = engines
    with jax.default_matmul_precision("highest"):
        want = theirs.embed_batch(clips, single_dispatch=single_dispatch)
    got = ours.embed_batch(clips, single_dispatch=single_dispatch)
    assert got.shape == want.shape == (4, 192)
    np.testing.assert_array_equal(got[3], 0.0)
    assert _cos(got[:3], want[:3]).min() >= 0.9999


def test_embedding_at_another_rate_matches_jax(engines, clips):
    from scipy.signal import resample_poly

    ours, theirs = engines
    clip8k = resample_poly(clips[1], 1, 2).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = theirs.get_speaker_embedding(clip8k, sr=8000)
    assert _cos(ours.get_speaker_embedding(clip8k, sr=8000), want) >= 0.9999


@pytest.mark.parametrize("threshold", [0.4, 0.99])
def test_verification_matches_jax(engines, threshold, rng):
    ours, theirs = engines
    a, b = rng.standard_normal(192), rng.standard_normal(192)
    b = a + 0.4 * b
    assert ours.is_same_person(a, b, threshold) == theirs.is_same_person(a, b, threshold)
    assert tspk.cosine_similarity(a, np.zeros(192)) == jspk.cosine_similarity(a, np.zeros(192))


def test_eres2netv2_state_dict_carries_batch_stats():
    tree, meta = load_checkpoint(CKPT)
    model = tspk.ERes2NetV2(**meta["model_args"])
    missing, unexpected = model.load_state_dict(eres2netv2_state_dict(tree), strict=False)
    assert not missing and not unexpected
    sd = model.state_dict()
    stats = tree["batch_stats"]["stage2_block1"]["bn_3"]
    np.testing.assert_array_equal(sd["blocks.stage2_block1.bn.3.running_mean"].numpy(),
                                  stats["mean"])
    np.testing.assert_array_equal(sd["blocks.stage2_block1.bn.3.running_var"].numpy(),
                                  stats["var"])
    assert model.blocks["stage1_block0"].shortcut is not None
    assert model.blocks["stage1_block1"].shortcut is None
