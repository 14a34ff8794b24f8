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
def test_eres2netv2_small_matches_jax(small, t, lengths, rng):
    jm, jp, tm = small
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    got, want = _run_both(jm, jp, tm, feats, np.array(lengths))
    assert got.shape == want.shape == (2, 192)
    assert _rel(got, want) <= TOL


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
