"""The port's CAM++ speaker embedder against the JAX package's, on the CPU.

One flax variable tree (`params` and `batch_stats`) goes through
`runtime/convert.py::campp_state_dict` into the port: the shipped
`checkpoints/campp-bootstrap` (the `campp` preset's full geometry: 128
channels, growth 32, blocks of 4, 6 and 8 layers) and small perturbed
random configs whose frequency counts make flax's "SAME" pad the
stride-2 front end asymmetrically (80: (0, 1) then (0, 1)) or not (79:
(1, 1) then (0, 1); 78: (0, 1) then (1, 1)). Then `SpeakerEngine` on the
shipped checkpoint: `embed_batch` over the sample rungs and
`get_target_embedding`. JAX runs at full float32 matmul precision.

Limit: embeddings within 1e-4 of the reference's largest magnitude (they
agree to about 1e-6).
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import enrollment
from targetdiarization_tpu.models import speaker as jspk
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import speaker as tspk
from targetdiarization_tpu_torch.runtime.convert import campp_state_dict
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "campp-bootstrap")
SMALL = dict(init_channels=32, growth=16, bottleneck=16, block_layers=(2, 1, 2))
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker (most
    of all the many small ops of a greedy loop)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run_both(jm, variables, tm, feats, lengths):
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, f, n: jm.apply(v, f, n, train=False))(
            variables, jnp.asarray(feats), jnp.asarray(lengths)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    return got, want


@pytest.fixture(scope="module")
def shipped():
    jm, variables = jax_from_pretrained(CKPT)
    return jm, variables, from_pretrained(CKPT)


def test_shipped_checkpoint_is_the_campp_preset(shipped):
    _, _, tm = shipped
    assert isinstance(tm, tspk.CAMPlusPlus)
    preset = tspk.preset_model("campp")
    preset.load_state_dict(tm.state_dict(), strict=True)
    bns = [m for m in tm.modules() if isinstance(m, tspk.BatchNorm)]
    assert len(bns) == 2 * 18 + 3 and all(m.axis == -1 for m in bns)
    assert tm.embedding.in_features == 2 * 208


@pytest.mark.parametrize("frames,lengths", [(100, (100, 61)), (301, (301, 300)), (37, (9, 37))])
def test_shipped_model_matches_jax(shipped, frames, lengths):
    jm, variables, tm = shipped
    rng = np.random.default_rng(frames)
    feats = rng.standard_normal((2, frames, 80)).astype(np.float32)
    got, want = _run_both(jm, variables, tm, feats, np.asarray(lengths))
    assert got.shape == want.shape == (2, 192)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("feat_dim", [80, 79, 78])
def test_small_random_model_matches_jax(feat_dim):
    """Every parameter and running statistic perturbed (variances kept
    positive); the pads of flax's "SAME" on both stride-2 convs."""
    jm = jspk.CAMPlusPlus(feat_dim=feat_dim, **SMALL)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 30, feat_dim)),
                                 jnp.array([30]))
    rng = np.random.default_rng(feat_dim)

    def perturb(path, p):
        p = np.asarray(p)
        if path[-1].key == "var":
            return jnp.asarray(p * rng.uniform(0.5, 2.0, p.shape), jnp.float32)
        return jnp.asarray(p + 0.05 * rng.standard_normal(p.shape), jnp.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
    tm = tspk.CAMPlusPlus(feat_dim=feat_dim, **SMALL)
    tm.load_state_dict(campp_state_dict(variables), strict=True)
    feats = rng.standard_normal((2, 57, feat_dim)).astype(np.float32)
    got, want = _run_both(jm, variables, tm.eval(), feats, np.array([57, 30]))
    assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def engines():
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": "float32"}):
        theirs = jspk.SpeakerEngine.from_pretrained(CKPT)
    return tspk.SpeakerEngine.from_pretrained(CKPT, device="cpu", compute_dtype="float32"), theirs


def test_engine_embed_batch_matches_jax(engines):
    """Clips of 0.01-9 s over the 1, 2, 4 and 16 s rungs, one too short for
    a frame (a zero vector in both)."""
    ours, theirs = engines
    voice = enrollment(9.0, seed=4)
    clips = [voice[:160], voice[: SR // 2], voice[SR: 3 * SR], voice[: int(3.7 * SR)], voice]
    got = ours.embed_batch(clips)
    with jax.default_matmul_precision("highest"):
        want = theirs.embed_batch(clips)
    assert not got[0].any() and not want[0].any()
    assert _rel(got, want) <= 1e-4
    np.testing.assert_allclose(ours.embed_batch(clips[1:3], single_dispatch=True), got[1:3],
                               rtol=0, atol=1e-4 * np.abs(got).max())


def test_engine_target_embedding_matches_jax(engines):
    """get_target_embedding of a 9 s enrollment cut into VAD-like segments:
    with fewer than min_cluster_size segments both take the mean."""
    ours, theirs = engines
    voice = enrollment(9.0, seed=6)
    segs = [[0.2, 2.9], [3.3, 6.0]]
    got = ours.get_target_embedding(voice, vad_segments=segs, min_cluster_size=3)
    with jax.default_matmul_precision("highest"):
        want = theirs.get_target_embedding(voice, vad_segments=segs, min_cluster_size=3)
    assert _rel(got, want) <= 1e-4
    assert ours.is_same_person(got, want)[0]
