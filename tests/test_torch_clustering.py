"""The port's clusterers (numpy and scipy) against scikit-learn, and the
stages built on them against the JAX package.

- `agglomerative_cosine_average` against `AgglomerativeClustering(
  metric="cosine", linkage="average").fit_predict`, with a distance
  threshold and with a cluster count: labels equal, numbering included,
  on 240 seeded sets (2-40 points of 3, 16 or 192 dimensions, 1-4 blobs;
  every third set holds a near-duplicate pair);
- `hdbscan_labels` against `HDBSCAN(min_cluster_size=2)`: the same points
  in the same clusters and the same noise, on the same sets;
- `SpeakerEngine.get_target_embedding` (HDBSCAN over per-segment
  embeddings) and `ClusterDiarizer.diarize_from_windows` (AHC over window
  embeddings) against the JAX package, which clusters with sklearn:
  embeddings at cosine >= 0.9999 (float32 forwards of the same samples),
  diarizations equal.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from sklearn.cluster import HDBSCAN, AgglomerativeClustering

from targetdiarization_tpu.models import diarization as jdia
from targetdiarization_tpu.models import speaker as jspk
from targetdiarization_tpu_torch.models import diarization as tdia
from targetdiarization_tpu_torch.models import speaker as tspk
from targetdiarization_tpu_torch.models.clustering import (agglomerative_cosine_average,
                                                           hdbscan_labels)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPK = os.path.join(REPO, "checkpoints", "spk-bootstrap")
BLOCKS, PER_BLOCK = 8, 30


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _points(seed: int) -> tuple[np.ndarray, float, int]:
    """Unit rows in 1-4 blobs, a distance threshold and a cluster count."""
    rng = np.random.default_rng(seed)
    n, d, k = int(rng.integers(2, 41)), int(rng.choice([3, 16, 192])), int(rng.integers(1, 5))
    x = rng.standard_normal((k, d))[rng.integers(0, k, n)] \
        + rng.uniform(0.05, 1.0) * rng.standard_normal((n, d))
    if seed % 3 == 0:
        x[n // 2] = x[0] + 1e-7 * rng.standard_normal(d)  # a near-duplicate pair
    x = x.astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True), float(rng.uniform(0.1, 1.0)),
            int(rng.integers(1, n + 1)))


def _same_partition(a, b) -> bool:
    """Equal up to a renaming of the clusters, noise (-1) in place."""
    pairs = {}
    for x, y in zip(a, b):
        if (x == -1) != (y == -1):
            return False
        if x != -1 and pairs.setdefault(x, y) != y:
            return False
    return len(set(pairs.values())) == len(pairs)


@pytest.mark.parametrize("block", range(BLOCKS))
def test_agglomerative_labels_equal_sklearn(block):
    for seed in range(block * PER_BLOCK, (block + 1) * PER_BLOCK):
        x, threshold, n_clusters = _points(seed)
        want = AgglomerativeClustering(n_clusters=None, distance_threshold=threshold,
                                       metric="cosine", linkage="average").fit_predict(x)
        np.testing.assert_array_equal(
            agglomerative_cosine_average(x, distance_threshold=threshold), want,
            err_msg=f"seed {seed}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = AgglomerativeClustering(n_clusters=n_clusters, metric="cosine",
                                           linkage="average").fit_predict(x)
        np.testing.assert_array_equal(agglomerative_cosine_average(x, n_clusters=n_clusters),
                                      want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("block", range(BLOCKS))
def test_hdbscan_membership_equals_sklearn(block):
    for seed in range(block * PER_BLOCK, (block + 1) * PER_BLOCK):
        x, _, _ = _points(seed)
        if len(x) < 2:
            continue
        want = HDBSCAN(min_cluster_size=2, copy=True).fit_predict(x)
        got = hdbscan_labels(x, min_cluster_size=2)
        assert _same_partition(got, want), (seed, got, want)


def test_clusterers_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError):
        agglomerative_cosine_average(np.ones((1, 3)), distance_threshold=0.5)
    with pytest.raises(ValueError):
        agglomerative_cosine_average(np.array([[1.0, 0.0], [0.0, 0.0]]), n_clusters=1)
    with pytest.raises(ValueError):
        agglomerative_cosine_average(np.eye(3), n_clusters=2, distance_threshold=0.5)
    with pytest.raises(ValueError):
        hdbscan_labels(np.ones((1, 3)))


@pytest.fixture(scope="module")
def speakers():
    return (tspk.SpeakerEngine.from_pretrained(SPK, device="cpu", compute_dtype="float32"),
            jspk.SpeakerEngine.from_pretrained(SPK))


def _voices(seed: int) -> tuple[np.ndarray, list]:
    """Utterances of two synthesized voices with pauses, and their spans."""
    from chip_smoke import BOOT_CHARS, synth_utterance, voice_b

    rng = np.random.default_rng(seed)
    pieces, segs, pos = [], [], 0
    for i in range(6):
        text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(5))
        utt = synth_utterance(text, rng)[0]
        utt = voice_b(utt) if i in (2, 5) else utt
        segs.append([pos / 16000, (pos + len(utt)) / 16000])
        gap = np.zeros(int(0.3 * 16000), np.float32)
        pieces += [utt, gap]
        pos += len(utt) + len(gap)
    return np.concatenate(pieces), segs


@pytest.mark.parametrize("seed", [1, 2])
def test_get_target_embedding_matches_jax(speakers, seed):
    ours, theirs = speakers
    audio, segs = _voices(seed)
    embs = theirs.embed_batch([audio[int(s * 16000): int(e * 16000)] for s, e in segs])
    labels = HDBSCAN(min_cluster_size=2, copy=True).fit_predict(
        embs / np.linalg.norm(embs, axis=1, keepdims=True))
    assert (labels >= 0).any()  # HDBSCAN picks a cluster: not the plain mean
    got = ours.get_target_embedding(audio, vad_segments=segs)
    want = theirs.get_target_embedding(audio, vad_segments=segs)
    cos = float(np.dot(got, want) / np.linalg.norm(got) / np.linalg.norm(want))
    assert cos >= 0.9999, (cos, labels)
    # without segments: the whole clip's embedding
    got, want = ours.get_target_embedding(audio[:8000]), theirs.get_target_embedding(audio[:8000])
    assert float(np.dot(got, want) / np.linalg.norm(got) / np.linalg.norm(want)) >= 0.9999


def _windows(seed: int):
    rng = np.random.default_rng(seed)
    n = 40
    wins = [(i * 0.75, i * 0.75 + 1.5) for i in range(n)]
    centers = rng.standard_normal((3, 192))
    lab = np.repeat(rng.integers(0, 3, 8), 5)
    embs = (centers[lab] + 0.4 * rng.standard_normal((n, 192))).astype(np.float32)
    embs[7] = 0.0  # a zero embedding is left out
    return wins, embs


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_speakers", [None, 2])
def test_diarize_from_windows_matches_jax(speakers, seed, n_speakers):
    ours, theirs = speakers
    wins, embs = _windows(seed)
    got = tdia.ClusterDiarizer(ours).diarize_from_windows(wins, embs, n_speakers)
    want = jdia.ClusterDiarizer(theirs).diarize_from_windows(wins, embs, n_speakers)
    assert got == want and len(got) >= 1


def test_cluster_diarizer_windows_match_jax(speakers):
    ours, theirs = speakers
    segs = [[0.1, 2.0], [2.3, 2.6], [3.0, 7.2]]
    assert tdia.ClusterDiarizer(ours)._windows(segs, 8.0) == \
        jdia.ClusterDiarizer(theirs)._windows(segs, 8.0)
