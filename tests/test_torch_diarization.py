"""The port's SegmentationNet, its host binarizer and SegmentationEngine
against the JAX package on the CPU, and the port's copy of the interval
algebra against the JAX package's.

One flax parameter tree (a small perturbed random SegmentationNet, or the
shipped `checkpoints/seg-bootstrap`) goes through `runtime/convert.py`;
the same inputs from a seed go through both. float32 within 1e-4 of the
reference's largest magnitude (the JAX side at full matmul precision), at
an even and an odd frame count (flax's asymmetric "SAME" pads on the
strided convs). The bf16 engine against the JAX package's bf16 mode: the
same types (convs in bf16, the rest float32 from bf16-rounded weights),
within 2e-2 (bf16 convs that round in a different order; the JAX bf16
mode is itself 1.2e-2 to 2e-2 from float32 on these inputs).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import diarization as jdia
from targetdiarization_tpu.pipeline import intervals as jiv
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import synth
from targetdiarization_tpu_torch.models import diarization as tdia
from targetdiarization_tpu_torch.pipeline import intervals as tiv
from targetdiarization_tpu_torch.runtime.convert import segmentation_state_dict
from targetdiarization_tpu_torch.runtime.params import load_checkpoint
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "seg-bootstrap")
SMALL = dict(dim=32, n_layers=1, heads=2, max_speakers=2)
TOL, BF16_TOL = 1e-4, 2e-2
SR = 16000


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(jm, jp, tm, feats, lengths):
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(feats), jnp.asarray(lengths)))
    with torch.inference_mode():
        got = tm(_t(feats), _t(lengths)).numpy()
    return got, want


@pytest.fixture(scope="module")
def small():
    jm = jdia.SegmentationNet(**SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)), jnp.array([40]))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(p.shape), jnp.float32),
        params)
    tm = tdia.SegmentationNet(**SMALL)
    tm.load_state_dict(segmentation_state_dict(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def shipped():
    jm, jp = jax_from_pretrained(CKPT)
    return jm, jp, from_pretrained(CKPT)


@pytest.mark.parametrize("t", [64, 67])
def test_segmentation_small_matches_jax(small, t, rng):
    jm, jp, tm = small
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    got, want = _run_both(jm, jp, tm, feats, np.array([t, t - 23]))
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("t", [300, 301, 2998])
def test_segmentation_shipped_matches_jax(shipped, t, rng):
    jm, jp, tm = shipped
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    got, want = _run_both(jm, jp, tm, feats, np.array([t, t // 3]))
    assert got.shape == want.shape == (2, -(-(-(-t // 2)) // 2), 3)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("t", [300, 301])
def test_bf16_engine_matches_jax_bf16_mode(shipped, t, rng):
    jm, jp, _ = shipped
    ours = tdia.SegmentationEngine(from_pretrained(CKPT), device="cpu", compute_dtype="bfloat16")
    theirs = jdia.SegmentationEngine(params=jp, model=jm, compute_dtype="bfloat16")
    m = ours.model
    assert {p.dtype for p in (*m.conv1.parameters(), *m.conv2.parameters())} == {torch.bfloat16}
    assert {p.dtype for p in (*m.layers.parameters(), *m.head.parameters())} == {torch.float32}
    assert torch.equal(m.head.weight, m.head.weight.bfloat16().float())
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    lengths = np.array([t, t - 50])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(theirs._params_c, jnp.asarray(feats, jnp.bfloat16),
                                            jnp.asarray(lengths))).astype(np.float32)
    got = ours.forward_feats(_t(feats), _t(lengths)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= BF16_TOL


def _activations(rng, t=400, k=3):
    """Smoothed random tracks crossing onset/offset, with ramps and dips."""
    x = rng.standard_normal((t + 20, k)).cumsum(axis=0)
    x = np.convolve(np.ones(9) / 9, x[:, 0], "same")[:, None] if k == 1 else x
    act = 1 / (1 + np.exp(-(x - x.mean(0)) / (x.std(0) + 1e-9) * 2.5))
    return act[10:-10].astype(np.float32)


CONFIGS = {"default": {}, "no backtrack": dict(onset_backtrack=0.0),
           "symmetric pads": dict(pad_onset=None, pad_offset=None),
           "long backtrack": dict(onset_backtrack=0.3, backtrack_max=1.0, min_duration_off=0.1)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_activations_to_diarization_matches_jax(seed, config):
    act = _activations(np.random.default_rng(seed))
    kw = CONFIGS[config]
    got = tdia.activations_to_diarization(act, 25.0, tdia.BinarizeConfig(**kw))
    want = jdia.activations_to_diarization(act, 25.0, jdia.BinarizeConfig(**kw))
    assert got == want
    assert got  # the tracks cross the onset


@pytest.mark.parametrize("seed", [0, 3])
def test_detect_overlap_pairs_match_jax(seed):
    sd = tdia.activations_to_diarization(_activations(np.random.default_rng(seed)), 25.0)
    for min_overlap in (0.0, 0.4):
        assert tiv.get_speaker_overlap(sd, min_overlap) == jiv.get_speaker_overlap(sd, min_overlap)


@pytest.fixture(scope="module")
def engines():
    jm, jp = jax_from_pretrained(CKPT)
    return (tdia.SegmentationEngine(from_pretrained(CKPT), device="cpu", compute_dtype="float32"),
            jdia.SegmentationEngine(params=jp, model=jm, compute_dtype="float32"))


@pytest.fixture(scope="module")
def conversation():
    """Two voices in turns with overlaps, 33 s: the engine's 30 s windows."""
    rng = np.random.default_rng(4)
    out = np.zeros(33 * SR, np.float32)
    pos, voice = 0, 0
    while pos < len(out) - SR:
        a = synth.synth_utterance(synth.random_text(rng, 4, 9), rng)[0]
        if voice:
            a = np.interp(np.arange(0, len(a), 1.25), np.arange(len(a)), a).astype(np.float32)
        n = min(len(a), len(out) - pos)
        out[pos: pos + n] += a[:n]
        pos += int(0.7 * n) + 1
        voice ^= 1
    return out


def test_engine_activations_and_overlap_match_jax(engines, conversation):
    """Each package's own float32 fbank (they differ by up to about 4e-3 in
    low-energy bins of the same audio) moves the activations by up to
    about 1e-3; the binarized results agree."""
    ours, theirs = engines
    with jax.default_matmul_precision("highest"):
        want = theirs.activations(conversation)
        want_sd = theirs.diarize(conversation[:20 * SR])
        want_od = theirs.detect_overlap(conversation[:20 * SR])
    got = ours.activations(conversation)
    assert got.shape == want.shape == (2998 // 4 + 298 // 4, 3)  # a 30 s and a 3 s window
    assert np.abs(got - want).max() <= 5e-3
    assert ours.fps == theirs.fps == 25.0
    got_sd = ours.diarize(conversation[:20 * SR])
    assert got_sd.keys() == want_sd.keys()
    for k in got_sd:
        assert len(got_sd[k]) == len(want_sd[k])
        assert np.abs(np.array(got_sd[k]) - np.array(want_sd[k])).max() <= 0.04  # one frame
    assert ours.detect_overlap(conversation[:20 * SR]).keys() == want_od.keys()
    assert ours.is_overlap(conversation[:20 * SR]) == bool(want_od)


def test_segmentation_state_dict_loads_shipped_checkpoint():
    tree, meta = load_checkpoint(CKPT)
    model = tdia.SegmentationNet(**meta["model_args"])
    missing, unexpected = model.load_state_dict(segmentation_state_dict(tree), strict=False)
    assert not missing and not unexpected
    attn = tree["params"]["layer_1"]["attn"]
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["layers.1.attn.query.weight"].numpy(),
                                  attn["query"]["kernel"].reshape(128, 128).T)
    np.testing.assert_array_equal(sd["layers.1.attn.out.weight"].numpy(),
                                  attn["out"]["kernel"].reshape(128, 128).T)
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  tree["params"]["conv1"]["kernel"].transpose(2, 1, 0))


# ---------------- the interval algebra (a copy of the JAX package's) ----------------


def _ranges(rng, n=6, dur=20.0):
    s = np.sort(rng.uniform(0, dur, n))
    return [(round(float(a), 2), round(float(a + rng.uniform(0.1, 3.0)), 2)) for a in s]


@pytest.mark.parametrize("name", ["merge_timeranges", "total_duration", "subtract_timeranges",
                                  "calc_multi_iou", "calc_iou_score", "sd_key_matcher",
                                  "apply_od_result", "subtract_overlap", "get_speaker_num",
                                  "parse_segments"])
def test_intervals_copy_matches_jax(name, rng):
    a, b = _ranges(rng), _ranges(rng)
    sd = {"0": a, "1": b, "2": _ranges(rng, 3)}
    args = {"merge_timeranges": (a,), "total_duration": (a,), "subtract_timeranges": (a, b),
            "calc_multi_iou": (a, b), "calc_iou_score": (a, b),
            "sd_key_matcher": (sd, {"x": b, "y": a}), "apply_od_result": (sd,),
            "subtract_overlap": (sd,), "get_speaker_num": (sd, 1.0),
            "parse_segments": ([[s, e, i % 2] for i, (s, e) in enumerate(a)],)}[name]
    assert getattr(tiv, name)(*args) == getattr(jiv, name)(*args)
