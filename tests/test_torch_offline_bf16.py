"""`TargetDiarization.infer` in bf16 mode against the JAX package's bf16
mode, on the shipped checkpoints and input (a) of `test_torch_offline.py`
(2.5 s of overlapped turns: segmentation, re-clustering, the target's
overlap clips through `FusedSeparation` with Apollo in the same pass), on
the CPU. Every engine of both systems computes in bf16 (the JAX engines
are made under TD_COMPUTE_DTYPE=bfloat16), as the port does on the card.

In bf16 an `infer` result departs from the float32 one: a VAD boundary
moves by a frame, an overlap clip whose streams both score near the
separation gate is kept or dropped, and the bootstrap Paraformer's argmax
flips on streams that differ by bf16 rounding. This file holds the port's
bf16 program to the JAX package's, so that such departures on the card
are the reference's too.

Limits, and why:
- target_spk and the speakers equal; the entries pair one to one (by
  speaker, type and start) with the same speakers and types, timeranges
  within 10 ms (one frame: the two programs round differently, and a VAD
  boundary moves by a frame) and target tracks within one frame in length;
- the target's audio entry by entry, on the samples both runs' entries
  cover (`chip_smoke.piece_agreement`), at SI-SDR >= 30 dB: every entry
  pairs, and the separated streams of two bf16 programs differ by their
  rounding (43.5 and 54.1 dB on this input);
- texts at a character error rate of at most 0.3 (0.26 on this input: 6
  characters of 23). The separated streams differ by bf16 rounding, and
  that flips argmaxes of the bootstrap Paraformer over the whole of a
  speaker's combined track.
"""

import jax.numpy as jnp
import pytest
import torch

from chip_smoke import cer, dialogue, enrollment, piece_agreement, record_target_pieces, strip_punct
from test_torch_offline import build_both, run_both


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_infer_bf16_matches_jax_bf16_mode():
    ours, theirs = systems = build_both("bfloat16")
    assert ours.ap.separator.compute_dtype == torch.bfloat16
    assert theirs.tasr.ap.separator.compute_dtype is jnp.bfloat16
    seen = {"ours": record_target_pieces(ours), "theirs": record_target_pieces(theirs)}
    (g_spk, g_res, g_audio), (w_spk, w_res, w_audio) = run_both(
        systems, dialogue(2.5, seed=1, overlap=True), enrollment(4.0, seed=9))
    key = lambda r: (r["speaker"], r["type"], r["timerange"][0])
    g_res, w_res = sorted(g_res, key=key), sorted(w_res, key=key)
    assert g_spk == w_spk and g_spk
    assert [(r["speaker"], r["type"]) for r in g_res] == [(r["speaker"], r["type"]) for r in w_res]
    assert any(r["type"] == "overlap" for r in w_res)  # the separator ran
    for g, w in zip(g_res, w_res):
        assert max(abs(a - b) for a, b in zip(g["timerange"], w["timerange"])) <= 0.01, (g, w)
    assert abs(len(g_audio) - len(w_audio)) <= 160
    pieces = piece_agreement(seen["ours"]["pieces"], seen["theirs"]["pieces"])
    assert pieces["unpaired"] == [[], []] and pieces["pairs"] == len(seen["theirs"]["pieces"])
    assert pieces["min_si_sdr_db"] >= 30.0, pieces
    text_g = "".join(strip_punct(r["text"]) for r in g_res)
    text_w = "".join(strip_punct(r["text"]) for r in w_res)
    assert cer(text_w, text_g) <= 0.3, (g_res, w_res)
