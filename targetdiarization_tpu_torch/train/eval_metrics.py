"""Pipeline-level evaluation metrics: DER, CER and WER.

The port's own copy of targetdiarization_tpu/train/eval_metrics.py (numpy
and scipy on the host):

- `der(reference, hypothesis, collar)`: diarization error rate over
  {speaker: [(start, end), ...]} dicts with an optimal speaker mapping
  (Hungarian over pairwise overlap), on a frame grid.
- `cer(ref_text, hyp_text)` / `wer`: edit-distance error rates.
"""

from __future__ import annotations

import numpy as np


def _to_frames(result: dict, end: float, step: float) -> np.ndarray:
    """{spk: [(s,e)...]} → (n_spk, n_frames) activity matrix."""
    n = max(1, int(round(end / step)))
    speakers = sorted(result)
    acts = np.zeros((len(speakers), n), bool)
    for i, spk in enumerate(speakers):
        for s, e in result[spk]:
            acts[i, int(round(s / step)): int(round(e / step))] = True
    return acts


def der(reference: dict, hypothesis: dict, collar: float = 0.25,
        step: float = 0.01) -> float:
    """Diarization error rate = (miss + false alarm + confusion) / ref
    speech, with an optimal one-to-one speaker mapping and a no-score
    collar around reference boundaries."""
    if not reference:
        return 0.0 if not hypothesis else 1.0
    end = max(
        [e for v in reference.values() for _, e in v]
        + [e for v in hypothesis.values() for _, e in v] + [step]
    )
    ref = _to_frames(reference, end, step)
    hyp = _to_frames(hypothesis, end, step) if hypothesis else np.zeros((0, ref.shape[1]), bool)

    # collar: exclude frames near any reference boundary
    score_mask = np.ones(ref.shape[1], bool)
    c = int(round(collar / step))
    for v in reference.values():
        for s, e in v:
            for b in (s, e):
                i = int(round(b / step))
                score_mask[max(0, i - c): i + c] = False
    ref = ref[:, score_mask]
    hyp = hyp[:, score_mask] if hyp.size else hyp

    # optimal speaker mapping by overlap
    if len(reference) and len(hypothesis):
        from scipy.optimize import linear_sum_assignment

        overlap = (ref[:, None, :] & hyp[None, :, :]).sum(axis=2)
        rows, cols = linear_sum_assignment(-overlap)
        mapped = np.zeros_like(ref)
        for r, h in zip(rows, cols):
            mapped[r] = hyp[h]
        extra_hyp = [h for h in range(hyp.shape[0]) if h not in set(cols)]
    else:
        mapped = np.zeros_like(ref)
        extra_hyp = list(range(hyp.shape[0])) if hyp.size else []

    ref_count = ref.sum(axis=0)  # speakers active per frame (reference)
    hyp_count = (
        mapped.sum(axis=0)
        + (hyp[extra_hyp].sum(axis=0) if extra_hyp else 0)
    )
    correct = (ref & mapped).sum(axis=0)
    total_ref = ref_count.sum()
    if total_ref == 0:
        return 0.0 if hyp_count.sum() == 0 else 1.0
    miss = np.maximum(ref_count - hyp_count, 0).sum()
    fa = np.maximum(hyp_count - ref_count, 0).sum()
    confusion = (np.minimum(ref_count, hyp_count) - correct).sum()
    return float((miss + fa + confusion) / total_ref)


def _edit_distance(ref: list, hyp: list) -> int:
    m, n = len(ref), len(hyp)
    dp = np.arange(n + 1)
    for i in range(1, m + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, n + 1):
            dp[j] = min(
                prev[j] + 1,  # deletion
                dp[j - 1] + 1,  # insertion
                prev[j - 1] + (ref[i - 1] != hyp[j - 1]),  # sub
            )
    return int(dp[n])


def cer(ref_text: str, hyp_text: str) -> float:
    """Character error rate (whitespace ignored)."""
    ref = [c for c in ref_text if not c.isspace()]
    hyp = [c for c in hyp_text if not c.isspace()]
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def wer(ref_text: str, hyp_text: str) -> float:
    """Word error rate (whitespace tokenization)."""
    ref = ref_text.split()
    hyp = hyp_text.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)
