"""Separation losses: SI-SDR family, PIT, MixIT, freq-MAE + wav-L1.

Counterpart of targetdiarization_tpu/train/losses.py, in torch, with the
same formulas (the look2hear losses: matrix.py, pit_wrapper.py, mixit.py).
PIT's factorial path takes the cost of every permutation at once from
one-hot permutation matrices; its Hungarian path runs scipy's assignment
on the host, and the loss takes the chosen entries of the matrix, so the
gradient flows through them as through the factorial path's.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations

import numpy as np
import torch

EPS = 1e-8


def _zero_mean(x):
    return x - x.mean(dim=-1, keepdim=True)


def si_sdr(est: torch.Tensor, ref: torch.Tensor, zero_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis."""
    if zero_mean:
        est, ref = _zero_mean(est), _zero_mean(ref)
    dot = torch.sum(est * ref, dim=-1, keepdim=True)
    energy = torch.sum(ref * ref, dim=-1, keepdim=True)
    target = dot * ref / (energy + EPS)
    noise = est - target
    t_pow = torch.sum(target ** 2, dim=-1)
    # a relative noise floor bounds SI-SDR at about 60 dB: a near-perfect
    # estimate would otherwise drive the 1/noise gradients to overflow
    n_pow = torch.sum(noise ** 2, dim=-1) + 1e-6 * t_pow + EPS
    return 10.0 * torch.log10(t_pow / n_pow + EPS)


def sd_sdr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Scale-dependent SDR: the scaled target's power over the residual's."""
    est, ref = _zero_mean(est), _zero_mean(ref)
    dot = torch.sum(est * ref, dim=-1, keepdim=True)
    energy = torch.sum(ref * ref, dim=-1, keepdim=True)
    scaled_target = dot * ref / (energy + EPS)
    noise = est - ref
    ratio = torch.sum(scaled_target ** 2, dim=-1) / (torch.sum(noise ** 2, dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Plain SNR in dB."""
    noise = est - ref
    ratio = torch.sum(ref ** 2, dim=-1) / (torch.sum(noise ** 2, dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def pairwise_neg_si_sdr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(..., S_est, T) x (..., S_ref, T) -> (..., S_est, S_ref) loss matrix."""
    return -si_sdr(est[..., :, None, :], ref[..., None, :, :])


def freq_mae_wav_l1(est: torch.Tensor, ref: torch.Tensor, n_fft: int = 512, hop: int = 128,
                    alpha: float = 0.5) -> torch.Tensor:
    """Magnitude-spectrum MAE + waveform L1."""
    from ..ops.stft import stft

    est_mag = torch.abs(stft(est, n_fft, hop))
    ref_mag = torch.abs(stft(ref, n_fft, hop))
    return alpha * torch.mean(torch.abs(est_mag - ref_mag), dim=(-2, -1)) + (
        1.0 - alpha) * torch.mean(torch.abs(est - ref), dim=-1)


@lru_cache(maxsize=8)
def _perm_matrices(n: int) -> np.ndarray:
    """(n!, n, n) one-hot permutation matrices."""
    perms = list(permutations(range(n)))
    mats = np.zeros((len(perms), n, n), np.float32)
    for i, p in enumerate(perms):
        for row, col in enumerate(p):
            mats[i, row, col] = 1.0
    return mats


def pit_loss(loss_matrix: torch.Tensor, method: str = "auto"):
    """Permutation-invariant minimum of a (..., S, S) pairwise loss matrix.

    Returns (loss (...,), best_perm (..., S) int64). method: 'factorial'
    (all S! permutations at once, S <= 6), 'hungarian' (scipy's assignment
    on the host) or 'auto' (factorial for S <= 4, else hungarian)."""
    s = loss_matrix.shape[-1]
    if method == "auto":
        method = "factorial" if s <= 4 else "hungarian"
    if method == "factorial":
        mats = torch.from_numpy(_perm_matrices(s)).to(loss_matrix)
        costs = torch.einsum("...ij,pij->...p", loss_matrix, mats) / s
        best = torch.argmin(costs, dim=-1)
        loss = torch.take_along_dim(costs, best[..., None], dim=-1)[..., 0]
        perm_idx = torch.argmax(mats, dim=-1)  # (P, S)
        return loss, perm_idx[best]
    if method != "hungarian":
        raise ValueError(f"unknown PIT method {method!r}")
    from scipy.optimize import linear_sum_assignment

    flat = loss_matrix.detach().float().cpu().numpy().reshape(-1, s, s)
    perm = np.stack([linear_sum_assignment(m)[1] for m in flat]).reshape(
        loss_matrix.shape[:-2] + (s,))
    perm_t = torch.from_numpy(perm).to(loss_matrix.device)
    chosen = torch.take_along_dim(loss_matrix, perm_t[..., None], dim=-1)[..., 0]
    return chosen.mean(dim=-1), perm_t


def pit_si_sdr_loss(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Standard PIT -SI-SDR training loss: (B, S, T) x (B, S, T) -> scalar."""
    loss, _ = pit_loss(pairwise_neg_si_sdr(est, ref))
    return torch.mean(loss)


def mixit_loss(est: torch.Tensor, mixtures: torch.Tensor) -> torch.Tensor:
    """Mixture-invariant training: est (B, S, T) sources assigned to M = 2
    reference mixtures over all 2^S binary assignments; the best
    assignment's -SNR is the loss."""
    s = est.shape[1]
    if mixtures.shape[1] != 2:
        raise ValueError("MixIT takes 2 reference mixtures")
    n_assign = 2 ** s
    bits = ((np.arange(n_assign)[:, None] >> np.arange(s)[None, :]) & 1).astype(np.float32)
    assign = torch.from_numpy(np.stack([bits, 1.0 - bits], axis=1)).to(est)  # (A, 2, S)
    est_sums = torch.einsum("ams,bst->bamt", assign, est)  # (B, A, M, T)
    per_assign = torch.mean(-snr(est_sums, mixtures[:, None]), dim=-1)  # (B, A)
    return torch.mean(torch.min(per_assign, dim=-1).values)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels over the last axis:
    logsumexp(logits) - logits[label], one value a row."""
    label_logits = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits
