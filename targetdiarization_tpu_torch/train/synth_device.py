"""Synthesis of the bootstrap language on the device, inside the train step.

Counterpart of targetdiarization_tpu/train/synth_device.py: the language of
`train/synth.py` (additive formant synthesis, a sum of sinusoids) rendered
as tensor operations, so that every step of `bootstrap_asr(device_synth=
True)` trains on a fresh batch made where it is used. It matches
`synth.py::synth_char` in distribution (formant grid, duration classes,
f0 / phase / gain jitter, fricative band noise, attack / decay envelope,
gaps between characters), not sample for sample.

Each function is split in two: `draw_render` and `draw_noise` take every
random number from a `torch.Generator` (the JAX module's nine and three
draws, by name and shape), and `render_from_draws` and
`add_noise_from_draws` are deterministic functions of those draws, the JAX
module's arithmetic in its order. So the same draws give the JAX
package's audio, and a test can feed it the JAX draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .synth import BOOT_CHARS, SR, _char_params

# static per-char acoustic identity tables
_P = [_char_params(i) for i in range(len(BOOT_CHARS))]
CHAR_F1 = np.array([p["f1"] for p in _P], np.float32)
CHAR_F2 = np.array([p["f2"] for p in _P], np.float32)
CHAR_DUR = np.array([p["dur"] for p in _P], np.float32)
CHAR_FRIC = np.array([p["fricative"] for p in _P], np.float32)

BW = 130.0
K_MAX = 42  # max harmonics: int(4000 / 95)
J_NOISE = 128  # sinusoid components approximating the fricative band noise
U_MAX = 4608  # max unit samples: 0.26 s * 1.1 jitter * 16 kHz, padded


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def draw_render(gen: torch.Generator, b: int, c: int) -> dict:
    """render_batch's draws for b utterances of c character slots, on the
    generator's device: `dur` (B, C) in [0.9, 1.1), `f0` (B, C) in
    [95, 220), `phases` (K_MAX, B, C) and `nph` (B, C, J) in [0, 2 pi),
    `u_na` (B, C, J) in [0, 1), `gain` (B, C, 1) in [0.25, 0.6), `lead` and
    `tail` (B,) in [0.05, 0.15), `gaps` (B, C) in [0.02, 0.07)."""
    dev = gen.device
    return {"f0": _uniform(gen, (b, c), 95.0, 220.0, dev),
            "phases": _uniform(gen, (K_MAX, b, c), 0.0, 2 * np.pi, dev),
            "dur": _uniform(gen, (b, c), 0.9, 1.1, dev),
            "gain": _uniform(gen, (b, c, 1), 0.25, 0.6, dev),
            "gaps": _uniform(gen, (b, c), 0.02, 0.07, dev),
            "lead": _uniform(gen, (b,), 0.05, 0.15, dev),
            "u_na": _uniform(gen, (b, c, J_NOISE), 0.0, 1.0, dev),
            "nph": _uniform(gen, (b, c, J_NOISE), 0.0, 2 * np.pi, dev),
            "tail": _uniform(gen, (b,), 0.05, 0.15, dev)}


def render_from_draws(draws: dict, char_ids: torch.Tensor, n_chars: torch.Tensor,
                      n_samples: int) -> dict:
    """A batch of utterances from `draw_render`'s draws: char_ids (B, C)
    indices into BOOT_CHARS, n_chars (B,) valid counts. Returns `audio`
    (B, n_samples) float32, `starts` and `ends` (B, C) in seconds and
    `n_valid` (B,) int32 valid samples."""
    dev = char_ids.device
    b, c = char_ids.shape
    ids = char_ids.long()

    def table(a):
        return torch.as_tensor(a, device=dev)[ids]

    f1, f2, dur_b, fric = table(CHAR_F1), table(CHAR_F2), table(CHAR_DUR), table(CHAR_FRIC)
    dur = dur_b * draws["dur"]
    n_u = torch.floor(dur * SR)  # unit length in samples (B, C)
    f0 = draws["f0"]
    t_u = torch.arange(U_MAX, dtype=torch.float32, device=dev) / SR

    # voiced: a sum of harmonics
    kmax_c = torch.floor(4000.0 / f0)
    voiced = torch.zeros(b, c, U_MAX, device=dev)
    for k in range(1, K_MAX + 1):
        k1 = torch.tensor(float(k), device=dev)
        fk = k1 * f0
        amp = (torch.exp(-(((fk - f1) / BW) ** 2))
               + 0.7 * torch.exp(-(((fk - f2) / BW) ** 2))
               + 0.02 / k1) * (k1 <= kmax_c)
        voiced = voiced + amp[..., None] * torch.sin(
            2 * np.pi * fk[..., None] * t_u + draws["phases"][k - 1][..., None])

    # fricative: band noise as J random-phase sinusoids over both formant bands
    j = torch.arange(J_NOISE, dtype=torch.float32, device=dev) / (J_NOISE - 1)
    lo, hi = f1 - 4 * BW, f2 + 4 * BW
    fj = lo[..., None] + (hi - lo)[..., None] * j  # (B, C, J)
    shape = (torch.exp(-(((fj - f1[..., None]) / (2 * BW)) ** 2))
             + 0.8 * torch.exp(-(((fj - f2[..., None]) / (2 * BW)) ** 2)))
    # Rayleigh magnitudes by sqrt(-2 log1p(-u)): 1 - u never reaches 0
    mag = shape * torch.sqrt(-2.0 * torch.log1p(-draws["u_na"]))
    nph = draws["nph"]
    fricw = torch.zeros(b, c, U_MAX, device=dev)
    for idx in range(J_NOISE):
        fricw = fricw + mag[:, :, idx, None] * torch.sin(
            2 * np.pi * fj[:, :, idx, None] * t_u + nph[:, :, idx, None])

    unit = torch.where(fric[..., None] > 0, fricw, voiced)  # (B, C, U)

    # envelope, validity, peak normalization
    att = 0.02
    in_unit = t_u[None, None, :] < dur[..., None]
    env = torch.clamp(t_u[None, None, :] / att, 0.0, 1.0) * \
        torch.clamp((dur[..., None] - t_u[None, None, :]) / att, 0.0, 1.0)
    unit = unit * env * in_unit
    peak = unit.abs().amax(dim=-1, keepdim=True) + 1e-9
    unit = unit / peak * draws["gain"]

    # placement: lead silence and per-char gaps, starts by cumulative sum
    lead = torch.floor(draws["lead"] * SR)
    gaps = torch.floor(draws["gaps"] * SR)
    ch_mask = torch.arange(c, device=dev)[None, :] < n_chars[:, None]
    step = (n_u + gaps) * ch_mask
    starts = lead[:, None] + torch.cumsum(step, dim=1) - step

    t_idx = torch.arange(n_samples, dtype=torch.float32, device=dev)
    rel = t_idx[None, None, :] - starts[..., None]  # (B, C, N)
    reli = torch.clamp(rel.to(torch.int32), 0, U_MAX - 1).long()
    placed = torch.gather(unit, 2, reli)
    valid = (rel >= 0) & (rel < n_u[..., None]) & ch_mask[..., None]
    audio = (placed * valid).sum(dim=1)  # (B, N)

    tail = torch.floor(draws["tail"] * SR)
    last_end = starts + n_u * ch_mask
    n_valid = (last_end.amax(dim=1) + tail).to(torch.int32)
    n_valid = torch.clamp_max(n_valid, n_samples)
    return {"audio": audio, "starts": starts / SR, "ends": (starts + n_u) / SR,
            "n_valid": n_valid}


def render_batch(gen: torch.Generator, char_ids: torch.Tensor, n_chars: torch.Tensor,
                 n_samples: int) -> dict:
    """Draw from `gen` and render (`render_from_draws`)."""
    b, c = char_ids.shape
    return render_from_draws(draw_render(gen, b, c), char_ids, n_chars, n_samples)


def draw_noise(gen: torch.Generator, b: int, n: int, p_noise: float = 0.5,
               snr_lo: float = 12.0, snr_hi: float = 35.0) -> dict:
    """add_noise's draws: `on` (B,) bool with probability p_noise, `snr`
    (B,) dB in [snr_lo, snr_hi), `noise` (B, n) standard normal."""
    dev = gen.device
    return {"on": torch.rand((b,), generator=gen, device=dev) < p_noise,
            "snr": _uniform(gen, (b,), snr_lo, snr_hi, dev),
            "noise": torch.randn((b, n), generator=gen, device=dev)}


def add_noise_from_draws(draws: dict, audio: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """White noise at the drawn SNR over each row's valid samples, on the
    rows drawn on (synth_utterance's noise_snr_db)."""
    n = audio.shape[1]
    vmask = torch.arange(n, device=audio.device)[None, :] < n_valid[:, None]
    sig_p = ((audio * vmask) ** 2).sum(dim=1) / torch.clamp_min(vmask.sum(dim=1), 1)
    scale = torch.sqrt(sig_p * 10 ** (-draws["snr"] / 10.0) + 1e-18)
    return audio + draws["noise"] * (scale * draws["on"])[:, None] * vmask


def add_noise(gen: torch.Generator, audio: torch.Tensor, n_valid: torch.Tensor,
              p_noise: float = 0.5, snr_lo: float = 12.0, snr_hi: float = 35.0) -> torch.Tensor:
    """Draw from `gen` and add (`add_noise_from_draws`)."""
    b, n = audio.shape
    return add_noise_from_draws(draw_noise(gen, b, n, p_noise, snr_lo, snr_hi), audio, n_valid)
