"""Dynamic-mixing data module for separation training.

Counterpart of targetdiarization_tpu/train/data.py, numpy on the host:
random speaker pairs mixed on the fly with SIR in [-6, 6] dB, optional
noise at SNR in [10, 20] dB, silence rejection, fixed-length segments
(the reference's MovingDataModule). The draws are the JAX package's: the
same seed gives the same batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.audio_io import read_audio


@dataclass
class MixConfig:
    sample_rate: int = 16000
    segment_seconds: float = 4.0
    sir_range: tuple = (-6.0, 6.0)  # speaker-to-speaker ratio (dB)
    snr_range: tuple = (10.0, 20.0)  # mix-to-noise ratio (dB)
    add_noise: bool = False
    silence_rms_threshold: float = 1e-3  # reject near-silent crops
    max_retries: int = 10


class DynamicMixDataset:
    """On-the-fly 2-speaker mixtures from per-speaker audio pools.

    `speaker_files`: {speaker_id: [wav paths or float32 arrays]}.
    """

    def __init__(self, speaker_files: dict, cfg: MixConfig | None = None,
                 seed: int = 0):
        self.cfg = cfg or MixConfig()
        self.rng = np.random.default_rng(seed)
        self.speakers = {
            k: list(v) for k, v in speaker_files.items() if len(v) > 0
        }
        if len(self.speakers) < 2:
            raise ValueError("need at least two speakers for dynamic mixing")
        self._cache: dict = {}

    def _load(self, item) -> np.ndarray:
        if isinstance(item, np.ndarray):
            return item.astype(np.float32)
        key = os.fspath(item)
        if key not in self._cache:
            audio, sr = read_audio(key)
            if audio.ndim > 1:
                audio = audio.mean(axis=0)
            if sr != self.cfg.sample_rate:
                from ..ops.resample import resample_poly_np

                audio = resample_poly_np(audio, self.cfg.sample_rate, sr)
            self._cache[key] = audio.astype(np.float32)
        return self._cache[key]

    def _crop(self, audio: np.ndarray, n: int) -> np.ndarray:
        if len(audio) <= n:
            return np.pad(audio, (0, n - len(audio)))
        start = int(self.rng.integers(0, len(audio) - n))
        return audio[start: start + n]

    def _pick_voiced(self, spk: str, n: int) -> np.ndarray:
        for _ in range(self.cfg.max_retries):
            item = self.speakers[spk][int(self.rng.integers(len(self.speakers[spk])))]
            crop = self._crop(self._load(item), n)
            if np.sqrt(np.mean(crop**2)) >= self.cfg.silence_rms_threshold:
                return crop
        return crop  # give up after retries (reference rejection loop :84-99)

    def sample(self):
        """One (mixture (T,), sources (2, T)) example."""
        n = int(self.cfg.segment_seconds * self.cfg.sample_rate)
        spk_a, spk_b = self.rng.choice(list(self.speakers), size=2, replace=False)
        a = self._pick_voiced(spk_a, n)
        b = self._pick_voiced(spk_b, n)
        # scale b for the sampled SIR
        sir = self.rng.uniform(*self.cfg.sir_range)
        rms_a = np.sqrt(np.mean(a**2)) + 1e-9
        rms_b = np.sqrt(np.mean(b**2)) + 1e-9
        b = b * (rms_a / rms_b) * (10.0 ** (-sir / 20.0))
        mix = a + b
        if self.cfg.add_noise:
            snr = self.rng.uniform(*self.cfg.snr_range)
            noise = self.rng.standard_normal(n).astype(np.float32)
            rms_m = np.sqrt(np.mean(mix**2)) + 1e-9
            noise *= rms_m / (np.sqrt(np.mean(noise**2)) + 1e-9) * (
                10.0 ** (-snr / 20.0)
            )
            mix = mix + noise
        peak = np.max(np.abs(mix))
        if peak > 1.0:
            mix, a, b = mix / peak, a / peak, b / peak
        return mix.astype(np.float32), np.stack([a, b]).astype(np.float32)

    def batches(self, batch_size: int, steps: int):
        """Yield `steps` fixed-shape batches {'mix': (B, T), 'src': (B, 2, T)}."""
        for _ in range(steps):
            mixes, srcs = zip(*(self.sample() for _ in range(batch_size)))
            yield {"mix": np.stack(mixes), "src": np.stack(srcs)}
