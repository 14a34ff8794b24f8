"""AudioProcessor, separation part.

Counterpart of the separation stage of
targetdiarization_tpu/processors/audio.py::AudioProcessor. A separator
configured by path is loaded from that checkpoint or the constructor
raises; there is no random-weight stand-in. With no separator configured,
`separate_speaker` returns the input twice, as the reference does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.separation import SeparationEngine


class AudioProcessor:
    def __init__(self, separation_model: str = "", device: str | torch.device = "cuda",
                 compute_dtype: str | None = None, verbose_log: bool = False):
        self.verbose_log = verbose_log
        self.separator = None
        if separation_model:
            if not os.path.isdir(separation_model):
                raise FileNotFoundError(f"separation checkpoint {separation_model!r} not found")
            self.separator = SeparationEngine.from_pretrained(
                separation_model, device=device, compute_dtype=compute_dtype)

    def _log(self, msg: str):
        if self.verbose_log:
            print(msg)

    @property
    def is_separate_speaker(self) -> bool:
        return self.separator is not None

    def separate_speaker(self, audio_data: np.ndarray, sampling_rate: int = 16000) -> list:
        """[spk1, spk2] loudest first; with no separator, the input twice."""
        self._log("Running module: separate_speaker")
        if self.separator is None:
            a = np.asarray(audio_data, np.float32)
            return [a, a.copy()]
        out = self.separator.separate(audio_data, sr=sampling_rate)
        return [out[0], out[1]]
