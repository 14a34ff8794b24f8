"""AudioProcessor: reading, channels and rate, preprocessing (denoise,
loudness, gain, peak normalization, module chains), separation and
restoration.

Counterpart of targetdiarization_tpu/processors/audio.py::AudioProcessor,
less its DSP toolbox off the main path. A model configured by path is
loaded from that checkpoint or the constructor raises; there is no
random-weight stand-in. With no separator configured, `separate_speaker`
returns the input twice; with no denoiser, `denoise_vocal` runs the
spectral gate; with no restorer, `restore_audio` returns its input, as
the reference does. Loudness is metered on the host; gain and peak
normalization are elementwise on the host. Audio is read from PCM WAV
only (a path, bytes or `io.BytesIO`). Enhancement is not ported:
`run_modules` raises for it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.denoise import QUALITY_HOP, DenoiseEngine, spectral_gate
from ..models.restoration import RestorationEngine
from ..models.separation import SeparationEngine
from ..ops import audio as A
from ..ops.loudness import integrated_loudness
from ..ops.resample import resample
from ..runtime.trace import trace
from ..utils import audio_io

_UNPORTED = {"enhance_audio"}


def _checkpoint(path: str, what: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{what} checkpoint {path!r} not found")
    return path


class AudioProcessor:
    def __init__(self, separation_model: str = "", denoise_model: str = "",
                 restoration_model: str = "", quality: int = 2,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None,
                 verbose_log: bool = False):
        self.verbose_log = verbose_log
        self.quality = quality
        self.device = torch.device(device)
        self.separator = self.denoiser = self.restorer = None
        if restoration_model:
            self.restorer = RestorationEngine.from_pretrained(
                _checkpoint(restoration_model, "restoration"), device=device,
                compute_dtype=compute_dtype)
        if separation_model:
            self.separator = SeparationEngine.from_pretrained(
                _checkpoint(separation_model, "separation"), device=device,
                compute_dtype=compute_dtype)
        if denoise_model:
            self.denoiser = DenoiseEngine.from_pretrained(
                _checkpoint(denoise_model, "denoise"), hop=QUALITY_HOP.get(quality, 1024),
                device=device, compute_dtype=compute_dtype)

    def _log(self, msg: str):
        if self.verbose_log:
            print(msg)

    # ---------------- reading, channels, rate ----------------

    def read_audio(self, wav_file, sampling_rate: int | None = None):
        """(audio, rate) of a WAV path, bytes or `io.BytesIO`; an ndarray
        passes through (integer PCM scaled to [-1, 1]) at `sampling_rate`
        or 16 kHz."""
        if isinstance(wav_file, np.ndarray):
            return self.int16_to_float32(wav_file), sampling_rate or 16000
        return audio_io.read_audio(wav_file, sample_rate=sampling_rate)

    @staticmethod
    def int16_to_float32(x: np.ndarray) -> np.ndarray:
        """Integer PCM scaled to [-1, 1]; float input unchanged, as float32."""
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return (x.astype(np.float32) / 32768.0).astype(np.float32)
        return x.astype(np.float32)

    def audio_to_mono(self, audio_data: np.ndarray) -> np.ndarray:
        """Float32 mono; several channels are mixed down with the layout
        rules of `ops.audio.to_mono` (5.1 and 7.1 included)."""
        audio_data = self.int16_to_float32(audio_data)
        if audio_data.ndim == 1:
            return audio_data
        return A.to_mono(torch.from_numpy(audio_data)).numpy()

    def audio_resample(self, audio_data: np.ndarray, orig_sr: int, target_sr: int):
        """(audio at target_sr, target_sr), by the polyphase filter on the device."""
        if orig_sr == target_sr:
            return np.asarray(audio_data, np.float32), orig_sr
        with torch.inference_mode():
            x = torch.from_numpy(np.asarray(audio_data, np.float32)).to(self.device)
            return resample(x, target_sr, orig_sr).cpu().numpy(), target_sr

    @staticmethod
    def split_audio_by_time(audio_data: np.ndarray, sampling_rate: int, start_time: float,
                            end_time: float) -> np.ndarray:
        s = max(0, int(start_time * sampling_rate))
        e = min(len(audio_data), int(end_time * sampling_rate))
        return np.asarray(audio_data[s:e])

    @staticmethod
    def combine_audio_chunks(chunks: list) -> np.ndarray:
        """The chunks one after the other (float32 zeros of length 0 for none)."""
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate([np.asarray(c) for c in chunks], axis=0)

    # ---------------- level ----------------

    def meter_loudness(self, audio_data: np.ndarray, sampling_rate: int) -> float:
        """Integrated loudness (BS.1770, LUFS); -inf below one 400 ms block."""
        a = np.asarray(audio_data, np.float32)
        if a.size < int(0.4 * sampling_rate):
            return float("-inf")
        return integrated_loudness(a, sampling_rate)

    def audio_loudness_control(self, audio_data: np.ndarray, sampling_rate: int,
                               target_loudness: float = -23.0) -> np.ndarray:
        """Gain to `target_loudness` LUFS; unchanged below one block or in
        silence."""
        a = np.asarray(audio_data, np.float32)
        if a.size < int(0.4 * sampling_rate):
            return a
        measured = integrated_loudness(a, sampling_rate)
        if not np.isfinite(measured):
            return a
        return a * np.float32(10.0 ** ((target_loudness - measured) / 20.0))

    def audio_gain(self, audio_data: np.ndarray, gain_db: float) -> np.ndarray:
        return A.apply_gain_db(torch.from_numpy(np.asarray(audio_data, np.float32)),
                               gain_db).numpy()

    def audio_normalize(self, audio_data: np.ndarray, peak_db: float = -1.0) -> np.ndarray:
        return A.peak_normalize(torch.from_numpy(np.asarray(audio_data, np.float32)),
                                peak_db).numpy()

    # ---------------- neural stages ----------------

    @property
    def is_denoise_vocal(self) -> bool:
        return self.denoiser is not None

    @property
    def is_separate_speaker(self) -> bool:
        return self.separator is not None

    @property
    def is_restore_audio(self) -> bool:
        return self.restorer is not None

    def denoise_vocal(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                      fast_mode: bool = False) -> np.ndarray:
        """Vocals by the MDX denoiser; the spectral gate with `fast_mode` or
        without a denoiser."""
        self._log("Running module: denoise_vocal")
        if self.denoiser is None or fast_mode:
            with torch.inference_mode():
                x = torch.from_numpy(np.asarray(audio_data, np.float32)).to(self.device)
                return spectral_gate(x).cpu().numpy()
        return self.denoiser.denoise_vocal(audio_data, sr=sampling_rate)

    def separate_speaker(self, audio_data: np.ndarray, sampling_rate: int = 16000) -> list:
        """[spk1, spk2] loudest first; with no separator, the input twice."""
        self._log("Running module: separate_speaker")
        with trace("audio/separate_speaker"):
            if self.separator is None:
                a = np.asarray(audio_data, np.float32)
                return [a, a.copy()]
            out = self.separator.separate(audio_data, sr=sampling_rate)
            return [out[0], out[1]]

    def restore_audio(self, audio_data: np.ndarray, sampling_rate: int = 16000) -> np.ndarray:
        """Apollo restoration (`RestorationEngine.restore`); with no restorer,
        the input as float32."""
        self._log("Running module: restore_audio")
        with trace("audio/restore_audio"):
            if self.restorer is None:
                return np.asarray(audio_data, np.float32)
            return self.restorer.restore(audio_data, sr=sampling_rate)

    def run_modules(self, audio_data: np.ndarray, sampling_rate: int,
                    modules: list) -> np.ndarray:
        """A chain of stages, in order: dict entries {method_name: kwargs}
        called as method(audio, **kwargs), or the short names "denoise",
        "separate", "loudness" and "normalize" (the rate passed where the
        stage takes one). A separating stage passes its louder stream on;
        an unknown name is skipped; enhancement raises."""
        aliases = {"denoise": "denoise_vocal", "separate": "separate_speaker",
                   "restore": "restore_audio", "enhance": "enhance_audio",
                   "loudness": "audio_loudness_control", "normalize": "audio_normalize"}
        out = np.asarray(audio_data, np.float32)
        for mod in modules:
            calls = (mod.items() if isinstance(mod, dict)
                     else [(aliases.get(mod, mod), None)])
            for name, params in calls:
                if name in _UNPORTED:
                    raise NotImplementedError(f"{name} is not ported")
                method = getattr(self, name, None)
                if method is None:
                    self._log(f"Method {name} not exists.")
                    continue
                if isinstance(mod, dict):
                    out = method(out, **dict(params or {}))
                elif mod == "normalize":
                    out = method(out)
                else:
                    out = method(out, sampling_rate)
                if name == "separate_speaker":
                    out = out[0]
        return out
