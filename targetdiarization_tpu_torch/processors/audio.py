"""AudioProcessor: reading (paths, bytes, URLs) and writing, channels and
rate, level, the DSP toolbox (compression, silence, noise, mixing, EQ
matching, time stretch, pitch shift), preprocessing chains, and the neural
stages: denoising, separation, restoration and enhancement.

Counterpart of targetdiarization_tpu/processors/audio.py::AudioProcessor.
A model configured by path is loaded from that checkpoint or the
constructor raises; there is no random-weight stand-in. With no separator
configured, `separate_speaker` returns the input twice; with no denoiser,
`denoise_vocal` runs the spectral gate; with no restorer, `restore_audio`
returns its input; with no enhancer, `enhance_audio` restores, as the
reference does. A `mesh` (`parallel/mesh.py`) goes to the separation
engine, whose forwards then run row-sharded over its slots. Loudness is
metered on the host. The tensor work (resampling,
compression, mixing, the STFTs of `eq_match` and `audio_stretch`) runs on
the processor's device; the phase vocoder's loop and overlap-add stay on
the host in float32, as in the JAX package. Audio is read from PCM WAV
only (a path, a URL, bytes or `io.BytesIO`).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..models.denoise import QUALITY_HOP, DenoiseEngine, spectral_gate
from ..models.enhancement import PRIOR_STD, EnhancerEngine
from ..models.restoration import RestorationEngine
from ..models.separation import SeparationEngine
from ..ops import audio as A
from ..ops.resample import resample, resample_poly_np
from ..ops.stft import istft, stft
from ..runtime.trace import trace
from ..utils import audio_io
from ..utils.native import integrated_loudness_native


def _checkpoint(path: str, what: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{what} checkpoint {path!r} not found")
    return path


class AudioProcessor:
    def __init__(self, separation_model: str = "", denoise_model: str = "",
                 restoration_model: str = "", enhancement_model: str = "", quality: int = 2,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None,
                 verbose_log: bool = False, mesh=None):
        self.verbose_log = verbose_log
        self.quality = quality
        self.device = torch.device(device)
        self.separator = self.denoiser = self.restorer = self.enhancer = None
        if restoration_model:
            self.restorer = RestorationEngine.from_pretrained(
                _checkpoint(restoration_model, "restoration"), device=device,
                compute_dtype=compute_dtype)
        if separation_model:
            self.separator = SeparationEngine.from_pretrained(
                _checkpoint(separation_model, "separation"), device=device,
                compute_dtype=compute_dtype, mesh=mesh)
        if denoise_model:
            self.denoiser = DenoiseEngine.from_pretrained(
                _checkpoint(denoise_model, "denoise"), hop=QUALITY_HOP.get(quality, 1024),
                device=device, compute_dtype=compute_dtype)
        if enhancement_model:
            # the enhancer computes in float32 whatever the compute type, as
            # the JAX engine does
            self.enhancer = EnhancerEngine.from_pretrained(
                _checkpoint(enhancement_model, "enhancement"), device=device)

    def _log(self, msg: str):
        if self.verbose_log:
            print(msg)

    # ---------------- reading and writing ----------------

    @staticmethod
    def is_url(item) -> bool:
        return isinstance(item, str) and item.lower().startswith(("http://", "https://"))

    def read_audio(self, wav_file, sampling_rate: int | None = None):
        """(audio, rate) of a path or URL (PCM WAV, or any format ffmpeg
        decodes), or of PCM WAV bytes or `io.BytesIO`; an ndarray passes
        through (integer PCM scaled to [-1, 1]) at `sampling_rate` or
        16 kHz. A URL is fetched to a temporary file, read and deleted."""
        if isinstance(wav_file, np.ndarray):
            return self.int16_to_float32(wav_file), sampling_rate or 16000
        if self.is_url(wav_file):
            local = self.download_audio(wav_file)
            try:
                return audio_io.read_audio(local, sample_rate=sampling_rate)
            finally:
                try:
                    os.unlink(local)
                except OSError:
                    pass
        return audio_io.read_audio(wav_file, sample_rate=sampling_rate)

    def download_audio(self, url: str, output_dir: str | None = None) -> str:
        """The path of `url` fetched into `output_dir` (the temporary
        directory by default), named td_<8 hex>_<last path segment without
        query or fragment>, with ".wav" where that name has no extension.
        A failed fetch deletes the partial file and raises RuntimeError."""
        import urllib.request
        import uuid

        base = os.path.basename(url.split("?")[0].split("#")[0].rstrip("/"))
        if "." not in base:
            base = (base or "audio") + ".wav"
        name = os.path.join(output_dir or tempfile.gettempdir(),
                            f"td_{uuid.uuid4().hex[:8]}_{base}")
        try:
            urllib.request.urlretrieve(url, name)
        except Exception as e:
            try:
                os.unlink(name)
            except OSError:
                pass
            raise RuntimeError(f"download failed for {url!r}: {e}") from e
        return name

    def write_to_file(self, audio_data, sampling_rate: int, output_file: str) -> str:
        """`utils.audio_io.write_audio` of the audio; returns the path."""
        audio_io.write_audio(output_file, np.asarray(audio_data), sampling_rate)
        return output_file

    # ---------------- converters, channels, rate ----------------

    @staticmethod
    def int16_to_float32(x: np.ndarray) -> np.ndarray:
        """Integer PCM scaled to [-1, 1]; float input unchanged, as float32."""
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return (x.astype(np.float32) / 32768.0).astype(np.float32)
        return x.astype(np.float32)

    @staticmethod
    def float32_to_int16(x: np.ndarray) -> np.ndarray:
        """x32768, clipped to the int16 range, truncated toward zero."""
        return np.clip(np.asarray(x) * 32768.0, -32768, 32767).astype(np.int16)

    def audio_to_mono(self, audio_data: np.ndarray) -> np.ndarray:
        """Float32 mono; several channels are mixed down with the layout
        rules of `ops.audio.to_mono` (5.1 and 7.1 included)."""
        audio_data = self.int16_to_float32(audio_data)
        if audio_data.ndim == 1:
            return audio_data
        return A.to_mono(torch.from_numpy(audio_data)).numpy()

    @staticmethod
    def mono_to_stereo(audio_data: np.ndarray) -> np.ndarray:
        """(T,) -> (T, 2) float32; other shapes pass through as float32."""
        a = np.asarray(audio_data, np.float32)
        return np.stack([a, a], axis=1) if a.ndim == 1 else a

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
        """Integrated loudness (BS.1770, LUFS) by the host library's meter
        (`utils/native.py`); -inf below one 400 ms block."""
        a = np.asarray(audio_data, np.float32)
        if a.size < int(0.4 * sampling_rate):
            return float("-inf")
        return integrated_loudness_native(a, sampling_rate)

    def audio_loudness_control(self, audio_data: np.ndarray, sampling_rate: int,
                               target_loudness: float = -23.0) -> np.ndarray:
        """Gain to `target_loudness` LUFS; unchanged below one block or in
        silence."""
        a = np.asarray(audio_data, np.float32)
        if a.size < int(0.4 * sampling_rate):
            return a
        measured = integrated_loudness_native(a, sampling_rate)
        if not np.isfinite(measured):
            return a
        return a * np.float32(10.0 ** ((target_loudness - measured) / 20.0))

    def audio_gain(self, audio_data: np.ndarray, gain_db: float) -> np.ndarray:
        return A.apply_gain_db(torch.from_numpy(np.asarray(audio_data, np.float32)),
                               gain_db).numpy()

    def audio_normalize(self, audio_data: np.ndarray, peak_db: float = -1.0) -> np.ndarray:
        return A.peak_normalize(torch.from_numpy(np.asarray(audio_data, np.float32)),
                                peak_db).numpy()

    def _tensor(self, audio_data) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(audio_data, np.float32)).to(self.device)

    def audio_compress(self, audio_data: np.ndarray, threshold_db: float = -20.0,
                       ratio: float = 4.0) -> np.ndarray:
        """A static curve: each sample's level above `threshold_db` dBFS is
        reduced by the factor `ratio`."""
        with torch.inference_mode():
            a = self._tensor(audio_data)
            over = torch.clamp_min(A.gain_to_db(a.abs() + 1e-12) - threshold_db, 0.0)
            return (a * A.db_to_gain(-over * (1.0 - 1.0 / ratio))).cpu().numpy()

    # ---------------- silence ----------------

    def split_audio_by_silence(self, audio_data: np.ndarray, sampling_rate: int,
                               silence_thresh_db: float = -30.0, min_silence_sec: float = 0.5,
                               min_chunk_sec: float = 5.0) -> list:
        """Chunks cut at the centres of runs of 20 ms windows whose RMS is
        below `silence_thresh_db`, each run at least `min_silence_sec`
        long, where the chunk so far holds at least `min_chunk_sec`."""
        a = np.asarray(audio_data, np.float32)
        win = max(1, int(0.02 * sampling_rate))
        n_win = len(a) // win
        if n_win == 0:
            return [a] if a.size else []
        frames = a[: n_win * win].reshape(n_win, win)
        db = 20 * np.log10(np.sqrt(np.mean(frames ** 2, axis=1)) + 1e-12)
        silent = db < silence_thresh_db
        min_run = max(1, int(min_silence_sec / 0.02))
        cuts = []
        run = 0
        for i, quiet in enumerate(silent):
            run = run + 1 if quiet else 0
            if run == min_run:
                cuts.append(i - min_run // 2)
        chunks = []
        prev = 0
        min_chunk = int(min_chunk_sec * sampling_rate)
        for c in cuts:
            pos = c * win
            if pos - prev >= min_chunk:
                chunks.append(a[prev:pos])
                prev = pos
        chunks.append(a[prev:])
        return [c for c in chunks if c.size]

    def remove_silence(self, audio_data: np.ndarray, sampling_rate: int,
                       silence_thresh_db: float = -30.0, min_silence_sec: float = 0.5,
                       min_chunk_sec: float = 5.0) -> np.ndarray:
        """The chunks of `split_audio_by_silence`, joined again."""
        return self.combine_audio_chunks(self.split_audio_by_silence(
            audio_data, sampling_rate, silence_thresh_db, min_silence_sec, min_chunk_sec))

    # ---------------- synthesis, mixing, spectra ----------------

    @staticmethod
    def generate_noise(duration_sec: float, sampling_rate: int, noise_type: str = "white",
                       amplitude: float = 0.01, seed: int = 0) -> np.ndarray:
        """White, pink (1/sqrt(f) in the spectrum) or brown (integrated)
        noise from numpy's `default_rng(seed)`, peak `amplitude`."""
        rng = np.random.default_rng(seed)
        n = int(duration_sec * sampling_rate)
        white = rng.standard_normal(n).astype(np.float32)
        if noise_type == "white":
            out = white
        elif noise_type == "pink":
            spec = np.fft.rfft(white)
            f = np.maximum(np.arange(len(spec)), 1.0)
            out = np.fft.irfft(spec / np.sqrt(f), n=n).astype(np.float32)
        elif noise_type == "brown":
            out = np.cumsum(white).astype(np.float32)
        else:
            raise ValueError(f"unknown noise type {noise_type!r}")
        peak = np.max(np.abs(out)) or 1.0
        return out / peak * amplitude

    def mix_audio(self, audio_a: np.ndarray, audio_b: np.ndarray,
                  snr_db: float | None = None) -> np.ndarray:
        """a + b, the shorter zero-padded; with `snr_db`, b scaled to sit
        that far below a by RMS."""
        a, b = np.asarray(audio_a, np.float32), np.asarray(audio_b, np.float32)
        n = max(len(a), len(b))
        with torch.inference_mode():
            return A.mix_audio(self._tensor(np.pad(a, (0, n - len(a)))),
                               self._tensor(np.pad(b, (0, n - len(b)))), snr_db).cpu().numpy()

    @staticmethod
    def mix_audio_by_freq(audio_a: np.ndarray, audio_b: np.ndarray, sampling_rate: int,
                          crossover_hz: float = 1000.0) -> np.ndarray:
        """The bins of a up to `crossover_hz` and those of b above it, over
        the whole clip (numpy's FFT)."""
        a, b = np.asarray(audio_a, np.float32), np.asarray(audio_b, np.float32)
        n = max(len(a), len(b))
        a, b = np.pad(a, (0, n - len(a))), np.pad(b, (0, n - len(b)))
        lo = np.fft.rfftfreq(n, 1.0 / sampling_rate) <= crossover_hz
        return np.fft.irfft(np.where(lo, np.fft.rfft(a), np.fft.rfft(b)), n=n).astype(np.float32)

    def eq_match(self, source_audio: np.ndarray, target_audio: np.ndarray, sampling_rate: int,
                 n_fft: int = 2048, smooth: int = 9) -> np.ndarray:
        """The source shaped toward the target's long-term mean magnitude
        spectrum: the ratio of the two means, smoothed over `smooth` bins
        on the host, applied to the source's STFT on the device."""
        hop = n_fft // 4
        with torch.inference_mode():
            s_spec = stft(self._tensor(source_audio), n_fft, hop)
            t_spec = stft(self._tensor(target_audio), n_fft, hop)
            s_mag = s_spec.abs().mean(dim=-1).cpu().numpy()
            t_mag = t_spec.abs().mean(dim=-1).cpu().numpy()
            curve = (t_mag + 1e-8) / (s_mag + 1e-8)
            if smooth > 1:
                curve = np.convolve(curve, np.ones(smooth) / smooth, mode="same")
            gain = torch.from_numpy(curve.astype(np.float32)).to(self.device)
            return istft(s_spec * gain[:, None], n_fft, hop,
                         length=len(source_audio)).cpu().numpy()

    def audio_stretch(self, audio_data: np.ndarray, sampling_rate: int,
                      rate: float) -> np.ndarray:
        """Phase-vocoder time stretch by `rate` (above 1: shorter). The STFT
        (n_fft 2048, hop 512) runs on the device; the phase advance, the
        inverse FFTs and the overlap-add run on the host."""
        if rate == 1.0:
            return np.asarray(audio_data, np.float32)
        n_fft, hop = 2048, 512
        with torch.inference_mode():
            spec_dev = stft(self._tensor(audio_data), n_fft, hop)
            spec = spec_dev.real.cpu().numpy() + 1j * spec_dev.imag.cpu().numpy()
        steps = np.arange(0, spec.shape[-1] - 1, rate)
        phase = np.angle(spec[:, 0])
        out = np.zeros((spec.shape[0], len(steps)), np.complex64)
        two_pi_hop = 2 * np.pi * hop * np.arange(spec.shape[0]) / n_fft
        for i, t in enumerate(steps):
            lo = int(t)
            frac = t - lo
            mag = (1 - frac) * np.abs(spec[:, lo]) + frac * np.abs(spec[:, lo + 1])
            out[:, i] = mag * np.exp(1j * phase)
            dphase = np.angle(spec[:, lo + 1]) - np.angle(spec[:, lo]) - two_pi_hop
            dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
            phase = phase + two_pi_hop + dphase
        frames = np.fft.irfft(out.T, n=n_fft, axis=-1)  # (n_out, n_fft)
        win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
        frames *= win
        out_len = (frames.shape[0] - 1) * hop + n_fft
        y = np.zeros(out_len, np.float32)
        wsum = np.zeros(out_len, np.float32)
        for fi in range(frames.shape[0]):
            y[fi * hop: fi * hop + n_fft] += frames[fi]
            wsum[fi * hop: fi * hop + n_fft] += win * win
        y /= np.maximum(wsum, 1e-8)
        return y[n_fft // 2: -(n_fft // 2)].astype(np.float32)

    def audio_pitch_shift(self, audio_data: np.ndarray, sampling_rate: int,
                          n_semitones: float) -> np.ndarray:
        """Stretch by 2^(-n/12), then resample by the same factor (the
        polyphase filter on the host), cut or zero-padded to the input's
        length."""
        if n_semitones == 0:
            return np.asarray(audio_data, np.float32)
        factor = 2.0 ** (n_semitones / 12.0)
        stretched = self.audio_stretch(audio_data, sampling_rate, 1.0 / factor)
        out = resample_poly_np(stretched, int(sampling_rate / factor), sampling_rate)
        n = len(audio_data)
        return out[:n] if len(out) >= n else np.pad(out, (0, n - len(out)))

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

    def enhance_audio(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                      nfe: int | None = None, lambd: float = 0.9,
                      tau: float | None = None) -> np.ndarray:
        """The flow enhancer with the reference's knobs: nfe by the quality
        preset (1, 64 or 128 solver steps for quality 1, 2 or 3), lambd 0.9,
        tau PRIOR_STD; with no enhancer, `restore_audio`."""
        self._log("Running module: enhance_audio")
        with trace("audio/enhance_audio"):
            if self.enhancer is None:
                return self.restore_audio(audio_data, sampling_rate)
            if nfe is None:
                nfe = {1: 1, 2: 64, 3: 128}.get(self.quality, 64)
            return self.enhancer.enhance(audio_data, sr=sampling_rate, nfe=nfe, lambd=lambd,
                                         tau=PRIOR_STD if tau is None else tau)

    def run_modules(self, audio_data: np.ndarray, sampling_rate: int,
                    modules: list) -> np.ndarray:
        """A chain of stages, in order: dict entries {method_name: kwargs}
        called as method(audio, **kwargs), or the short names "denoise",
        "separate", "restore", "enhance", "loudness" and "normalize" (the
        rate passed where the stage takes one). A separating stage passes
        its louder stream on; an unknown name is skipped."""
        aliases = {"denoise": "denoise_vocal", "separate": "separate_speaker",
                   "restore": "restore_audio", "enhance": "enhance_audio",
                   "loudness": "audio_loudness_control", "normalize": "audio_normalize"}
        out = np.asarray(audio_data, np.float32)
        for mod in modules:
            calls = (mod.items() if isinstance(mod, dict)
                     else [(aliases.get(mod, mod), None)])
            for name, params in calls:
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
