"""FSMN voice-activity detection: the model and its segmenting engine.

Counterpart of targetdiarization_tpu/models/vad.py. Stacked cFSMN blocks
(down-projection, a depthwise memory conv with left context `lorder` and
lookahead `rorder`, up-projection, residual) end in a 2-class frame
classifier at 100 frames a second. The memory conv runs `ops.dwconv`
with explicit pads (lorder, rorder), on the masked projection. The host
state machine (hysteresis, silence close, padding, clip merge and split)
is the JAX package's, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn

from ..ops.dwconv import dw_conv1d
from ..ops.kernels import prepare_kernels
from ..ops.kernels.dwconv import prepare_taps
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import dequantize_audio, quantize_i16, resolve_compute_dtype
from . import features


class FsmnBlock(nn.Module):
    """down -> mask -> p + memory(p) -> up -> ReLU -> (x + h) * mask."""

    def __init__(self, hidden: int = 128, proj: int = 64, lorder: int = 10, rorder: int = 2,
                 dilation: int = 1):
        super().__init__()
        self.lorder, self.rorder, self.dilation = lorder, rorder, dilation
        self.down = nn.Linear(hidden, proj, bias=False)
        self.memory = nn.Parameter(torch.zeros(lorder + rorder + 1, 1, proj))
        self.up = nn.Linear(proj, hidden)
        self.memory_taps = None

    def prepare_kernel(self, owner: str = ""):
        self.memory_taps = prepare_taps(self.memory, owner)

    def forward(self, x, mask):
        # x (B, T, hidden), mask (B, T, 1)
        p = self.down(x) * mask
        mem = dw_conv1d(p, self.memory, dilation=self.dilation,
                        padding=(self.lorder * self.dilation, self.rorder * self.dilation),
                        taps=self.memory_taps)
        h = torch.relu(self.up(p + mem))
        return (x + h) * mask


class FsmnVADNet(nn.Module):
    """Frame-level speech / non-speech classifier at 100 fps."""

    def __init__(self, in_dim: int = 80, hidden: int = 128, proj: int = 64, n_layers: int = 4,
                 lorder: int = 10, rorder: int = 2):
        super().__init__()
        self.in_dim = in_dim
        self.in_proj = nn.Linear(in_dim, hidden)
        self.blocks = nn.ModuleList(
            [FsmnBlock(hidden, proj, lorder, rorder) for _ in range(n_layers)])
        self.out_proj = nn.Linear(hidden, 2)

    def forward(self, feats, lengths):
        """feats (B, T, in_dim), lengths (B,) -> logits (B, T, 2); the
        speech probability is softmax[..., 1]."""
        t = feats.shape[1]
        mask = (torch.arange(t, device=feats.device)[None, :]
                < lengths[:, None]).to(feats.dtype)[..., None]
        x = torch.relu(self.in_proj(feats)) * mask
        for block in self.blocks:
            x = block(x, mask)
        return self.out_proj(x)


@dataclass
class VADConfig:
    """Segmenting knobs (the reference's FunASR VAD settings)."""

    threshold_on: float = 0.5
    threshold_off: float = 0.35
    max_end_silence_time: float = 0.8  # s of silence that closes a segment
    min_speech_duration: float = 0.1   # drop shorter blips
    speech_pad: float = 0.05           # s padded on both sides
    min_clip_sec: float = 0.0          # merge clips shorter than this
    max_clip_sec: float = 0.0          # split clips longer than this (0 = off)


SR = 16000
_SAMPLE_LADDER = BucketLadder(tuple(int(s * SR) for s in (1, 2, 4, 8, 16, 30)))


class VADEngine:
    """Frame probabilities on the device, segments on the host. Audio goes
    up as int16 in one padded batch per call (1 s .. 30 s rungs; longer
    audio is windowed at 30 s)."""

    def __init__(self, model: FsmnVADNet, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()
        prepare_kernels(self.model)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "VADEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype)

    def _probs(self, batch: np.ndarray, lengths: list) -> np.ndarray:
        """(rows, bucket) float audio -> (rows, frames) float32 speech
        probabilities, in one forward."""
        with torch.inference_mode():
            audio = torch.from_numpy(quantize_i16(batch)).to(self.device)
            feats = features.fbank(dequantize_audio(audio)).to(self.compute_dtype)
            lens = torch.tensor(lengths, device=self.device)
            logits = self.model(feats, lens)
            return torch.softmax(logits.float(), dim=-1)[..., 1].cpu().numpy()

    def frame_probs(self, audio: np.ndarray, sr: int = SR) -> np.ndarray:
        """Speech probability per 10 ms frame."""
        audio = np.asarray(audio, np.float32)
        if sr != SR:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, SR, sr)
        top = _SAMPLE_LADDER.rungs[-1]
        if len(audio) > top:
            parts = [self.frame_probs(audio[i: i + top]) for i in range(0, len(audio), top)]
            return np.concatenate(parts) if parts else np.zeros(0, np.float32)
        t = features.num_frames(len(audio))
        if t == 0:
            return np.zeros(0, np.float32)
        padded = pad_to(audio, _SAMPLE_LADDER.bucket(len(audio)))[None]
        return self._probs(padded, [t])[0, :t]

    def frame_probs_batch(self, clips: list, sr: int = SR) -> list:
        """Frame probabilities for several clips in one forward, all padded
        to the rung of the longest."""
        clips = [np.asarray(c, np.float32) for c in clips]
        if sr != SR:
            from ..ops.resample import resample_poly_np

            clips = [resample_poly_np(c, SR, sr) for c in clips]
        top = _SAMPLE_LADDER.rungs[-1]
        if not clips or any(len(c) > top for c in clips):
            return [self.frame_probs(c) for c in clips]
        ts = [features.num_frames(len(c)) for c in clips]
        if all(t == 0 for t in ts):
            return [np.zeros(0, np.float32) for _ in clips]
        bucket = _SAMPLE_LADDER.bucket(max(len(c) for c in clips))
        probs = self._probs(np.stack([pad_to(c, bucket) for c in clips]),
                            [max(t, 1) for t in ts])
        return [probs[i, :t] for i, t in enumerate(ts)]

    def vad_detection_batch(self, clips: list, sr: int = SR, cfg: VADConfig | None = None,
                            **over) -> list:
        """[[start_s, end_s], ...] per clip, from one forward."""
        cfg = replace(cfg or VADConfig(), **over)
        out = []
        for clip, probs in zip(clips, self.frame_probs_batch(clips, sr)):
            segs = segment_probs(probs, cfg, fps=100.0)
            dur = len(clip) / sr
            segs = [[max(0.0, s), min(dur, e)] for s, e in segs]
            if cfg.min_clip_sec > 0:
                segs = merge_short_clips(segs, cfg.min_clip_sec)
            if cfg.max_clip_sec > 0:
                segs = split_long_clips(segs, cfg.max_clip_sec)
            out.append(segs)
        return out

    def vad_detection(self, audio: np.ndarray, sr: int = SR, cfg: VADConfig | None = None,
                      **over) -> list:
        """[[start_s, end_s], ...] speech segments; keyword overrides of
        VADConfig apply to this call only."""
        return self.vad_detection_batch([audio], sr=sr, cfg=cfg, **over)[0]

    def get_speech_timestamps(self, audio: np.ndarray, sr: int = SR,
                              return_seconds: bool = False, **over) -> list:
        """silero-vad's form: [{"start", "end"}, ...] in samples at `sr`
        (truncated), or in seconds with `return_seconds`."""
        segs = self.vad_detection(audio, sr=sr, **over)
        if return_seconds:
            return [{"start": s, "end": e} for s, e in segs]
        return [{"start": int(s * sr), "end": int(e * sr)} for s, e in segs]

    def is_speech(self, audio: np.ndarray, sr: int = SR, min_ratio: float = 0.1) -> bool:
        """At least `min_ratio` of the frames above 0.5 speech probability."""
        probs = self.frame_probs(audio, sr=sr)
        if probs.size == 0:
            return False
        return float(np.mean(probs > 0.5)) >= min_ratio


# ---------------- host-side state machine ----------------


def segment_probs(probs: np.ndarray, cfg: VADConfig, fps: float = 100.0) -> list:
    """Hysteresis segmentation of a frame-probability track -> [[s, e], ...] s."""
    max_sil = int(round(cfg.max_end_silence_time * fps))
    min_speech = int(round(cfg.min_speech_duration * fps))
    pad = cfg.speech_pad
    segs = []
    in_speech = False
    start = 0
    sil_run = 0
    for i, p in enumerate(probs):
        if not in_speech:
            if p >= cfg.threshold_on:
                in_speech, start, sil_run = True, i, 0
        else:
            if p < cfg.threshold_off:
                sil_run += 1
                if sil_run > max_sil:
                    end = i - sil_run + 1
                    if end - start >= min_speech:
                        segs.append([start / fps - pad, end / fps + pad])
                    in_speech = False
            else:
                sil_run = 0
    if in_speech:
        end = len(probs) - sil_run
        if end - start >= min_speech:
            segs.append([start / fps - pad, end / fps + pad])
    merged = []  # clamp, and merge overlaps the padding made
    for s, e in segs:
        s = max(s, 0.0)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def merge_short_clips(segs: list, min_clip_sec: float) -> list:
    """Merge clips shorter than min_clip_sec into the previous one."""
    if not segs:
        return segs
    out = [list(segs[0])]
    for s, e in segs[1:]:
        if (e - s) < min_clip_sec or (out[-1][1] - out[-1][0]) < min_clip_sec:
            out[-1][1] = e
        else:
            out.append([s, e])
    return out


def split_long_clips(segs: list, max_clip_sec: float) -> list:
    """Split clips longer than max_clip_sec into equal parts."""
    out = []
    for s, e in segs:
        dur = e - s
        if dur <= max_clip_sec:
            out.append([s, e])
            continue
        n = int(np.ceil(dur / max_clip_sec))
        step = dur / n
        out.extend([[s + i * step, s + (i + 1) * step] for i in range(n)])
    return out
