"""Frame-level speaker-activity segmentation and its engine.

Counterpart of the segmentation half of
targetdiarization_tpu/models/diarization.py: `SegmentationNet` (fbank ->
two strided convs, x4 fewer frames -> a transformer encoder -> a sigmoid
per speaker slot), the host binarizer `activations_to_diarization` with
`BinarizeConfig`, and `SegmentationEngine` (activations in 30 s windows,
per-slot diarization, overlap detection). The convs pad as flax's "SAME"
does (asymmetric on even lengths), and the attention is flax's.

In the JAX package's bf16 mode only the two convs compute in bf16: the
float32 sinusoidal table promotes the stream, so both transformer layers
and the head compute in float32 from bf16-rounded weights
(`promote_after`).

`ClusterDiarizer` is the sliding-window cluster diarizer: VAD, 1.5 s
windows every 0.75 s, one batched embedding forward, average-linkage
cosine clustering (`models/clustering.py`, sklearn's labels without
sklearn), windows joined into segments at label changes and labels
renumbered by first appearance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.conv import Conv1dSame, gelu
from ..ops.kernels import prepare_kernels
from ..pipeline import intervals as iv
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import (dequantize_audio, exact_float32, promote_after, quantize_i16,
                                 resolve_compute_dtype)
from . import features
from .asr import LN_EPS
from .clustering import agglomerative_cosine_average
from .punctuation import MultiHeadAttention
from .vad import VADConfig, segment_probs


class TransformerBlock(nn.Module):
    """Pre-norm self-attention and GELU feed-forward, masked output."""

    def __init__(self, dim: int = 128, heads: int = 4, ff_mult: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, dim * ff_mult)
        self.ff2 = nn.Linear(dim * ff_mult, dim)

    def forward(self, x, mask):  # x (B, T, D), mask (B, T)
        x = x + self.attn(self.ln1(x), mask)
        h = self.ff2(gelu(self.ff1(self.ln2(x))))
        return (x + h) * mask[..., None]


class SegmentationNet(nn.Module):
    """Speaker activity of `max_speakers` slots at 100 / `downsample` fps."""

    def __init__(self, feat_dim: int = 80, dim: int = 128, n_layers: int = 2, heads: int = 4,
                 max_speakers: int = 3, downsample: int = 4):
        super().__init__()
        self.dim, self.downsample, self.max_speakers = dim, downsample, max_speakers
        self.conv1 = Conv1dSame(feat_dim, dim, 5, stride=2)
        self.conv2 = Conv1dSame(dim, dim, 5, stride=downsample // 2)
        self.layers = nn.ModuleList([TransformerBlock(dim, heads) for _ in range(n_layers)])
        self.head = nn.Linear(dim, max_speakers)

    def forward(self, feats, lengths):
        """feats (B, T, F), lengths (B,) frames -> (B, T', K) activations,
        zero past each row's valid frames."""
        t = feats.shape[1]
        mask = (torch.arange(t, device=feats.device)[None, :] < lengths[:, None]).to(feats.dtype)
        x = (feats * mask[..., None]).transpose(1, 2)  # (B, F, T)
        x = gelu(self.conv2(gelu(self.conv1(x)))).transpose(1, 2)  # (B, T', D)
        t2 = x.shape[1]
        m2 = (torch.arange(t2, device=x.device)[None, :]
              < torch.clamp_min(lengths // self.downsample, 1)[:, None]).to(x.dtype)
        # sinusoidal positions, float32: they promote the stream to float32
        inv = 10000.0 ** (torch.arange(self.dim // 2, device=x.device, dtype=torch.float32)
                          * 2 / self.dim)
        pos = torch.arange(t2, device=x.device, dtype=torch.float32)[:, None] / inv[None, :]
        x = x + torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)[None]
        for layer in self.layers:
            x = layer(x, m2)
        return torch.sigmoid(self.head(x)) * m2[..., None]


@dataclass
class BinarizeConfig:
    """pyannote Binarize settings, calibrated in the JAX package against
    the reference system's output (models/diarization.py there)."""

    onset: float = 0.5
    offset: float = 0.35
    min_duration_on: float = 0.2
    min_duration_off: float = 0.45  # gap-merge horizon
    speech_pad: float = 0.1  # symmetric default of the two pads below
    pad_onset: float | None = 0.14
    pad_offset: float | None = 0.06
    onset_backtrack: float = 0.2  # 0.0 disables the onset back-extension
    backtrack_max: float = 0.25


def activations_to_diarization(act: np.ndarray, fps: float,
                               cfg: BinarizeConfig | None = None) -> dict:
    """(T', K) activations -> sd_result {slot: [(s, e), ...]}, in pyannote
    Binarize's order: hysteresis segments, pads, the onset back-extension,
    short gaps filled, short segments dropped."""
    cfg = cfg or BinarizeConfig()
    vcfg = VADConfig(threshold_on=cfg.onset, threshold_off=cfg.offset,
                     max_end_silence_time=0.0, min_speech_duration=0.0, speech_pad=0.0)
    pad_on = cfg.pad_onset if cfg.pad_onset is not None else cfg.speech_pad
    pad_off = cfg.pad_offset if cfg.pad_offset is not None else cfg.speech_pad
    result = {}
    bt = cfg.onset_backtrack
    bt_max = int(round(cfg.backtrack_max * fps))
    for k in range(act.shape[1]):
        track = act[:, k]
        segs = segment_probs(track, vcfg, fps=fps)
        for seg in segs:
            seg[0] = max(seg[0] - pad_on, 0.0)
            seg[1] = seg[1] + pad_off
        merged = []  # the overlaps the pads made
        for s, e in segs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        segs = merged
        # onset back-extension: each confirmed start walks back while the
        # activation stays at or above `onset_backtrack`; the onset frame is
        # rebuilt from the padded start, as the JAX package does
        if bt > 0.0 and bt_max > 0:
            prev_end_f = -1
            for seg in segs:
                f_on = min(max(int(round((seg[0] + pad_on) * fps)), 0), len(track) - 1)
                f_new = f_on
                while (f_new - 1 > prev_end_f and f_on - f_new < bt_max
                       and f_new - 1 >= 0 and track[f_new - 1] >= bt):
                    f_new -= 1
                if f_new < f_on:
                    seg[0] = max(f_new / fps - pad_on, 0.0)
                prev_end_f = int(round((seg[1] - pad_off) * fps))
        filled = []
        for s, e in segs:
            if filled and s - filled[-1][1] < cfg.min_duration_off:
                filled[-1][1] = e
            else:
                filled.append([s, e])
        segs = [(s, e) for s, e in filled if e - s >= cfg.min_duration_on]
        if segs:
            result[str(k)] = [(round(s, 3), round(e, 3)) for s, e in segs]
    return result


_SEG_LADDER = BucketLadder(tuple(int(s * 16000) for s in (1, 2, 4, 8, 16, 30)))


class SegmentationEngine:
    """Activations per speaker slot, per-slot diarization and overlap.
    Audio goes up as int16 padded to a sample rung (1 .. 30 s); longer
    audio is cut in 30 s windows whose activations are concatenated."""

    def __init__(self, model: SegmentationNet, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = promote_after(model.to(self.device), [model.conv1, model.conv2],
                                   self.compute_dtype).eval()
        prepare_kernels(self.model)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "SegmentationEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype)

    @property
    def fps(self) -> float:
        return 100.0 / self.model.downsample

    def forward_feats(self, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Device features (B, T, 80) float32 -> (B, T', K) float32."""
        with torch.inference_mode(), exact_float32():
            return self.model(feats.to(self.compute_dtype), lengths).float()

    def activations(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        """(T', K) speech activity per slot in [0, 1] at `self.fps`."""
        audio = np.asarray(audio, np.float32)
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, 16000, sr)
        top = _SEG_LADDER.rungs[-1]
        if len(audio) > top:
            parts = [self.activations(audio[i: i + top]) for i in range(0, len(audio), top)]
            return np.concatenate(parts, axis=0)
        t = features.num_frames(len(audio))
        if t == 0:
            return np.zeros((0, self.model.max_speakers), np.float32)
        padded = pad_to(audio, _SEG_LADDER.bucket(len(audio)))[None]
        with torch.inference_mode():
            a = torch.from_numpy(quantize_i16(padded)).to(self.device)
            feats = features.fbank(dequantize_audio(a))
            act = self.forward_feats(feats, torch.tensor([t], device=self.device))
            return act[0, :max(t // self.model.downsample, 1)].cpu().numpy()

    def diarize(self, audio: np.ndarray, sr: int = 16000,
                cfg: BinarizeConfig | None = None) -> dict:
        """sd_result {slot: [(s, e), ...]} of one window (audio up to 30 s)."""
        return activations_to_diarization(self.activations(audio, sr=sr), self.fps, cfg)

    def detect_overlap(self, audio: np.ndarray, sr: int = 16000,
                       min_overlap_sec: float = 0.4) -> dict:
        """od_result {'a-b': [(s, e), ...]} of pairwise overlapping speech."""
        return iv.get_speaker_overlap(self.diarize(audio, sr=sr),
                                      min_overlap_sec=min_overlap_sec)

    def is_overlap(self, audio: np.ndarray, sr: int = 16000) -> bool:
        """Whether any two slots are active at once."""
        return bool(self.detect_overlap(audio, sr=sr))


# ---------------- sliding-window cluster diarizer ----------------


@dataclass
class DiarizeConfig:
    window: float = 1.5  # s, embedding window
    hop: float = 0.75
    min_window: float = 0.5  # shorter tails are dropped
    clustering_threshold: float = 0.6  # cosine distance for AHC
    min_segment: float = 0.3


class ClusterDiarizer:
    """VAD -> sliding windows -> batched embeddings -> AHC. The result is
    {"0": [(s, e), ...], ...}, labels numbered by first appearance."""

    def __init__(self, speaker_engine, vad_engine=None, cfg: DiarizeConfig | None = None):
        self.spk = speaker_engine
        self.vad = vad_engine
        self.cfg = cfg or DiarizeConfig()

    def _windows(self, speech_segs: list, duration: float) -> list:
        win, hop = self.cfg.window, self.cfg.hop
        out = []
        for s, e in speech_segs:
            t = s
            while t < e:
                w_end = min(t + win, e)
                if w_end - t >= self.cfg.min_window or not out:
                    out.append((t, w_end))
                t += hop
                if w_end >= e:
                    break
        return out

    def _cluster(self, embs: np.ndarray, n_speakers: int | None) -> np.ndarray:
        if len(embs) == 1:
            return np.zeros(1, np.int64)
        norm = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-9)
        if n_speakers is not None and n_speakers >= 1:
            return agglomerative_cosine_average(norm, n_clusters=min(n_speakers, len(embs)))
        return agglomerative_cosine_average(
            norm, distance_threshold=self.cfg.clustering_threshold)

    def diarize(self, audio: np.ndarray, sr: int = 16000,
                n_speakers: int | None = None) -> dict:
        audio = np.asarray(audio, np.float32)
        duration = len(audio) / sr
        speech = (self.vad.vad_detection(audio, sr=sr) if self.vad is not None
                  else [[0.0, duration]])
        if not speech:
            return {}
        wins = self._windows(speech, duration)
        if not wins:
            return {}
        clips = [audio[int(s * sr): int(e * sr)] for s, e in wins]
        return self.diarize_from_windows(wins, self.spk.embed_batch(clips, sr=sr), n_speakers)

    def diarize_from_windows(self, wins: list, embs: np.ndarray,
                             n_speakers: int | None = None) -> dict:
        """Clusters given (window, embedding) pairs into a diarization;
        zero embeddings are left out. A segment runs while the label stays
        and the windows touch; at a change the boundary is the midpoint of
        the overlap."""
        valid = np.linalg.norm(embs, axis=1) > 0
        wins = [w for w, v in zip(wins, valid) if v]
        embs = np.asarray(embs)[valid]
        if len(embs) == 0:
            return {}
        labels = self._cluster(embs, n_speakers)
        segments = []
        cur_label, cur_start, cur_end = None, None, None
        for (s, e), lab in zip(wins, labels):
            if lab == cur_label and s <= cur_end:
                cur_end = e
            else:
                if cur_label is not None:
                    boundary = min(cur_end, s + (cur_end - s) / 2) if s < cur_end else cur_end
                    segments.append([cur_start, boundary, cur_label])
                    cur_start = boundary if s < boundary else s
                else:
                    cur_start = s
                cur_label, cur_end = lab, e
        if cur_label is not None:
            segments.append([cur_start, cur_end, cur_label])
        remap: dict = {}
        for seg in segments:
            seg[2] = remap.setdefault(seg[2], len(remap))
        segments = [s for s in segments if (s[1] - s[0]) >= self.cfg.min_segment]
        return iv.parse_segments(segments)
