"""Speech emotion recognition: a conv and attention classifier over fbank,
and its engine.

Counterpart of targetdiarization_tpu/models/emotion.py, with its 9-label
contract {"labels": [...], "scores": [...]} (softmax scores). `EmotionNet`
takes 80-bin fbank frames through two stride-2 5-tap convs (flax "SAME",
tanh GELU) to a quarter of the frames, two pre-norm self-attention layers
(flax's `MultiHeadDotProductAttention`, keys masked past each row's
frames // 4), a masked mean over time and a dense head. As in the JAX
model, the frames past the audio (the rung's zero padding) reach the
convs unmasked. In a reduced compute type the whole network computes in
it, as the JAX engine casts every parameter; the softmax too, and the
scores come back in float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.conv import Conv1dSame, gelu
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import exact_float32, resolve_compute_dtype
from . import features
from .asr import LN_EPS
from .punctuation import MultiHeadAttention

# emotion2vec_plus's labels, in the reference's order
EMOTION_LABELS = ["angry", "disgusted", "fearful", "happy", "neutral", "other", "sad",
                  "surprised", "unknown"]


class EmotionNet(nn.Module):
    def __init__(self, feat_dim: int = 80, dim: int = 128, n_layers: int = 2, heads: int = 4,
                 n_classes: int = len(EMOTION_LABELS)):
        super().__init__()
        self.conv1 = Conv1dSame(feat_dim, dim, 5, stride=2)
        self.conv2 = Conv1dSame(dim, dim, 5, stride=2)
        self.ln = nn.ModuleList([nn.LayerNorm(dim, eps=LN_EPS) for _ in range(n_layers)])
        self.attn = nn.ModuleList([MultiHeadAttention(dim, heads) for _ in range(n_layers)])
        self.head = nn.Linear(dim, n_classes)

    def forward(self, feats, lengths):
        """feats (B, T, feat_dim), lengths (B,) frames -> logits (B, n_classes)."""
        x = gelu(self.conv1(feats.transpose(1, 2)))
        x = gelu(self.conv2(x)).transpose(1, 2)  # (B, T', dim)
        t2 = x.shape[1]
        m2 = (torch.arange(t2, device=x.device)[None, :]
              < torch.clamp_min(lengths // 4, 1)[:, None]).to(x.dtype)
        for ln, attn in zip(self.ln, self.attn):
            x = (x + attn(ln(x), m2)) * m2[..., None]
        pooled = (x * m2[..., None]).sum(dim=1) / torch.clamp_min(
            m2.sum(dim=1, keepdim=True), 1.0)
        return self.head(pooled)


_SAMPLE_LADDER = BucketLadder(tuple(int(s * 16000) for s in (1, 2, 4, 8, 16, 30)))


class EmotionEngine:
    """One forward per call, padded to a sample rung of 1-30 s; fbank runs
    on the device in float32 from the float samples (no int16 round trip,
    as in the JAX engine). Audio past 30 s raises, as the JAX engine's
    `pad_to` does."""

    def __init__(self, model: EmotionNet, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "EmotionEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype)

    def probs(self, batch: np.ndarray, n_frames: list) -> np.ndarray:
        """(rows, bucket) float audio and fbank frame counts -> (rows, 9)
        float32 probabilities."""
        with torch.inference_mode(), exact_float32():
            audio = torch.from_numpy(np.asarray(batch, np.float32)).to(self.device)
            feats = features.fbank(audio).to(self.compute_dtype)
            lengths = torch.tensor(n_frames, device=self.device)
            logits = self.model(feats, lengths)
            return torch.softmax(logits, dim=-1).float().cpu().numpy()

    def emotion_detection(self, audio: np.ndarray, sr: int = 16000) -> dict:
        """{"labels": EMOTION_LABELS, "scores": [...]}, scores rounded to 4
        digits; all zeros for audio shorter than one fbank frame."""
        audio = np.asarray(audio, np.float32)
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, 16000, sr)
        t = features.num_frames(len(audio))
        if t == 0:
            return {"labels": list(EMOTION_LABELS), "scores": [0.0] * len(EMOTION_LABELS)}
        padded = pad_to(audio, _SAMPLE_LADDER.bucket(len(audio)))[None]
        scores = self.probs(padded, [t])[0]
        return {"labels": list(EMOTION_LABELS), "scores": [round(float(s), 4) for s in scores]}
