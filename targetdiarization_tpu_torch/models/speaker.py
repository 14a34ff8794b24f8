"""ERes2NetV2 and CAM++ speaker embeddings (192-d) and the speaker engine.

Counterpart of targetdiarization_tpu/models/speaker.py (ERes2NetV2,
CAMPlusPlus, `SpeakerEngine.embed_batch`, `get_speaker_embedding`,
`is_same_person`, `get_target_embedding`, `cosine_similarity`). The 2-D
convolutions are NCHW over (B, C, T, F): the JAX model's NHWC image
(B, T, F, C) with the channels moved, so (T, F) stay (H, W); before
pooling the maps go back to (B, T', F', C) and flatten to (B, T', F'·C)
as in the JAX model. CAM++'s TDNN part is channels-last (B, T, C) as in
the JAX model. BatchNorm runs on the checkpoint's running statistics
(flax's epsilon 1e-5), the AFF gate's GroupNorm per channel (epsilon
1e-6). The engine takes either network (the checkpoint's `model_name`
picks it) and calls it the same way.

In the JAX package's bf16 mode the float32 time mask multiplies the bf16
input at once, so the network computes in float32 from bf16-rounded
weights and a bf16-rounded input, except that each BatchNorm's
rsqrt(var + eps) is rounded to the bf16 type of its running statistics;
the engine does the same (its BatchNorms keep the compute type).

`get_target_embedding` clusters per-segment embeddings with the port's
HDBSCAN (`models/clustering.py`), not sklearn's: the JAX package falls
back to one cluster where sklearn is missing, the port computes what it
computes with sklearn.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.conv import Conv1dSame, Conv2dSame
from ..ops.kernels import prepare_kernels
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import (dequantize_audio, exact_float32, promote_after, quantize_i16,
                                 resolve_compute_dtype)
from . import features

EMBED_DIM = 192
MAX_EMBED_SECONDS = 30.0  # the reference truncates the SV input at 30 s
BN_EPS = 1e-5  # flax nn.BatchNorm
GN_EPS = 1e-6  # flax nn.GroupNorm

_SAMPLE_LADDER = BucketLadder(tuple(int(s * 16000) for s in (1, 2, 4, 8, 16, 30)))


def time_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, t) float32 prefix mask."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()


class BatchNorm(nn.Module):
    """flax BatchNorm with running averages over the channel axis `axis`
    (1 for NCHW maps, -1 for channels-last):
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, channels: int, eps: float = BN_EPS, axis: int = 1):
        super().__init__()
        self.eps, self.axis = eps, axis
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.axis] = -1

        def channels(v):
            return v.reshape(shape)

        # rsqrt(var + eps) is rounded to the statistics' type and the rest
        # computes in float32: what XLA's fusion of the JAX model's bf16
        # mode does (tests/test_torch_speaker.py holds it)
        inv = torch.rsqrt(self.running_var.float() + self.eps).to(self.running_var.dtype)
        mul = inv.float() * self.weight.float()
        return (x - channels(self.running_mean)) * channels(mul) + channels(self.bias)


class AttentiveStatsPool(nn.Module):
    """Masked attentive statistics pooling: (B, T, D) -> (B, 2D)."""

    def __init__(self, dim: int, hidden: int = 128):
        super().__init__()
        self.att_w = nn.Linear(dim, hidden)
        self.att_v = nn.Linear(hidden, 1)

    def forward(self, x, mask):
        a = self.att_v(torch.tanh(self.att_w(x)))[..., 0]  # (B, T)
        a = torch.softmax(torch.where(mask > 0, a, torch.full_like(a, -1e9)), dim=-1)[..., None]
        mean = (a * x).sum(dim=1)
        var = (a * x.square()).sum(dim=1) - mean.square()
        return torch.cat([mean, torch.sqrt(torch.clamp_min(var, 1e-7))], dim=-1)


class AFF(nn.Module):
    """Attentional feature fusion: a channel gate between two branches."""

    def __init__(self, channels: int):
        super().__init__()
        self.gate_down = nn.Conv2d(channels, channels // 2, 1)
        self.gate_norm = nn.GroupNorm(channels // 2, channels // 2, eps=GN_EPS)
        self.gate_up = nn.Conv2d(channels // 2, channels, 1)

    def forward(self, a, b):
        g = self.gate_up(torch.relu(self.gate_norm(self.gate_down(a + b))))
        w = torch.sigmoid(g)
        return a * w + b * (1.0 - w)


class Res2Block(nn.Module):
    """Res2Net block: a strided 1x1 reduce, `scale` hierarchical 3x3
    branches, a 1x1 expand, and an AFF with the (projected) input."""

    def __init__(self, in_channels: int, channels: int, scale: int = 4, stride: int = 1):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.reduce = nn.Conv2d(in_channels, channels, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv = nn.ModuleDict({str(i): Conv2dSame(width, width, 3, bias=False)
                                   for i in range(1, scale)})
        self.bn = nn.ModuleDict({str(i): BatchNorm(width) for i in range(1, scale)})
        self.expand = nn.Conv2d(channels, channels, 1, bias=False)
        self.bn2 = BatchNorm(channels)
        self.shortcut = self.bn_sc = None
        if in_channels != channels or stride != 1:
            self.shortcut = nn.Conv2d(in_channels, channels, 1, stride=stride, bias=False)
            self.bn_sc = BatchNorm(channels)
        self.aff = AFF(channels)

    def forward(self, x):
        y = torch.relu(self.bn1(self.reduce(x)))
        splits = torch.chunk(y, self.scale, dim=1)
        outs, prev = [splits[0]], None
        for i in range(1, self.scale):
            inp = splits[i] if prev is None else splits[i] + prev
            prev = torch.relu(self.bn[str(i)](self.conv[str(i)](inp)))
            outs.append(prev)
        y = self.bn2(self.expand(torch.cat(outs, dim=1)))
        sc = x if self.shortcut is None else self.bn_sc(self.shortcut(x))
        return torch.relu(self.aff(y, sc))


class ERes2NetV2(nn.Module):
    """Res2Net speaker embedder over 80-d fbank (w24s4 by default)."""

    def __init__(self, feat_dim: int = 80, channels: int = 24, scale: int = 4,
                 blocks=(1, 1, 1, 1), embed_dim: int = EMBED_DIM):
        super().__init__()
        self.feat_dim = feat_dim
        self.stem = Conv2dSame(1, channels, 3, bias=False)
        self.stem_bn = BatchNorm(channels)
        self.blocks = nn.ModuleDict()
        c_in, f = channels, feat_dim
        for si, n_blocks in enumerate(blocks):
            c_out = channels * 2 ** si
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                self.blocks[f"stage{si}_block{bi}"] = Res2Block(c_in, c_out, scale, stride)
                f = -(-f // stride)
                c_in = c_out
        self.asp = AttentiveStatsPool(f * c_in)
        self.embedding = nn.Linear(2 * f * c_in, embed_dim)

    def forward(self, feats, lengths):
        """feats (B, T, F), lengths (B,) frames -> (B, embed_dim)."""
        t = feats.shape[1]
        # the float32 mask promotes the stream to float32, as in the JAX model
        x = (feats * time_mask(lengths, t)[..., None])[:, None]  # (B, 1, T, F)
        x = torch.relu(self.stem_bn(self.stem(x)))
        for block in self.blocks.values():
            x = block(x)
        b, c, tt, ff = x.shape
        h = x.permute(0, 2, 3, 1).reshape(b, tt, ff * c)
        ds = t // tt if tt else 1
        m2 = time_mask(torch.clamp_min(lengths // ds, 1), tt)
        return self.embedding(self.asp(h, m2))


class CAMLayer(nn.Module):
    """A D-TDNN layer over (B, T, C): BN-ReLU-Linear bottleneck, BN-ReLU, a
    3-tap dilated conv of the masked frames, a context gate from the masked
    mean over time, and the result appended to the input's channels."""

    def __init__(self, in_channels: int, bottleneck: int, growth: int, dilation: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(in_channels, axis=-1)
        self.bottleneck = nn.Linear(in_channels, bottleneck, bias=False)
        self.bn2 = BatchNorm(bottleneck, axis=-1)
        self.tdnn = Conv1dSame(bottleneck, growth, 3, dilation=dilation, bias=False)
        self.cam_down = nn.Linear(growth, growth // 2)
        self.cam_up = nn.Linear(growth // 2, growth)

    def forward(self, x, mask):
        m = mask[..., None]
        h = torch.relu(self.bn2(self.bottleneck(torch.relu(self.bn1(x)))))
        h = self.tdnn((h * m).transpose(1, 2)).transpose(1, 2)
        ctx = (h * m).sum(dim=1, keepdim=True) / torch.clamp_min(m.sum(dim=1, keepdim=True), 1e-6)
        h = h * torch.sigmoid(self.cam_up(torch.relu(self.cam_down(ctx))))
        return torch.cat([x, h * m], dim=-1)


class CAMPlusPlus(nn.Module):
    """D-TDNN with context-aware masking over 80-d fbank: a 2-D conv front
    end (two 3x3 convs of stride (1, 2) over (T, F), "SAME" padded, so an
    even F is padded by (0, 1)), flattened frame by frame in the JAX
    model's order (feature f * 32 + c), a 5-tap TDNN, three dense blocks
    of CAMLayers with dilations 1, 2, 3, each followed by a BN-ReLU-Linear
    transition that halves the channels, and masked mean and standard
    deviation pooling (one pass: E[x^2] - mean^2)."""

    def __init__(self, feat_dim: int = 80, init_channels: int = 128, growth: int = 32,
                 bottleneck: int = 64, block_layers=(4, 6, 8), embed_dim: int = EMBED_DIM):
        super().__init__()
        self.feat_dim, self.block_layers = feat_dim, tuple(block_layers)
        self.fcm1 = Conv2dSame(1, 32, 3, stride=(1, 2), bias=False)
        self.fcm2 = Conv2dSame(32, 32, 3, stride=(1, 2), bias=False)
        f = -(-feat_dim // 4)  # ceil(ceil(F / 2) / 2) frequency bins after the front end
        self.tdnn_in = Conv1dSame(32 * f, init_channels, 5, bias=False)
        c = init_channels
        for bi, n_layers in enumerate(self.block_layers):
            for li in range(n_layers):
                self.add_module(f"block{bi}_layer{li}",
                                CAMLayer(c, bottleneck, growth, dilation=(1, 2, 3)[bi]))
                c += growth
            self.add_module(f"tbn{bi}", BatchNorm(c, axis=-1))
            self.add_module(f"transit{bi}", nn.Linear(c, c // 2, bias=False))
            c //= 2
        self.embedding = nn.Linear(2 * c, embed_dim)

    def forward(self, feats, lengths):
        """feats (B, T, F), lengths (B,) frames -> (B, embed_dim)."""
        b, t, _ = feats.shape
        mask = time_mask(lengths, t)
        m = mask[..., None]
        # the float32 mask promotes the stream to float32, as in the JAX model
        x = (feats * m)[:, None]  # (B, 1, T, F)
        x = torch.relu(self.fcm2(torch.relu(self.fcm1(x))))  # (B, 32, T, F/4)
        x = x.permute(0, 2, 3, 1).reshape(b, t, -1)  # (B, T, F/4 * 32), index f * 32 + c
        x = self.tdnn_in((x * m).transpose(1, 2)).transpose(1, 2)
        for bi, n_layers in enumerate(self.block_layers):
            for li in range(n_layers):
                x = getattr(self, f"block{bi}_layer{li}")(x, mask)
            x = getattr(self, f"transit{bi}")(torch.relu(getattr(self, f"tbn{bi}")(x)))
        n = torch.clamp_min(m.sum(dim=1), 1e-6)
        mean = (x * m).sum(dim=1) / n
        var = (x.square() * m).sum(dim=1) / n - mean.square()
        return self.embedding(torch.cat([mean, torch.sqrt(torch.clamp_min(var, 1e-7))], dim=-1))


# the JAX package's SpeakerEngine presets (model_name -> class and arguments)
MODEL_PRESETS = {
    "eres2netv2_large": (ERes2NetV2, dict(channels=24, blocks=(2, 2, 2, 2))),
    "eres2netv2": (ERes2NetV2, dict(channels=24, blocks=(1, 1, 1, 1))),
    "eres2net": (ERes2NetV2, dict(channels=16, blocks=(1, 1, 1, 1))),
    "campp": (CAMPlusPlus, {}),
}


def preset_model(name: str) -> nn.Module:
    """The network of a JAX `SpeakerEngine` preset, with torch's default
    initialisation (load a state dict into it; no engine runs it as is)."""
    cls, args = MODEL_PRESETS[name]
    return cls(**args)


def cosine_similarity(e1, e2) -> float:
    """Plain cosine in [-1, 1]; 0 for a zero vector."""
    e1 = np.asarray(e1, np.float64).ravel()
    e2 = np.asarray(e2, np.float64).ravel()
    n1, n2 = np.linalg.norm(e1), np.linalg.norm(e2)
    if n1 == 0 or n2 == 0:
        return 0.0
    return float(np.dot(e1, e2) / (n1 * n2))


class SpeakerEngine:
    """Speaker embeddings and verification. Audio goes up as int16, one
    padded batch per sample rung (1 .. 30 s); fbank, the CMN over each
    clip's valid frames and the forward run on the device in one pass. The
    network is an ERes2NetV2 or a CAMPlusPlus; in a reduced compute type
    both compute in float32 from rounded weights, their BatchNorms keeping
    the compute type."""

    def __init__(self, model: nn.Module, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        self.model = promote_after(model.to(self.device), norms, self.compute_dtype).eval()
        prepare_kernels(self.model)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "SpeakerEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype)

    def embed_feats(self, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Device features (B, T, 80) float32 -> (B, 192) float32, the input
        rounded to the compute type first."""
        with torch.inference_mode(), exact_float32():
            return self.model(feats.to(self.compute_dtype), lengths).float()

    def _embed(self, batch: np.ndarray, n_frames: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            audio = torch.from_numpy(quantize_i16(batch)).to(self.device)
            feats = features.fbank(dequantize_audio(audio))  # (B, T, 80)
            nf = torch.from_numpy(n_frames).to(self.device)
            fmask = time_mask(nf, feats.shape[1])[..., None]
            mean = (feats * fmask).sum(dim=1, keepdim=True) / torch.clamp_min(
                fmask.sum(dim=1, keepdim=True), 1.0)
            return self.embed_feats((feats - mean) * fmask, nf).cpu().numpy()

    def embed_batch(self, audios: list, sr: int = 16000,
                    single_dispatch: bool = False) -> np.ndarray:
        """(N, 192) embeddings, one forward per sample rung (all clips in the
        rung of the longest with `single_dispatch`); a clip shorter than one
        fbank frame gets a zero vector. Clips are cut at 30 s."""
        max_n = int(MAX_EMBED_SECONDS * sr)
        clips = []
        for a in audios:
            a = np.asarray(a, np.float32).ravel()[:max_n]
            if sr != 16000 and a.size:
                from ..ops.resample import resample_poly_np

                a = resample_poly_np(a, 16000, sr)
            clips.append(a)
        out = np.zeros((len(clips), EMBED_DIM), np.float32)
        valid = [i for i, a in enumerate(clips) if features.num_frames(len(a)) > 0]
        by_bucket: dict = {}
        if single_dispatch and valid:
            by_bucket[_SAMPLE_LADDER.bucket(max(len(clips[i]) for i in valid))] = valid
        else:
            for i in valid:
                by_bucket.setdefault(_SAMPLE_LADDER.bucket(len(clips[i])), []).append(i)
        for bucket, idxs in by_bucket.items():
            batch = np.stack([pad_to(clips[i], bucket) for i in idxs])
            n_frames = np.array([features.num_frames(len(clips[i])) for i in idxs])
            out[idxs] = self._embed(batch, n_frames)
        return out

    def get_speaker_embedding(self, audio, sr: int = 16000) -> np.ndarray:
        """One clip's 192-d embedding (zeros for a too-short clip)."""
        return self.embed_batch([audio], sr=sr)[0]

    def is_same_person(self, emb_a, emb_b, threshold: float = 0.4):
        """(same, cosine score)."""
        score = cosine_similarity(emb_a, emb_b)
        return bool(score >= threshold), score

    def get_target_embedding(self, audio, sr: int = 16000, vad_segments: list | None = None,
                             min_cluster_size: int = 2) -> np.ndarray:
        """An enrollment embedding robust to other voices in the clip: the
        embeddings of the VAD segments of at least 0.3 s, clustered by
        HDBSCAN on unit vectors (`models/clustering.py`), and the mean of
        the largest cluster's; the mean of all when there are too few or
        HDBSCAN finds no cluster; the whole clip's embedding when no
        segment is long enough."""
        from .clustering import hdbscan_labels

        audio = np.asarray(audio, np.float32)
        segs = [[0.0, len(audio) / sr]] if vad_segments is None else vad_segments
        clips = [audio[int(s * sr): int(e * sr)] for s, e in segs]
        clips = [c for c in clips if c.size >= int(0.3 * sr)]
        if not clips:
            return self.get_speaker_embedding(audio, sr)
        embs = self.embed_batch(clips, sr=sr)
        embs = embs[~np.any(np.isnan(embs), axis=1) & (np.linalg.norm(embs, axis=1) > 0)]
        if len(embs) == 0:
            return np.zeros(EMBED_DIM, np.float32)
        if len(embs) < max(min_cluster_size, 2):
            return embs.mean(axis=0)
        labels = hdbscan_labels(embs / np.linalg.norm(embs, axis=1, keepdims=True),
                                min_cluster_size=min_cluster_size)
        core = labels[labels >= 0]
        if core.size == 0:
            return embs.mean(axis=0)
        return embs[labels == np.bincount(core).argmax()].mean(axis=0)
