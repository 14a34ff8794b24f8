"""The alternative separators of the model zoo, in PyTorch.

Counterpart of targetdiarization_tpu/models/zoo.py: the ten registered
classes with the JAX package's contract

    model(wav (B, T), lengths (B,) or None) -> (B, num_spks, T)

so `SeparationEngine` serves any of them. Each module keeps the JAX
module's name, so `runtime/convert.py::zoo_state_dict` maps a flax tree
by a few layout rules. Layouts are time-major (B, T, C) as in JAX.

  ConvTasNet   TCN masking separator; its depthwise convs (dilations 1 to
               128) run `ops.kernels.dwconv`
  DPRNNTasNet  dual-path LSTMs, length-aware through packed sequences
  DPTNet       dual-path transformer with LSTM feed-forward
  SuDORMRF     successive down/up-sampling U-conv blocks
  SkiMNet      skipping-memory segment LSTMs
  BSRNN        band-split RNN over STFT bands
  TDANet       top-down attention pyramid
  TFGridNet    time-frequency grid dual-RNN with full-band attention
  MossFormer   v1: the separator's FlashBlocks (FFConvM and gated FLASH
               kernels) without the FSMN blocks
  AFRCNN       asynchronous fully recurrent conv net

The strided grouped convolutions of SuDORMRF, TDANet and AFRCNN are plain
`conv1d` calls, as the JAX package leaves them to XLA.

In a reduced compute type each class runs the modules `reduced_modules()`
names in that type and everything else in float32 from weights rounded to
it, as the JAX package's types do: with `lengths` given (the engine
always gives them) the float32 length mask promotes the stream right
after the encoder; the STFT classes promote at the float32 window;
MossFormer stays in the reduced type but for its rotary tables and FLASH.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..ops.stft import istft, stft
from .restoration import DepthwiseConv1d
from .separation import FlashBlock, GlobalLayerNorm

_F32_EPS = 1.1920929e-7


def _length_mask(lengths, t: int, dtype=torch.float32):
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


def _enc_frames(lengths, kernel: int, stride: int, t: int):
    """Valid encoder frames of each row, at least 1."""
    return torch.clamp((lengths - kernel) // stride + 1, 1, t)


def _masked_stats_norm(x, mask, weight, bias, eps: float):
    """Normalise over (T, C) jointly per row, the statistics over frames
    with mask 1 (all frames for mask None), padded frames zeroed."""
    if mask is None:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return weight * (x - mean) / torch.sqrt(var + eps) + bias
    m = mask.to(x.dtype)[..., None]
    denom = torch.clamp_min(m.sum(dim=(1, 2), keepdim=True) * x.shape[-1], 1.0)
    mean = (x * m).sum(dim=(1, 2), keepdim=True) / denom
    var = ((x - mean).square() * m).sum(dim=(1, 2), keepdim=True) / denom
    return (weight * (x - mean) / torch.sqrt(var + eps) + bias) * m


class _MaskedGLN(nn.Module):
    """Global layer norm over (T, C) with a frame mask (params w, b)."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        return _masked_stats_norm(x, mask, self.w, self.b, self.eps)


class _GLNBDT(nn.Module):
    """Global layer norm over (T, C), optionally masked (params gamma, beta)."""

    def __init__(self, dim: int, eps: float = _F32_EPS):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask=None):
        return _masked_stats_norm(x, mask, self.gamma, self.beta, self.eps)


class _MaskedGN1(nn.Module):
    """GroupNorm with one group over (T, C), optionally masked; the flax
    GroupNorm's `scale` is `weight` here."""

    def __init__(self, dim: int, eps: float = _F32_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask=None):
        if x.dim() > 3:  # (B, ..., C): every axis but the batch's
            shape = x.shape
            return self.forward(x.reshape(shape[0], -1, shape[-1]), mask).reshape(shape)
        return _masked_stats_norm(x, mask, self.weight, self.bias, self.eps)


class _CLNBDT(nn.Module):
    """Per-frame layer norm over channels (params gamma, beta)."""

    def __init__(self, dim: int, eps: float = _F32_EPS):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return self.gamma * (x - mean) / torch.sqrt(var + self.eps) + self.beta


class _PReLU(nn.Module):
    """One-parameter PReLU (init 0.25)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.clamp_min(x, 0) + self.alpha.to(x.dtype) * torch.clamp_max(x, 0)


def _conv_tl(conv: nn.Module, x):
    """A channels-first conv on a time-major (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _finalize(est, t_in: int):
    t_out = est.shape[-1]
    if t_out >= t_in:
        return est[..., :t_in]
    return F.pad(est, (0, t_in - t_out))


def _mask_decode(x_enc, masks, dec: nn.Module, num_spks: int, t_in: int):
    """Per-speaker masks (B, T, spk, N) on the encoder frames, each stream
    through the transposed-conv decoder."""
    outs = [dec((x_enc * masks[..., s, :]).transpose(1, 2))[:, 0] for s in range(num_spks)]
    return _finalize(torch.stack(outs, dim=1), t_in)


class _Registered(nn.Module):
    """What the engine reads of a zoo class: `num_spks`, `sample_rate` and
    `reduced_modules()`, the modules that compute in a reduced type."""

    def reduced_modules(self) -> tuple:
        return (self.encoder,)


# ---------------- ConvTasNet ----------------


class _TCNBlock(nn.Module):
    """conv1x1 -> PReLU -> gLN -> dwconv (bias) -> PReLU -> gLN -> conv1x1,
    residual around the block."""

    def __init__(self, dim: int, hidden: int, kernel: int = 3, dilation: int = 1):
        super().__init__()
        self.in1x1 = nn.Linear(dim, hidden)
        self.prelu1 = _PReLU()
        self.gln1 = _MaskedGLN(hidden, eps=1e-5)
        self.dwconv = DepthwiseConv1d(hidden, kernel, dilation=dilation)
        self.prelu2 = _PReLU()
        self.gln2 = _MaskedGLN(hidden, eps=1e-5)
        self.out1x1 = nn.Linear(hidden, dim)

    def forward(self, x, mask):
        h = self.gln1(self.prelu1(self.in1x1(x)), mask)
        h = self.gln2(self.prelu2(self.dwconv(h)), mask)
        return x + self.out1x1(h)


class ConvTasNet(_Registered):
    """TCN masking separator: conv encoder (bias), gLN + 1x1 bottleneck,
    R x X TCN blocks at dilations 2^i, relu masks on the encoder frames,
    transposed-conv decoder (bias)."""

    def __init__(self, enc_channels: int = 512, bottleneck: int = 128, hidden: int = 512,
                 kernel_size: int = 16, n_blocks: int = 8, n_repeats: int = 3,
                 num_spks: int = 2, sample_rate: int = 16000):
        super().__init__()
        self.kernel_size, self.hidden = kernel_size, hidden
        self.num_spks, self.sample_rate = num_spks, sample_rate
        stride = kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride)
        self.in_norm = _MaskedGLN(enc_channels, eps=1e-5)
        self.bottleneck = nn.Linear(enc_channels, bottleneck)
        self.block_names = [f"tcn_{r}_{i}" for r in range(n_repeats) for i in range(n_blocks)]
        for r in range(n_repeats):
            for i in range(n_blocks):
                self.add_module(f"tcn_{r}_{i}", _TCNBlock(bottleneck, hidden, dilation=2 ** i))
        self.mask_out = nn.Linear(bottleneck, hidden * num_spks)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride)

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        x = _conv_tl(self.encoder, wav[:, :, None])
        t = x.shape[1]
        if lengths is None:
            lengths = torch.full((b,), t_in, device=wav.device, dtype=torch.long)
        mask = _length_mask(_enc_frames(lengths, self.kernel_size, self.kernel_size // 2, t), t)
        x = x * mask[..., None]
        h = self.bottleneck(self.in_norm(x, mask))
        for name in self.block_names:
            h = getattr(self, name)(h, mask)
        m = torch.relu(self.mask_out(h)).reshape(b, t, self.num_spks, self.hidden)
        m = m * mask[..., None, None]
        return _mask_decode(x, m, self.decoder, self.num_spks, t_in)


# ---------------- torch-packed LSTMs ----------------


class _TorchLSTM(nn.LSTM):
    """One-layer batch-first LSTM (optionally bidirectional). With a mask
    (B, T, 1) whose ones are a prefix of each row, the steps past a row's
    length are left out (packed sequences): the forward leg stops there,
    the backward leg starts from the last valid step with zero state, and
    padded steps emit zeros, as the JAX package's pass-through steps do.
    A row with no valid step computes one step and emits zeros."""

    def __init__(self, n_in: int, hidden: int, bidirectional: bool = False):
        super().__init__(n_in, hidden, batch_first=True, bidirectional=bidirectional)

    def forward(self, x, mask=None, lengths=None):
        if mask is None:
            return super().forward(x)[0]
        if lengths is None:
            lengths = mask[:, :, 0].sum(dim=1).long().cpu()
        packed = pack_padded_sequence(x, lengths.clamp_min(1), batch_first=True,
                                      enforce_sorted=False)
        out, _ = pad_packed_sequence(super().forward(packed)[0], batch_first=True,
                                     total_length=x.shape[1])
        return out * mask.to(out.dtype)


class _StatefulTorchLSTM(nn.LSTM):
    """One-layer LSTM from explicit (h0, c0) of shape (d, B, H), returning
    its output and final (h, c)."""

    def __init__(self, n_in: int, hidden: int, bidirectional: bool = False):
        super().__init__(n_in, hidden, batch_first=True, bidirectional=bidirectional)

    def forward(self, x, h0, c0):
        out, (h, c) = super().forward(x, (h0.contiguous(), c0.contiguous()))
        return out, (h, c)


# ---------------- dual-path segmentation ----------------


def _segment_ref(x, k: int):
    """(B, L, N) -> (B, S, K, N): end pad `gap`, K/2 both sides, and two
    interleaved half-shifted views."""
    b, length, n = x.shape
    p = k // 2
    gap = k - (p + length % k) % k
    x = F.pad(x, (0, 0, p, p + gap))
    x1 = x[:, :-p].reshape(b, -1, k, n)
    x2 = x[:, p:].reshape(b, -1, k, n)
    return torch.cat([x1, x2], dim=2).reshape(b, -1, k, n), gap


def _over_add_ref(seg, gap: int):
    """Inverse of `_segment_ref`."""
    b, s, k, n = seg.shape
    p = k // 2
    x = seg.reshape(b, s // 2, 2 * k, n)
    x1 = x[:, :, :k].reshape(b, -1, n)[:, p:]
    x2 = x[:, :, k:].reshape(b, -1, n)[:, :-p]
    out = x1 + x2
    return out[:, :-gap] if gap > 0 else out


def _seg_valid_mask(enc_lengths, t: int, k: int):
    """(B, S, K, 1) validity of `_segment_ref`'s frames: the exact-length
    graph's structural zeros (p leading, gap + p trailing) count as valid,
    frames beyond them do not; valid chunks are a prefix along S and valid
    frames a prefix within each chunk."""
    p = k // 2
    gap_b = k - (p + t % k) % k
    total = p + t + gap_b + p
    gap_v = k - (p + enc_lengths % k) % k
    eff = 2 * p + enc_lengths + gap_v
    b = enc_lengths.shape[0]
    pos = torch.arange(total, device=enc_lengths.device)[None, :]
    m1 = (pos[:, : total - p] < (eff - p)[:, None]).float().reshape(b, -1, k, 1)
    m2 = (pos[:, p:] < eff[:, None]).float().reshape(b, -1, k, 1)
    return torch.cat([m1, m2], dim=2).reshape(b, -1, k, 1)


# ---------------- DPRNNTasNet ----------------


class _DPRNNBlock(nn.Module):
    """Intra-chunk then inter-chunk BiLSTM, each projected, normalised
    (GroupNorm(1), masked when a segment mask is given) and added."""

    def __init__(self, dim: int, hidden: int, bidirectional: bool = True):
        super().__init__()
        d = 2 if bidirectional else 1
        self.intra_rnn = _TorchLSTM(dim, hidden, bidirectional)
        self.intra_proj = nn.Linear(d * hidden, dim)
        self.intra_norm = _MaskedGN1(dim)
        self.inter_rnn = _TorchLSTM(dim, hidden, bidirectional)
        self.inter_proj = nn.Linear(d * hidden, dim)
        self.inter_norm = _MaskedGN1(dim)

    @staticmethod
    def _norm(norm, h, seg_mask):
        b, s, k, n = h.shape
        m = None if seg_mask is None else seg_mask.reshape(b, s * k)
        return norm(h.reshape(b, s * k, n), m).reshape(b, s, k, n)

    def forward(self, x, seg_mask=None, lens=(None, None)):
        b, s, k, n = x.shape
        intra_m = None if seg_mask is None else seg_mask.reshape(b * s, k, 1)
        h = self.intra_rnn(x.reshape(b * s, k, n), intra_m, lens[0])
        h = self.intra_proj(h).reshape(b, s, k, n)
        x = x + self._norm(self.intra_norm, h, seg_mask)
        inter = x.transpose(1, 2).reshape(b * k, s, n)
        inter_m = None if seg_mask is None else seg_mask.transpose(1, 2).reshape(b * k, s, 1)
        h = self.inter_proj(self.inter_rnn(inter, inter_m, lens[1]))
        h = h.reshape(b, k, s, n).transpose(1, 2)
        return x + self._norm(self.inter_norm, h, seg_mask)


class DPRNNTasNet(_Registered):
    """Dual-path BiLSTM separator: relu conv encoder, GroupNorm(1) + 1x1
    bottleneck, interleaved K-chunk segmentation, dual-path blocks, PReLU
    -> speaker expansion -> overlap-add -> tanh x sigmoid gate -> 1x1 ->
    relu masks, transposed-conv decoder. With `lengths` a segment-space
    validity mask runs through the LSTMs and the norms, so a bucket-padded
    forward matches the exact-length one."""

    def __init__(self, enc_channels: int = 64, dim: int = 64, hidden: int = 128,
                 kernel_size: int = 2, chunk: int = 200, n_layers: int = 4, num_spks: int = 2,
                 bidirectional: bool = True, sample_rate: int = 16000):
        super().__init__()
        self.enc_channels, self.dim, self.kernel_size = enc_channels, dim, kernel_size
        self.chunk, self.n_layers = chunk, n_layers
        self.num_spks, self.sample_rate = num_spks, sample_rate
        stride = max(kernel_size // 2, 1)
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride, bias=False)
        self.in_norm = _MaskedGN1(enc_channels)
        self.bottleneck = nn.Linear(enc_channels, dim, bias=False)
        for i in range(n_layers):
            self.add_module(f"dp_{i}", _DPRNNBlock(dim, hidden, bidirectional))
        self.prelu = _PReLU()
        self.spk_expand = nn.Linear(dim, dim * num_spks)
        self.out_tanh = nn.Linear(dim, dim)
        self.out_sig = nn.Linear(dim, dim)
        self.mask_proj = nn.Linear(dim, enc_channels, bias=False)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride,
                                          bias=False)

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        x = torch.relu(_conv_tl(self.encoder, wav[:, :, None]))
        t = x.shape[1]
        mask = seg_mask = None
        lens = (None, None)
        if lengths is not None:
            enc_lens = _enc_frames(lengths, self.kernel_size, max(self.kernel_size // 2, 1), t)
            mask = _length_mask(enc_lens, t)
            x = x * mask[..., None]
        h = self.bottleneck(self.in_norm(x, mask))
        seg, gap = _segment_ref(h, self.chunk)
        if lengths is not None:
            seg_mask = _seg_valid_mask(enc_lens, t, self.chunk)
            # the valid steps of every intra and inter row, read once
            lens = (seg_mask[..., 0].sum(dim=2).reshape(-1).long().cpu(),
                    seg_mask[..., 0].sum(dim=1).reshape(-1).long().cpu())
        for i in range(self.n_layers):
            seg = getattr(self, f"dp_{i}")(seg, seg_mask, lens)
        seg = self.spk_expand(self.prelu(seg))
        s, k = seg.shape[1], seg.shape[2]
        seg = seg.reshape(b, s, k, self.num_spks, self.dim).permute(0, 3, 1, 2, 4)
        h = _over_add_ref(seg.reshape(b * self.num_spks, s, k, self.dim), gap)
        h = torch.tanh(self.out_tanh(h)) * torch.sigmoid(self.out_sig(h))
        m = torch.relu(self.mask_proj(h)).reshape(b, self.num_spks, t, self.enc_channels)
        return _mask_decode(x, m.permute(0, 2, 1, 3), self.decoder, self.num_spks, t_in)


# ---------------- DPTNet ----------------


class _TorchMHA(nn.Module):
    """Multi-head attention with packed in_proj parameters (in_w (3D, D))."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_w = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_b = nn.Parameter(torch.zeros(3 * dim))
        self.out_w = nn.Parameter(torch.zeros(dim, dim))
        self.out_b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        bsz, t, n = x.shape
        h, dh = self.heads, n // self.heads
        q, k, v = (F.linear(x, self.in_w, self.in_b).reshape(bsz, t, 3, h, dh)
                   .permute(2, 0, 3, 1, 4).unbind(0))
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        o = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(bsz, t, n)
        return F.linear(o, self.out_w, self.out_b)


class _ImprovedTransformer(nn.Module):
    """MHA + residual + gLN, then LSTM -> relu -> Linear + residual + gLN."""

    def __init__(self, dim: int, heads: int, hidden: int, bidirectional: bool = True):
        super().__init__()
        self.self_attn = _TorchMHA(dim, heads)
        self.norm_attn = _GLNBDT(dim)
        self.rnn = _TorchLSTM(dim, hidden, bidirectional)
        self.ff = nn.Linear((2 if bidirectional else 1) * hidden, dim)
        self.norm_ff = _GLNBDT(dim)

    def forward(self, x):
        out = self.norm_attn(self.self_attn(x) + x)
        h = self.ff(torch.relu(self.rnn(out)))
        return self.norm_ff(h + out)


def _split_unfold(x, seg: int):
    """(B, T, N) -> (B, S, seg, N): `seg` zero frames both sides, hop seg/2."""
    p = seg // 2
    return F.pad(x, (0, 0, seg, seg)).unfold(1, seg, p).transpose(2, 3)


def _merge_fold(seg_x, length: int):
    """Overlap-add of (B, S, K, N) at hop K/2 over fold(ones), the K-frame
    padding cropped."""
    b, s, k, n = seg_x.shape
    hop = k // 2
    width = length + 2 * k
    idx = (torch.arange(k, device=seg_x.device)[None, :]
           + hop * torch.arange(s, device=seg_x.device)[:, None]).reshape(-1)
    out = seg_x.new_zeros(b, width, n).index_add_(1, idx, seg_x.reshape(b, -1, n))
    norm = seg_x.new_zeros(width).index_add_(0, idx, seg_x.new_ones(idx.shape[0]))
    out = out / torch.clamp_min(norm, 1e-8)[None, :, None]
    return out[:, k: k + length]


class DPTNet(_Registered):
    """Dual-path transformer separator: relu conv encoder, gLN, unfold
    segmentation, intra/inter improved-transformer layers, PReLU ->
    speaker expansion, fold overlap-add, tanh x sigmoid gate, relu masks,
    transposed-conv decoder."""

    def __init__(self, enc_channels: int = 64, hidden: int = 128, heads: int = 4,
                 kernel_size: int = 16, stride: int = 8, chunk: int = 20, n_layers: int = 6,
                 num_spks: int = 2, bidirectional: bool = True, sample_rate: int = 16000):
        super().__init__()
        self.enc_channels, self.kernel_size, self.stride = enc_channels, kernel_size, stride
        self.chunk, self.n_layers = chunk, n_layers
        self.num_spks, self.sample_rate = num_spks, sample_rate
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride, bias=False)
        self.enc_ln = _GLNBDT(enc_channels)
        for i in range(n_layers):
            self.add_module(f"row_{i}", _ImprovedTransformer(enc_channels, heads, hidden, True))
            self.add_module(f"col_{i}", _ImprovedTransformer(enc_channels, heads, hidden,
                                                             bidirectional))
        self.prelu = _PReLU()
        self.spk_expand = nn.Linear(enc_channels, enc_channels * num_spks)
        self.out_tanh = nn.Linear(enc_channels, enc_channels)
        self.out_sig = nn.Linear(enc_channels, enc_channels)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride,
                                          bias=False)

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        x = torch.relu(_conv_tl(self.encoder, wav[:, :, None]))
        t = x.shape[1]
        mask = None
        if lengths is not None:
            mask = _length_mask(_enc_frames(lengths, self.kernel_size, self.stride, t), t)
            x = x * mask[..., None]
        seg = _split_unfold(self.enc_ln(x, mask), self.chunk)
        for i in range(self.n_layers):
            bb, s, k, n = seg.shape
            seg = getattr(self, f"row_{i}")(seg.reshape(bb * s, k, n)).reshape(bb, s, k, n)
            inter = getattr(self, f"col_{i}")(seg.transpose(1, 2).reshape(bb * k, s, n))
            seg = inter.reshape(bb, k, s, n).transpose(1, 2)
        seg = self.spk_expand(self.prelu(seg))
        s, k = seg.shape[1], seg.shape[2]
        c = self.enc_channels
        seg = seg.reshape(b, s, k, self.num_spks, c).permute(0, 3, 1, 2, 4)
        m = _merge_fold(seg.reshape(b * self.num_spks, s, k, c), t)
        m = torch.tanh(self.out_tanh(m)) * torch.sigmoid(self.out_sig(m))
        m = torch.relu(m).reshape(b, self.num_spks, t, c)
        return _mask_decode(x, m.permute(0, 2, 1, 3), self.decoder, self.num_spks, t_in)


# ---------------- SkiMNet ----------------


def _skim_norm(kind: str, dim: int) -> nn.Module:
    return _GLNBDT(dim) if kind == "gLN" else _CLNBDT(dim)


class _SkiMSingleLSTM(nn.Module):
    """LSTM + projection back to the input width."""

    def __init__(self, dim: int, hidden: int, bidirectional: bool):
        super().__init__()
        self.lstm = _TorchLSTM(dim, hidden, bidirectional)
        self.proj = nn.Linear((2 if bidirectional else 1) * hidden, dim)

    def forward(self, x):
        return self.proj(self.lstm(x))


class _SkiMSegLSTM(nn.Module):
    """Stateful LSTM over one segment, projection, residual + norm."""

    def __init__(self, dim: int, hidden: int, bidirectional: bool, norm_type: str):
        super().__init__()
        self.lstm = _StatefulTorchLSTM(dim, hidden, bidirectional)
        self.proj = nn.Linear((2 if bidirectional else 1) * hidden, dim)
        self.norm = _skim_norm(norm_type, dim)

    def forward(self, x, hc):
        out, hc_next = self.lstm(x, *hc)
        return x + self.norm(self.proj(out)), hc_next


class _SkiMMemLSTM(nn.Module):
    """LSTMs across the segments' boundary states (h, c), residual + norm;
    unidirectionally each segment receives the previous one's memory."""

    def __init__(self, hidden: int, bidirectional: bool, mem_type: str, norm_type: str):
        super().__init__()
        self.hidden, self.bidirectional, self.mem_type = hidden, bidirectional, mem_type
        dh = (2 if bidirectional else 1) * hidden
        if mem_type in ("hc", "h"):
            self.h_net = _SkiMSingleLSTM(dh, hidden, bidirectional)
            self.h_norm = _skim_norm(norm_type, dh)
        if mem_type in ("hc", "c"):
            self.c_net = _SkiMSingleLSTM(dh, hidden, bidirectional)
            self.c_norm = _skim_norm(norm_type, dh)

    def forward(self, h, c, s: int):
        d = 2 if self.bidirectional else 1
        dh = d * self.hidden
        bs = h.shape[1]
        b = bs // s
        if self.mem_type != "id":
            hb = h.transpose(0, 1).reshape(b, s, dh)
            cb = c.transpose(0, 1).reshape(b, s, dh)
            if self.mem_type in ("hc", "h"):
                hb = hb + self.h_norm(self.h_net(hb))
            if self.mem_type in ("hc", "c"):
                cb = cb + self.c_norm(self.c_net(cb))
            if self.mem_type == "h":
                cb = torch.zeros_like(cb)
            if self.mem_type == "c":
                hb = torch.zeros_like(hb)
            h = hb.reshape(bs, d, self.hidden).transpose(0, 1)
            c = cb.reshape(bs, d, self.hidden).transpose(0, 1)
        if not self.bidirectional:
            def shift(z):
                zb = F.pad(z.transpose(0, 1).reshape(b, s, dh), (0, 0, 1, 0))[:, :-1]
                return zb.reshape(bs, d, self.hidden).transpose(0, 1)

            h, c = shift(h), shift(c)
        return h, c


class SkiMNet(_Registered):
    """Skipping-memory LSTM separator: relu conv encoder, segment LSTMs
    whose (h, c) chain through boundary-state MemLSTMs, the always-pad-to-K
    segmentation (or the 50 %-overlap one), PReLU -> 1x1 mask head, and
    the double encoder product (the decoder sees e^2 m)."""

    def __init__(self, enc_channels: int = 64, hidden: int = 128, kernel_size: int = 16,
                 chunk: int = 150, n_layers: int = 3, num_spks: int = 2, causal: bool = True,
                 nonlinear: str = "relu", mem_type: str = "hc", seg_overlap: bool = False,
                 sample_rate: int = 16000):
        super().__init__()
        self.enc_channels, self.hidden, self.kernel_size = enc_channels, hidden, kernel_size
        self.chunk, self.n_layers, self.causal = chunk, n_layers, causal
        self.nonlinear, self.mem_type, self.seg_overlap = nonlinear, mem_type, seg_overlap
        self.num_spks, self.sample_rate = num_spks, sample_rate
        stride = kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride, bias=False)
        bidir = not causal
        norm_type = "cLN" if causal else "gLN"
        for i in range(n_layers):
            self.add_module(f"seg_{i}", _SkiMSegLSTM(enc_channels, hidden, bidir, norm_type))
            if mem_type and i < n_layers - 1:
                self.add_module(f"mem_{i}", _SkiMMemLSTM(hidden, bidir, mem_type, norm_type))
        self.out_prelu = _PReLU()
        self.out_conv = nn.Linear(enc_channels, enc_channels * num_spks)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride,
                                          bias=False)

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        x = torch.relu(_conv_tl(self.encoder, wav[:, :, None]))
        t = x.shape[1]
        if lengths is not None:
            x = x * _length_mask(_enc_frames(lengths, self.kernel_size,
                                             max(self.kernel_size // 2, 1), t), t)[..., None]
        dim, k = self.enc_channels, self.chunk
        if self.seg_overlap:
            seg, gap = _segment_ref(x, k)
        else:
            rest = k - t % k  # in 1..K: a whole extra segment when K divides T
            seg = F.pad(x, (0, 0, 0, rest)).reshape(b, -1, k, dim)
        s = seg.shape[1]
        out = seg.reshape(b * s, k, dim)
        nd = 1 if self.causal else 2
        hc = (x.new_zeros(nd, b * s, self.hidden), x.new_zeros(nd, b * s, self.hidden))
        for i in range(self.n_layers):
            out, hc = getattr(self, f"seg_{i}")(out, hc)
            if self.mem_type and i < self.n_layers - 1:
                hc = getattr(self, f"mem_{i}")(hc[0], hc[1], s)
        if self.seg_overlap:
            merged = _over_add_ref(out.reshape(b, s, k, dim), gap)
        else:
            merged = out.reshape(b, s * k, dim)[:, :t]
        proj = self.out_conv(self.out_prelu(merged))
        nl = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}[self.nonlinear]
        m = nl(proj.reshape(b, t, dim, self.num_spks))
        masks = m.transpose(2, 3) * x[:, :, None, :]  # e m; the decode multiplies by e again
        return _mask_decode(x, masks, self.decoder, self.num_spks, t_in)


# ---------------- SuDORMRF ----------------


class _SuDOConvNorm(nn.Module):
    """conv (bias) -> gLN (eps 1e-8) -> optional PReLU; time-major."""

    def __init__(self, nin: int, nout: int, k: int = 1, stride: int = 1, groups: int = 1,
                 act: bool = False, use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(nin, nout, k, stride=stride, padding=(k - 1) // 2, groups=groups,
                              bias=use_bias)
        self.norm = _GLNBDT(nout, eps=1e-8)
        self.act = _PReLU() if act else None

    def forward(self, x):
        h = self.norm(_conv_tl(self.conv, x))
        return self.act(h) if self.act is not None else h


class _SuDOBlock(nn.Module):
    """1x1 expand, a depthwise stride-2 pyramid, nearest x2 upsample-and-add
    refolding, gLN + PReLU, 1x1 contract, residual."""

    def __init__(self, out_channels: int, in_channels: int, depth: int = 4):
        super().__init__()
        c = in_channels
        self.depth = depth
        self.proj_1x1 = _SuDOConvNorm(out_channels, c, 1, act=True)
        self.spp_0 = _SuDOConvNorm(c, c, 5, 1, c)
        for k in range(1, depth):
            self.add_module(f"spp_{k}", _SuDOConvNorm(c, c, 5, 2, c))
        self.final_norm = _GLNBDT(c, eps=1e-8)
        self.final_act = _PReLU()
        self.res_conv = nn.Linear(c, out_channels)

    def forward(self, x):
        outs = [self.spp_0(self.proj_1x1(x))]
        for k in range(1, self.depth):
            outs.append(getattr(self, f"spp_{k}")(outs[-1]))
        for _ in range(self.depth - 1):
            up = torch.repeat_interleave(outs.pop(), 2, dim=1)
            outs[-1] = outs[-1] + up
        h = self.final_act(self.final_norm(outs[-1]))
        return self.res_conv(h) + x


def _lcm_pad(t_in: int, stride: int, depth: int) -> int:
    lcm = abs(stride * 2 ** depth) // math.gcd(stride, 2 ** depth)
    return (-t_in) % lcm


class SuDORMRF(_Registered):
    """Successive down/up-sampling separator: padded conv encoder, gLN + 1x1
    bottleneck, U-conv blocks, PReLU + 1x1 relu masks on the encoder,
    transposed-conv decoder with torch's padding/output_padding crop."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 4, enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, sample_rate: int = 16000):
        super().__init__()
        self.upsampling_depth, self.enc_kernel_size = upsampling_depth, enc_kernel_size
        self.enc_num_basis, self.num_blocks = enc_num_basis, num_blocks
        self.num_sources, self.sample_rate = num_sources, sample_rate
        k, s = enc_kernel_size, enc_kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_num_basis, k, stride=s, padding=s, bias=False)
        self.ln = _GLNBDT(enc_num_basis, eps=1e-8)
        self.bottleneck = nn.Linear(enc_num_basis, out_channels)
        for i in range(num_blocks):
            self.add_module(f"sm_{i}", _SuDOBlock(out_channels, in_channels, upsampling_depth))
        self.mask_prelu = _PReLU()
        self.mask_conv = nn.Linear(out_channels, num_sources * enc_num_basis)
        self.decoder = nn.ConvTranspose1d(num_sources * enc_num_basis, num_sources, k,
                                          stride=s, bias=False)

    @property
    def num_spks(self) -> int:
        return self.num_sources

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        k, s = self.enc_kernel_size, self.enc_kernel_size // 2
        x = F.pad(wav, (0, _lcm_pad(t_in, s, self.upsampling_depth)))
        x = _conv_tl(self.encoder, x[:, :, None])
        t = x.shape[1]
        mask = None
        if lengths is not None:
            mask = _length_mask(torch.clamp((lengths + 2 * s - k) // s + 1, 1, t), t)
            x = x * mask[..., None]
        h = self.bottleneck(self.ln(x, mask))
        for i in range(self.num_blocks):
            h = getattr(self, f"sm_{i}")(h)
        m = self.mask_conv(self.mask_prelu(h))
        m = torch.relu(m.reshape(b, t, self.num_sources, self.enc_num_basis))
        est = (m * x[:, :, None, :]).reshape(b, t, -1)
        y = self.decoder(est.transpose(1, 2))  # (B, spk, L_full)
        # torch ConvTranspose1d(padding=s, output_padding=s-1): s off the
        # left, 1 off the right
        return y[..., s: y.shape[-1] - 1][..., :t_in]


# ---------------- TDANet ----------------


def _adaptive_avg_pool(x, size: int):
    """adaptive_avg_pool1d over time, (B, T, C). Where `size` divides T this
    is the JAX package's mean over equal windows; elsewhere the JAX
    package raises (it takes only exact multiples, which TDANet's class
    defaults do not give), and this is torch's adaptive pooling, the
    reference model's."""
    t = x.shape[1]
    if t % size == 0:
        return x.reshape(x.shape[0], size, t // size, x.shape[-1]).mean(dim=2)
    return F.adaptive_avg_pool1d(x.transpose(1, 2), size).transpose(1, 2)


def _sinusoid_pe(t: int, dim: int, dtype, device):
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    pe = torch.zeros(t, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def _interp_nearest(x, size: int):
    """Nearest interpolation of (B, T, C) to `size` frames: src = floor(dst T / size)."""
    idx = (torch.arange(size, device=x.device) * x.shape[1]) // size
    return x[:, idx]


class _TDAGlobalAttention(nn.Module):
    """Pre-LN + sinusoid PE + MHA over the batch axis per frame (the
    reference feeds (B, T, N) to a sequence-first MHA), norm(2 out),
    residual, then a conv MLP with a depthwise conv."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.dim = dim
        self.attn_in_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _TorchMHA(dim, heads)
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = _SuDOConvNorm(dim, dim * 2, 1, use_bias=False)
        self.mlp_dwconv = nn.Conv1d(dim * 2, dim * 2, 5, padding=2, groups=dim * 2)
        self.mlp_fc2 = _SuDOConvNorm(dim * 2, dim, 1, use_bias=False)

    def forward(self, x):
        h = self.attn_in_norm(x)
        h = h + _sinusoid_pe(h.shape[1], self.dim, h.dtype, h.device)[None]
        h = self.attn(h.transpose(0, 1)).transpose(0, 1)
        x = x + self.attn_norm(h + h)
        m = torch.relu(_conv_tl(self.mlp_dwconv, self.mlp_fc1(x)))
        return x + self.mlp_fc2(m)


class _Injection(nn.Module):
    """Gated local/global fusion, depthwise, the global path nearest-
    interpolated to the local length."""

    def __init__(self, dim: int, k: int = 1, with_sum: bool = False):
        super().__init__()
        self.local_embedding = _SuDOConvNorm(dim, dim, k, groups=dim, use_bias=False)
        self.global_act = _SuDOConvNorm(dim, dim, k, groups=dim, use_bias=False)
        self.global_embedding = (_SuDOConvNorm(dim, dim, k, groups=dim, use_bias=False)
                                 if with_sum else None)

    def forward(self, x_l, x_g):
        t = x_l.shape[1]
        out = self.local_embedding(x_l) * _interp_nearest(torch.sigmoid(self.global_act(x_g)), t)
        if self.global_embedding is not None:
            out = out + _interp_nearest(self.global_embedding(x_g), t)
        return out


class _TDABlock(nn.Module):
    """Depthwise pyramid, adaptive-pooled global summary through global
    attention, per-level gated injection and the top-down refold (seeded
    with fused[depth - 3] at i = depth - 2, as the reference does)."""

    def __init__(self, out_channels: int, in_channels: int, depth: int = 4):
        super().__init__()
        c = in_channels
        self.depth = depth
        self.proj_1x1 = _SuDOConvNorm(out_channels, c, 1, act=True)
        self.spp_0 = _SuDOConvNorm(c, c, 5, 1, c)
        for k in range(1, depth):
            self.add_module(f"spp_{k}", _SuDOConvNorm(c, c, 5, 2, c))
        self.globalatt = _TDAGlobalAttention(c)
        for i in range(depth):
            self.add_module(f"fus_{i}", _Injection(c, 1, with_sum=False))
        for i in range(depth - 2, -1, -1):
            self.add_module(f"last_{i}", _Injection(c, 5, with_sum=True))
        self.res_conv = nn.Linear(c, out_channels)

    def forward(self, x):
        outs = [self.spp_0(self.proj_1x1(x))]
        for k in range(1, self.depth):
            outs.append(getattr(self, f"spp_{k}")(outs[-1]))
        t_last = outs[-1].shape[1]
        g = sum(_adaptive_avg_pool(f, t_last) for f in outs)
        g = self.globalatt(g)
        fused = [getattr(self, f"fus_{i}")(outs[i], g) for i in range(self.depth)]
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            src = fused[i - 1] if i == self.depth - 2 else expanded
            expanded = getattr(self, f"last_{i}")(fused[i], src)
        return self.res_conv(expanded) + x


class TDANet(_Registered):
    """Top-down attention pyramid separator: a millisecond-sized conv
    encoder (k = enc_kernel_size * sr / 1000, stride k/4, k/2 + 1 bases)
    after the reference's input padding, gLN + 1x1 bottleneck, one shared
    U-conv block applied `num_blocks` times with the mixture re-injected,
    PReLU + 1x1 relu masks, transposed-conv decoder with the reference's
    crops."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 4, enc_kernel_size: int = 21, num_sources: int = 2,
                 sample_rate: int = 16000):
        super().__init__()
        self.enc_kernel_size, self.num_blocks = enc_kernel_size, num_blocks
        self.num_sources, self.sample_rate = num_sources, sample_rate
        k = enc_kernel_size * sample_rate // 1000
        s, basis = k // 4, k // 2 + 1
        self.basis = basis
        self.encoder = nn.Conv1d(1, basis, k, stride=s, padding=k // 2, bias=False)
        self.ln = _GLNBDT(basis, eps=1e-8)
        self.bottleneck = nn.Linear(basis, out_channels)
        self.unet = _TDABlock(out_channels, in_channels, upsampling_depth)
        self.concat_conv = nn.Conv1d(out_channels, out_channels, 1, groups=out_channels)
        self.concat_act = _PReLU()
        self.mask_prelu = _PReLU()
        self.mask_conv = nn.Linear(out_channels, num_sources * basis)
        self.decoder = nn.ConvTranspose1d(num_sources * basis, num_sources, k, stride=s,
                                          bias=False)

    @property
    def num_spks(self) -> int:
        return self.num_sources

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        k = self.enc_kernel_size * self.sample_rate // 1000
        s = k // 4
        rest = k - (s + t_in % k) % k
        x = _conv_tl(self.encoder, F.pad(wav, (k - s, rest + (k - s)))[:, :, None])
        t = x.shape[1]
        mask = None
        if lengths is not None:
            mask = _length_mask(torch.clamp(
                (lengths + 2 * (k - s) + 2 * (k // 2) - k) // s + 1, 1, t), t)
            x = x * mask[..., None]
        h = self.bottleneck(self.ln(x, mask))
        mixture = h
        for i in range(self.num_blocks):
            h = self.unet(h if i == 0 else
                          self.concat_act(_conv_tl(self.concat_conv, mixture + h)))
        m = self.mask_conv(self.mask_prelu(h))
        m = torch.relu(m.reshape(b, t, self.num_sources, self.basis))
        est = (m * x[:, :, None, :]).reshape(b, t, -1)
        y = self.decoder(est.transpose(1, 2))
        y = y[..., k // 2: y.shape[-1] - k // 2]
        y = y[..., (k - s): y.shape[-1] - (rest + (k - s))]
        return y[..., :t_in]


# ---------------- BSRNN ----------------


class _ResRNN(nn.Module):
    """gLN -> BiLSTM -> Linear, residual. (B, T, dim)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = _GLNBDT(dim)
        self.rnn = _TorchLSTM(dim, hidden, True)
        self.proj = nn.Linear(2 * hidden, dim)

    def forward(self, x):
        return x + self.proj(self.rnn(self.norm(x)))


class _GroupedDense(nn.Module):
    """Grouped 1x1 conv with the groups' channel-major layout: w (G, in, out)."""

    def __init__(self, groups: int, in_per: int, out_per: int):
        super().__init__()
        self.groups, self.in_per, self.out_per = groups, in_per, out_per
        self.w = nn.Parameter(torch.zeros(groups, in_per, out_per))
        self.b = nn.Parameter(torch.zeros(groups, out_per))

    def forward(self, x):
        bs, t, _ = x.shape
        h = torch.einsum("btgi,gio->btgo", x.reshape(bs, t, self.groups, self.in_per), self.w)
        return (h + self.b).reshape(bs, t, self.groups * self.out_per)


def bsrnn_band_widths(sample_rate: int, enc_dim: int) -> list:
    """The music band plan: 20 x 50 Hz, 10 x 100 Hz, 8 x 250 Hz, 8 x 500 Hz,
    the rest in one band."""
    widths = []
    for hz, n in ((50, 20), (100, 10), (250, 8), (500, 8)):
        widths += [int(np.floor(hz / (sample_rate / 2.0) * enc_dim))] * n
    widths.append(enc_dim - int(np.sum(widths)))
    return widths


class BSRNN(_Registered):
    """Band-split RNN: STFT, per-band gLN + 1x1 bottleneck, `num_repeat`
    band-time and band-communication ResRNNs, per-band grouped mask heads
    with tanh x sigmoid gates and the sum-to-one mask normalisation,
    complex mask multiply, iSTFT. Returns (B, num_output, T)."""

    def __init__(self, sample_rate: int = 44100, win: int = 2048, stride: int = 512,
                 feature_dim: int = 128, num_repeat: int = 12, num_output: int = 4,
                 num_spks: int = 4):
        super().__init__()
        self.sample_rate, self.win, self.stride = sample_rate, win, stride
        self.feature_dim, self.num_repeat = feature_dim, num_repeat
        self.num_output, self.num_spks = num_output, num_spks
        enc_dim = win // 2 + 1
        self.widths = bsrnn_band_widths(sample_rate, enc_dim)
        if min(self.widths) < 1:
            raise ValueError(f"BSRNN band plan degenerates at sr={sample_rate}, "
                             f"win={win}: {self.widths}")
        n, k = feature_dim, num_output
        for i, bw in enumerate(self.widths):
            self.add_module(f"bn_{i}_norm", _GLNBDT(2 * bw))
            self.add_module(f"bn_{i}_proj", nn.Linear(2 * bw, n))
        for r in range(num_repeat):
            self.add_module(f"sep_{r}_band_rnn", _ResRNN(n, 2 * n))
            self.add_module(f"sep_{r}_band_comm", _ResRNN(n, 2 * n))
        for i, bw in enumerate(self.widths):
            self.add_module(f"mask_{i}_norm", _GLNBDT(n))
            self.add_module(f"mask_{i}_pre", nn.Linear(n, n * k))
            self.add_module(f"mask_{i}_g1", _GroupedDense(k, n, 2 * n))
            self.add_module(f"mask_{i}_g2", _GroupedDense(k, 2 * n, 4 * bw))

    def reduced_modules(self) -> tuple:
        return ()  # the float32 STFT window promotes the input

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        nband, k = len(self.widths), self.num_output
        spec_t = stft(wav, self.win, self.stride).transpose(1, 2)  # (B, T, F)
        tt = spec_t.shape[1]
        feats, bi = [], 0
        for i, bw in enumerate(self.widths):
            sb = spec_t[..., bi: bi + bw]
            h = getattr(self, f"bn_{i}_norm")(torch.cat([sb.real, sb.imag], dim=-1))
            feats.append(getattr(self, f"bn_{i}_proj")(h))
            bi += bw
        h = torch.stack(feats, dim=1)  # (B, nband, T, N)
        n = self.feature_dim
        for r in range(self.num_repeat):
            y = getattr(self, f"sep_{r}_band_rnn")(h.reshape(b * nband, tt, n))
            z = y.reshape(b, nband, tt, n).transpose(1, 2).reshape(b * tt, nband, n)
            z = getattr(self, f"sep_{r}_band_comm")(z)
            h = z.reshape(b, tt, nband, n).transpose(1, 2)
        est_bands, bi = [], 0
        for i, bw in enumerate(self.widths):
            x = getattr(self, f"mask_{i}_norm")(h[:, i])
            x = torch.tanh(getattr(self, f"mask_{i}_pre")(x))
            x = torch.tanh(getattr(self, f"mask_{i}_g1")(x))
            o = getattr(self, f"mask_{i}_g2")(x).reshape(b, tt, 2, 2, k, bw)
            m = o[:, :, 0] * torch.sigmoid(o[:, :, 1])  # (B, T, 2, K, bw)
            mr, mi = m[:, :, 0], m[:, :, 1]
            mr = mr - (mr.sum(dim=2, keepdim=True) - 1.0) / k
            mi = mi - mi.sum(dim=2, keepdim=True) / k
            sb = spec_t[..., bi: bi + bw][:, :, None]
            est_bands.append(torch.complex(sb.real * mr - sb.imag * mi,
                                           sb.real * mi + sb.imag * mr))
            bi += bw
        est = torch.cat(est_bands, dim=-1)  # (B, T, K, F)
        est = est.permute(0, 2, 3, 1).reshape(b * k, -1, tt)
        return istft(est, self.win, self.stride, length=t_in).reshape(b, k, t_in)


# ---------------- TFGridNet ----------------


class _LN4DCF(nn.Module):
    """Normalise (B, T, F, C) over (F, C) per frame; gamma/beta (F, C)."""

    def __init__(self, dim: int, n_freqs: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(n_freqs, dim))
        self.beta = nn.Parameter(torch.zeros(n_freqs, dim))

    def forward(self, x):
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mu).square().mean(dim=(2, 3), keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.gamma + self.beta


class _AllHeadPReLULN4DCF(nn.Module):
    """Per-head PReLU, then normalise (B, T, F, H, E) over (F, E) per head
    and frame; gamma/beta (F, H, E)."""

    def __init__(self, heads: int, e_dim: int, n_freqs: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.full((heads,), 0.25))
        self.gamma = nn.Parameter(torch.ones(n_freqs, heads, e_dim))
        self.beta = nn.Parameter(torch.zeros(n_freqs, heads, e_dim))

    def forward(self, x):
        a = self.alpha[None, None, None, :, None]
        x = torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)
        mu = x.mean(dim=(2, 4), keepdim=True)
        var = (x - mu).square().mean(dim=(2, 4), keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.gamma + self.beta


class _GridNetV2Block(nn.Module):
    """Unfolded BiLSTMs over frequency (intra) and time (inter), each
    refolded by a transposed conv (a Linear when emb_ks == emb_hs), then
    full-band T x T attention with per-head PReLU-LayerNormed Q/K/V and a
    (C, F)-normalised output projection. (B, T, F, C)."""

    def __init__(self, emb_dim: int, emb_ks: int, emb_hs: int, n_freqs: int, hidden: int,
                 n_head: int = 4, approx_qk_dim: int = 512, eps: float = 1e-5):
        super().__init__()
        c, ks, hs = emb_dim, emb_ks, emb_hs
        self.ks, self.hs, self.n_head = ks, hs, n_head
        self.intra_norm = nn.LayerNorm(c, eps=eps)
        self.inter_norm = nn.LayerNorm(c, eps=eps)
        self.intra_rnn = _TorchLSTM(c * ks, hidden, True)
        self.inter_rnn = _TorchLSTM(c * ks, hidden, True)
        if ks == hs:
            self.intra_linear = nn.Linear(2 * hidden, ks * c)
            self.inter_linear = nn.Linear(2 * hidden, ks * c)
        else:
            self.intra_linear = nn.ConvTranspose1d(2 * hidden, c, ks, stride=hs)
            self.inter_linear = nn.ConvTranspose1d(2 * hidden, c, ks, stride=hs)
        self.e_dim = -(-approx_qk_dim // n_freqs)
        self.cv = c // n_head
        self.attn_conv_Q = nn.Linear(c, n_head * self.e_dim)
        self.attn_norm_Q = _AllHeadPReLULN4DCF(n_head, self.e_dim, n_freqs, eps)
        self.attn_conv_K = nn.Linear(c, n_head * self.e_dim)
        self.attn_norm_K = _AllHeadPReLULN4DCF(n_head, self.e_dim, n_freqs, eps)
        self.attn_conv_V = nn.Linear(c, n_head * self.cv)
        self.attn_norm_V = _AllHeadPReLULN4DCF(n_head, self.cv, n_freqs, eps)
        self.attn_proj = nn.Linear(n_head * self.cv, c)
        self.attn_act = _PReLU()
        self.attn_ln = _LN4DCF(c, n_freqs, eps)

    def _unfold(self, seq):
        # (N, L, C) -> (N, n_win, C ks), feature c ks + k (F.unfold's packing)
        return seq.unfold(1, self.ks, self.hs).reshape(seq.shape[0], -1,
                                                       seq.shape[2] * self.ks)

    def _path(self, h, length: int, rnn, lin):
        c = h.shape[-1]
        if self.ks == self.hs:
            hh = rnn(h.reshape(h.shape[0], length // self.ks, self.ks * c))
            return lin(hh).reshape(h.shape[0], length, c)
        return lin(rnn(self._unfold(h)).transpose(1, 2)).transpose(1, 2)

    def forward(self, x):
        b, old_t, old_q, c = x.shape
        ks, hs = self.ks, self.hs
        olp = ks - hs
        t_pad = -(-(old_t + 2 * olp - ks) // hs) * hs + ks
        q_pad = -(-(old_q + 2 * olp - ks) // hs) * hs + ks
        x = F.pad(x, (0, 0, olp, q_pad - old_q - olp, olp, t_pad - old_t - olp))
        h = self._path(self.intra_norm(x).reshape(b * t_pad, q_pad, c), q_pad,
                       self.intra_rnn, self.intra_linear)
        x = x + h.reshape(b, t_pad, q_pad, c)
        h = self.inter_norm(x).transpose(1, 2).reshape(b * q_pad, t_pad, c)
        h = self._path(h, t_pad, self.inter_rnn, self.inter_linear)
        x = x + h.reshape(b, q_pad, t_pad, c).transpose(1, 2)
        x = x[:, olp: olp + old_t, olp: olp + old_q]

        nh, e, cv = self.n_head, self.e_dim, self.cv
        q = self.attn_norm_Q(self.attn_conv_Q(x).reshape(b, old_t, old_q, nh, e))
        k = self.attn_norm_K(self.attn_conv_K(x).reshape(b, old_t, old_q, nh, e))
        v = self.attn_norm_V(self.attn_conv_V(x).reshape(b, old_t, old_q, nh, cv))

        def flat(z, width):  # (B, T, F, H, E) -> (B H, T, E F)
            return z.permute(0, 3, 1, 4, 2).reshape(b * nh, old_t, width * old_q)

        qf, kf, vf = flat(q, e), flat(k, e), flat(v, cv)
        attn = torch.softmax(torch.matmul(qf, kf.transpose(1, 2))
                             / math.sqrt(e * old_q), dim=-1)
        out = torch.matmul(attn, vf).reshape(b, nh, old_t, cv, old_q)
        out = out.permute(0, 2, 4, 1, 3).reshape(b, old_t, old_q, nh * cv)
        out = self.attn_ln(self.attn_act(self.attn_proj(out)))
        return out + x


class TFGridNet(_Registered):
    """TF-GridNet: input std normalisation, centred hann STFT, 3x3 conv +
    GroupNorm(1) embedding, GridNetV2 blocks, 3x3 transposed conv to each
    source's real/imag spectrum, iSTFT, std denormalisation. `lengths`
    masks STFT frames; the std still spans the padding."""

    def __init__(self, n_srcs: int = 2, n_fft: int = 128, stride: int = 64, n_layers: int = 6,
                 lstm_hidden_units: int = 192, attn_n_head: int = 4,
                 attn_approx_qk_dim: int = 512, emb_dim: int = 48, emb_ks: int = 4,
                 emb_hs: int = 1, eps: float = 1e-5, sample_rate: int = 16000):
        super().__init__()
        self.n_srcs, self.n_fft, self.stride, self.n_layers = n_srcs, n_fft, stride, n_layers
        self.sample_rate = sample_rate
        n_freqs = n_fft // 2 + 1
        self.conv = nn.Conv2d(2, emb_dim, 3, padding=1)
        self.conv_norm = _MaskedGN1(emb_dim, eps=eps)
        for i in range(n_layers):
            self.add_module(f"block_{i}", _GridNetV2Block(
                emb_dim, emb_ks, emb_hs, n_freqs, lstm_hidden_units, attn_n_head,
                attn_approx_qk_dim, eps))
        self.deconv = nn.ConvTranspose2d(emb_dim, n_srcs * 2, 3)

    @property
    def num_spks(self) -> int:
        return self.n_srcs

    def reduced_modules(self) -> tuple:
        return ()  # the float32 STFT window promotes the normalised input

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        mix_std = torch.std(wav, dim=1, keepdim=True)  # Bessel-corrected
        spec = stft(wav / mix_std, self.n_fft, self.stride)  # (B, F, T)
        f, tt = spec.shape[1], spec.shape[2]
        if lengths is not None:
            olens = (lengths + 2 * (self.n_fft // 2) - self.n_fft) // self.stride + 1
            spec = spec * _length_mask(torch.clamp(olens, 1, tt), tt)[:, None]
        x = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)  # (B, 2, T, F)
        x = self.conv(x).permute(0, 2, 3, 1)                           # (B, T, F, C)
        x = self.conv_norm(x)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.deconv(x.permute(0, 3, 1, 2))[:, :, 1:-1, 1:-1]      # (B, 2 S, T, F)
        x = x.reshape(b, self.n_srcs, 2, tt, f)
        est = torch.complex(x[:, :, 0], x[:, :, 1]).transpose(2, 3)    # (B, S, F, T)
        wavs = istft(est.reshape(b * self.n_srcs, f, tt), self.n_fft, self.stride,
                     length=t_in).reshape(b, self.n_srcs, t_in)
        return wavs * mix_std[:, None]


# ---------------- MossFormer (v1) ----------------


class MossFormer(_Registered):
    """MossFormer v1: MossFormer2's encoder, FlashBlocks and decoder without
    the gated FSMN blocks; each block runs three FFConvM kernels and one
    gated FLASH kernel."""

    def __init__(self, dim: int = 512, enc_channels: int = 512, num_blocks: int = 24,
                 kernel_size: int = 16, num_spks: int = 2, group_size: int = 256,
                 qk_dim: int = 128, sample_rate: int = 16000):
        super().__init__()
        self.enc_channels, self.num_blocks, self.kernel_size = enc_channels, num_blocks, kernel_size
        self.num_spks, self.group_size, self.sample_rate = num_spks, group_size, sample_rate
        stride = kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride, bias=False)
        self.in_norm = GlobalLayerNorm(enc_channels)
        self.bottleneck = nn.Linear(enc_channels, dim, bias=False)
        for i in range(num_blocks):
            self.add_module(f"flash_{i}", FlashBlock(dim, group_size=group_size, qk_dim=qk_dim))
        self.out_ln = nn.LayerNorm(dim, eps=1e-6)
        self.mask_out = nn.Linear(dim, enc_channels * num_spks)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride, bias=False)

    def reduced_modules(self) -> tuple:
        return (self,)  # its mask is in the stream's type: nothing promotes the stream

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        if lengths is None:
            lengths = torch.full((b,), t_in, device=wav.device, dtype=torch.long)
        stride = self.kernel_size // 2
        x = torch.relu(_conv_tl(self.encoder, wav[:, :, None]))
        t_enc = x.shape[1]
        pad = (-t_enc) % self.group_size
        xp = F.pad(x, (0, 0, 0, pad))
        enc_lengths = _enc_frames(lengths, self.kernel_size, stride, t_enc)
        mask = _length_mask(enc_lengths, t_enc + pad, x.dtype)
        h = self.bottleneck(self.in_norm(xp, mask))
        for i in range(self.num_blocks):
            h = getattr(self, f"flash_{i}")(h, mask)
        m = self.mask_out(torch.relu(self.out_ln(h)))
        m = torch.relu(m).reshape(b, t_enc + pad, self.num_spks, self.enc_channels)[:, :t_enc]
        return _mask_decode(x, m, self.decoder, self.num_spks, t_in)


# ---------------------------------------------------------------------------
# Padded-bucket safety: the JAX package's measured max relative deviation of
# a bucket-padded forward (with `lengths`) from the exact-length one, per
# class. Classes above PAD_SAFE_THRESHOLD run at exact lengths in the engine.

PADDED_BUCKET_DEVIATION = {
    "MossFormer2": 0.0,
    "ConvTasNet": 3.5e-7,
    "SkiMNet": 0.0,
    "DPRNNTasNet": 1e-5,
    "MossFormer": 3.7e-2,
    "AFRCNN": 0.12,
    "SuDORMRF": 0.12,
    "DPTNet": 0.13,
    "BSRNN": 0.18,
    "TDANet": 0.27,
    "TFGridNet": 0.38,
}

PAD_SAFE_THRESHOLD = 5e-2


def pad_safe(model) -> bool:
    """True if bucket-padded forwards of this class are numerically safe;
    unknown classes are not."""
    return PADDED_BUCKET_DEVIATION.get(type(model).__name__, 1.0) <= PAD_SAFE_THRESHOLD


# ---------------- A-FRCNN ----------------


class _AFRCNNBlock(nn.Module):
    """1x1 expand, depthwise stride-2 pyramid, neighbour fusion (down(i-1)
    | i | nearest-up(i+1) -> 1x1), all-level nearest collapse, 1x1
    contract, residual."""

    def __init__(self, out_channels: int, in_channels: int, depth: int = 4):
        super().__init__()
        c = in_channels
        self.depth = depth
        self.proj_1x1 = _SuDOConvNorm(out_channels, c, 1, act=True)
        self.spp_0 = _SuDOConvNorm(c, c, 5, 1, c)
        for k in range(1, depth):
            self.add_module(f"spp_{k}", _SuDOConvNorm(c, c, 5, 2, c))
        for i in range(depth):
            if i >= 1:
                self.add_module(f"fuse_{i}", _SuDOConvNorm(c, c, 5, 2, c))
            parts = 1 + (i >= 1) + (i + 1 < depth)
            self.add_module(f"concat_{i}", _SuDOConvNorm(parts * c, c, 1, act=True))
        self.last = _SuDOConvNorm(depth * c, c, 1, act=True)
        self.res_conv = nn.Linear(c, out_channels)

    def forward(self, x):
        outs = [self.spp_0(self.proj_1x1(x))]
        for k in range(1, self.depth):
            outs.append(getattr(self, f"spp_{k}")(outs[-1]))
        fused = []
        for i in range(self.depth):
            parts = []
            if i >= 1:
                parts.append(getattr(self, f"fuse_{i}")(outs[i - 1]))
            parts.append(outs[i])
            if i + 1 < self.depth:
                parts.append(_interp_nearest(outs[i + 1], outs[i].shape[1]))
            fused.append(getattr(self, f"concat_{i}")(torch.cat(parts, dim=-1)))
        full = outs[0].shape[1]
        cat = torch.cat([fused[0]] + [_interp_nearest(f, full) for f in fused[1:]], dim=-1)
        return self.res_conv(self.last(cat)) + x


class AFRCNN(_Registered):
    """Asynchronous fully recurrent CNN: SuDORMRF's front and back end
    around one block applied `num_blocks` times with shared weights, the
    bottleneck mixture re-injected through a depthwise 1x1 + PReLU."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 4, enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, sample_rate: int = 16000):
        super().__init__()
        self.upsampling_depth, self.enc_kernel_size = upsampling_depth, enc_kernel_size
        self.enc_num_basis, self.num_blocks = enc_num_basis, num_blocks
        self.num_sources, self.sample_rate = num_sources, sample_rate
        k, s = enc_kernel_size, enc_kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_num_basis, k, stride=s, padding=s, bias=False)
        self.ln = _GLNBDT(enc_num_basis, eps=1e-8)
        self.bottleneck = nn.Linear(enc_num_basis, out_channels)
        self.blocks = _AFRCNNBlock(out_channels, in_channels, upsampling_depth)
        self.concat_conv = nn.Conv1d(out_channels, out_channels, 1, groups=out_channels)
        self.concat_act = _PReLU()
        self.mask_prelu = _PReLU()
        self.mask_conv = nn.Linear(out_channels, num_sources * enc_num_basis)
        self.decoder = nn.ConvTranspose1d(num_sources * enc_num_basis, num_sources, k,
                                          stride=s, bias=False)

    @property
    def num_spks(self) -> int:
        return self.num_sources

    def forward(self, wav, lengths=None):
        b, t_in = wav.shape
        k, s = self.enc_kernel_size, self.enc_kernel_size // 2
        x = F.pad(wav, (0, _lcm_pad(t_in, s, self.upsampling_depth)))
        x = _conv_tl(self.encoder, x[:, :, None])
        t = x.shape[1]
        mask = None
        if lengths is not None:
            mask = _length_mask(torch.clamp((lengths + 2 * s - k) // s + 1, 1, t), t)
            x = x * mask[..., None]
        h = self.bottleneck(self.ln(x, mask))
        mixture = h
        for i in range(self.num_blocks):
            h = self.blocks(h if i == 0 else
                            self.concat_act(_conv_tl(self.concat_conv, mixture + h)))
        m = self.mask_conv(self.mask_prelu(h))
        m = torch.relu(m.reshape(b, t, self.num_sources, self.enc_num_basis))
        est = (m * x[:, :, None, :]).reshape(b, t, -1)
        y = self.decoder(est.transpose(1, 2))
        return y[..., s: y.shape[-1] - 1][..., :t_in]


CLASSES = {cls.__name__: cls for cls in (ConvTasNet, DPRNNTasNet, DPTNet, SuDORMRF, SkiMNet,
                                         BSRNN, TDANet, TFGridNet, MossFormer, AFRCNN)}
