"""Apollo band-split audio restoration, and its windowed engine.

Counterpart of targetdiarization_tpu/models/restoration.py. Per window:
STFT (20 ms window, 10 ms hop) -> per band, the bins over the band's
power and the log power -> per-band RMSNorm and bottleneck to
`feature_dim` (the 79 uniform bands as one stacked product, the ragged
tail band on its own) -> `layer` x BSNet (attention across the bands
with RoPE over the band index, then three residual depthwise-conv
blocks along time) -> per-band RMSNorm and GLU heads -> complex spectrum
-> iSTFT. The modules keep the JAX names, so its parameter tree converts
by `runtime/convert.py::apollo_state_dict`.

The depthwise conv of each `ConvActNorm` goes through `ops.dw_conv1d`:
on the card `csrc/dwconv.cu`, with taps made once by `prepare_kernels`.

Types: the JAX engine rounds its parameters to the compute type and
computes in float32 (its STFT window and the float32 stream promote
every product), so in bf16 the port rounds the weights and computes in
float32 too (`promote_after` with no bf16 module).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dwconv import dw_conv1d
from ..ops.kernels import prepare_kernels
from ..ops.kernels.dwconv import prepare_taps
from ..ops.stft import istft, stft
from ..runtime.buckets import BucketLadder
from ..runtime.precision import exact_float32, promote_after, resolve_compute_dtype

EPS = 1.1920928955078125e-07  # float32 eps


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):  # over the last axis
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-5) * self.weight


def _rope_tables(k: int, hd: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, hd) cos and sin of band index x 1/10000^(2i/hd), each angle
    repeated for its pair of channels."""
    freq = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device=device, dtype=torch.float32) / hd))
    ang = torch.arange(k, device=device, dtype=torch.float32)[:, None] * freq[None, :]
    return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
            torch.repeat_interleave(torch.sin(ang), 2, dim=-1))


def _rope(z, cos, sin):
    """Interleaved pairs (z0, z1) -> (z0 cos - z1 sin, z1 cos + z0 sin);
    z (..., K, hd), tables (K, hd)."""
    z2 = z.reshape(*z.shape[:-1], -1, 2)
    z_neg = torch.stack([-z2[..., 1], z2[..., 0]], dim=-1).reshape(z.shape)
    return z * cos + z_neg * sin


class BandRoformer(nn.Module):
    """Multi-head attention across the band axis with RoPE, then a gated
    MLP, both residual."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_norm = RMSNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.out = nn.Linear(dim, dim, bias=False)
        self.mlp_norm = RMSNorm(dim)
        self.mlp_in = nn.Linear(dim, dim * 8, bias=False)
        self.mlp_out = nn.Linear(dim * 4, dim, bias=False)

    def _attend(self, x):
        """x (B, K, T, N) -> the attention's output before `out`, (B, K, T, N)."""
        b, k, t, n = x.shape
        hd = n // self.heads
        # (B, T, 3, H, K, hd): attention over K for every (stream, frame)
        qkv = self.qkv(self.in_norm(x)).reshape(b, k, t, 3, self.heads, hd)
        qkv = qkv.permute(0, 2, 3, 4, 1, 5).reshape(b * t, 3, self.heads, k, hd)
        cos, sin = _rope_tables(k, hd, x.device)
        q, kk, v = qkv.unbind(1)
        out = F.scaled_dot_product_attention(_rope(q, cos, sin), _rope(kk, cos, sin), v)
        return out.reshape(b, t, self.heads, k, hd).permute(0, 3, 1, 2, 4).reshape(b, k, t, n)

    def forward(self, x):
        x = x + self.out(self._attend(x))
        gate, z = F.silu(self.mlp_in(self.mlp_norm(x))).chunk(2, dim=-1)
        return x + self.mlp_out(F.silu(gate) * z)


class DepthwiseConv1d(nn.Module):
    """SAME depthwise conv over time with a bias; kernel (K, 1, C), the JAX
    layout."""

    def __init__(self, dim: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.kernel = nn.Parameter(torch.zeros(kernel, 1, dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.taps = None

    def prepare_kernel(self, owner: str = ""):
        self.taps = prepare_taps(self.kernel, owner)

    def forward(self, x):  # (B, T, C)
        return dw_conv1d(x, self.kernel, dilation=self.dilation, padding="SAME",
                         taps=self.taps) + self.bias


class ConvActNorm(nn.Module):
    """Residual depthwise conv -> RMSNorm -> Dense 4x -> SiLU -> Dense."""

    def __init__(self, dim: int, kernel: int = 7):
        super().__init__()
        self.dw = DepthwiseConv1d(dim, kernel)
        self.norm = RMSNorm(dim)
        self.up = nn.Linear(dim, dim * 4)
        self.down = nn.Linear(dim * 4, dim)

    def forward(self, x):  # (..., T, N)
        return x + self.down(F.silu(self.up(self.norm(self.dw(x)))))


class BSNet(nn.Module):
    """One band-split layer: band attention, then three time blocks."""

    def __init__(self, dim: int):
        super().__init__()
        self.band_net = BandRoformer(dim)
        for i in range(3):
            self.add_module(f"icb_{i}", ConvActNorm(dim))

    def forward(self, x):  # (B, K, T, N)
        x = self.band_net(x)
        b, k, t, n = x.shape
        h = x.reshape(b * k, t, n)
        for i in range(3):
            h = getattr(self, f"icb_{i}")(h)
        return h.reshape(b, k, t, n)


class RMSNormBanked(nn.Module):
    """Per-band RMSNorm with a (nband, dim) weight bank; x (B, K, T, D)."""

    def __init__(self, nband: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(nband, dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-5) \
            * self.weight[None, :, None, :]


def _band_feats(sub):
    """sub (BC, K, bins, T) complex -> (BC, K, 2 bins + 1, T): real and
    imaginary parts over the band's power, and the log power."""
    power = torch.sqrt(sub.abs().square().sum(dim=2, keepdim=True) + EPS)
    norm = sub / power
    return torch.cat([norm.real, norm.imag, torch.log(power)], dim=2)


def _rms(x, dim: int):
    return torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + 1e-5)


class Apollo(nn.Module):
    """Band-split restoration: sr, window in ms, feature width and layer
    count as the checkpoint's `model_args` give them."""

    def __init__(self, sr: int = 44100, win_ms: int = 20, feature_dim: int = 256,
                 layer: int = 6):
        super().__init__()
        self.sr, self.win_ms, self.feature_dim, self.layer = sr, win_ms, feature_dim, layer
        bw, n_uni, tail = self._bands()
        d = feature_dim
        self.uni_norm_w = nn.Parameter(torch.ones(n_uni, 2 * bw + 1))
        self.uni_bn_w = nn.Parameter(torch.zeros(n_uni, 2 * bw + 1, d))
        self.uni_bn_b = nn.Parameter(torch.zeros(n_uni, d))
        self.tail_norm_w = nn.Parameter(torch.ones(2 * tail + 1))
        self.tail_bn_w = nn.Parameter(torch.zeros(2 * tail + 1, d))
        self.tail_bn_b = nn.Parameter(torch.zeros(d))
        for i in range(layer):
            self.add_module(f"bsnet_{i}", BSNet(d))
        self.out_norm = RMSNormBanked(n_uni + 1, d)
        self.uni_out_w = nn.Parameter(torch.zeros(n_uni, d, bw * 4))
        self.uni_out_b = nn.Parameter(torch.zeros(n_uni, bw * 4))
        self.tail_out_w = nn.Parameter(torch.zeros(d, tail * 4))
        self.tail_out_b = nn.Parameter(torch.zeros(tail * 4))

    @property
    def win(self) -> int:
        return int(self.sr * self.win_ms // 1000)

    @property
    def stride(self) -> int:
        return self.win // 2

    @property
    def enc_dim(self) -> int:
        return self.win // 2 + 1

    def _bands(self):
        bw = int(self.win / 160)
        n_uniform = 79
        return bw, n_uniform, self.enc_dim - bw * n_uniform

    def forward(self, wav, return_spec: bool = False):
        """wav (B, T) -> (B, T) restored, in float32 (or the model's type);
        with `return_spec`, the estimated spectrum's real and imaginary
        planes (B, F, frames, 2) in place of the waveform (the training
        recipe's losses are on the spectrum)."""
        b, nsample = wav.shape
        bw, n_uni, tail = self._bands()
        spec = stft(wav, self.win, self.stride)  # (B, F, T) complex
        t = spec.shape[-1]
        uni_f = _band_feats(spec[:, : bw * n_uni].reshape(b, n_uni, bw, t))
        tail_f = _band_feats(spec[:, bw * n_uni:][:, None])  # (B, 1, 2 tail + 1, T)

        uni_n = uni_f * _rms(uni_f, 2) * self.uni_norm_w[None, :, :, None]
        uni_emb = torch.einsum("bkct,kcd->bkdt", uni_n, self.uni_bn_w) \
            + self.uni_bn_b[None, :, :, None]
        tail_n = tail_f * _rms(tail_f, 2) * self.tail_norm_w[None, None, :, None]
        tail_emb = torch.einsum("bkct,cd->bkdt", tail_n, self.tail_bn_w) \
            + self.tail_bn_b[None, None, :, None]
        feat = torch.cat([uni_emb, tail_emb], dim=1).transpose(2, 3)  # (B, nband, T, D)

        for i in range(self.layer):
            feat = getattr(self, f"bsnet_{i}")(feat)

        feat = self.out_norm(feat)
        uni_out = torch.einsum("bktd,kdc->bktc", feat[:, :n_uni], self.uni_out_w) \
            + self.uni_out_b[None, :, None, :]
        val, gate = uni_out.chunk(2, dim=-1)
        uni_ri = val * torch.sigmoid(gate)  # (B, 79, T, 2 bw)
        uni_real = uni_ri[..., :bw].transpose(2, 3).reshape(b, n_uni * bw, t)
        uni_imag = uni_ri[..., bw:].transpose(2, 3).reshape(b, n_uni * bw, t)
        tail_out = feat[:, -1] @ self.tail_out_w + self.tail_out_b
        tval, tgate = tail_out.chunk(2, dim=-1)
        tail_ri = tval * torch.sigmoid(tgate)
        est_real = torch.cat([uni_real, tail_ri[..., :tail].transpose(1, 2)], dim=1)
        est_imag = torch.cat([uni_imag, tail_ri[..., tail:].transpose(1, 2)], dim=1)
        if return_spec:
            return torch.stack([est_real, est_imag], dim=-1)
        return istft(torch.complex(est_real, est_imag), self.win, self.stride, length=nsample)


class RestorationEngine:
    """Windowed restoration with overlap-add (6 s windows every 3 s at the
    model's rate, a triangular cross-fade); a clip that fits one window
    runs at a rung of 100, 200 or 400 frames, or the window."""

    def __init__(self, model: Apollo, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None, window_s: float = 6.0, hop_s: float = 3.0):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = promote_after(model.to(self.device), (), self.compute_dtype).eval()
        prepare_kernels(self.model)
        self.window = int(window_s * model.sr)
        self.hop = int(hop_s * model.sr)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "RestorationEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """Device (B, T) float32 -> (B, T) float32."""
        with torch.inference_mode(), exact_float32():
            return self.model(wav).float()

    def restore(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        from ..ops.chunk import chunk_signal, merge_chunks
        from ..ops.resample import resample_poly_np

        audio = np.asarray(audio, np.float32)
        t_orig = len(audio)
        if t_orig == 0:
            return audio
        msr = self.model.sr
        work = resample_poly_np(audio, msr, sr) if sr != msr else audio
        window = self.window
        if len(work) <= window:
            st = self.model.stride
            ladder = BucketLadder(tuple(b for b in (st * 100, st * 200, st * 400, window)
                                        if b <= window))
            window = ladder.bucket(max(len(work), self.model.win))
        hop = self.hop if window == self.window else window
        with torch.inference_mode():
            chunks, n = chunk_signal(torch.from_numpy(work).to(self.device), window, hop)
            out = merge_chunks(self.forward(chunks), n, hop, window_fn="tri").cpu().numpy()
        if sr != msr:
            out = resample_poly_np(out, sr, msr)
        if len(out) >= t_orig:
            return out[:t_orig]
        return np.pad(out, (0, t_orig - len(out)))
