"""MDX vocal denoising: a TDF U-Net on packed stereo STFTs, and the
spectral gate.

Counterpart of targetdiarization_tpu/models/denoise.py. The MDX packing
takes stereo 44.1 kHz chunks of hop·255 samples to an STFT of n_fft 6144
(hop 1024 at quality 2), (real, imag) × (L, R) as 4 channels cropped to
3072 bins and 256 frames. `TDFUNet` is NCHW over (B, 4, F, T): the JAX
model's NHWC (B, F, T, 4) with the channels moved, so its (F, T) stay the
image's (H, W). The network predicts the instrumental; vocals are the mix
less the prediction. In a reduced compute type the whole U-Net computes in
it, as the JAX model does.

`DenoiseEngine.denoise_vocal` chunks on the host (15 s chunks with 1 s
margins at 44.1 kHz); `denoise_chain_16k` is the same chain on one
device buffer of 16 kHz audio, for the fused front end.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2dSame, ConvTranspose2d, Dense, gelu
from ..ops.kernels import prepare_kernels
from ..ops.resample import resample, resample_poly_np
from ..ops.stft import frame_signal, istft, stft
from ..runtime.precision import exact_float32, resolve_compute_dtype

MDX_SR = 44100
N_FFT = 6144
DIM_F = 3072
DIM_T = 256
GN_EPS = 1e-6  # flax nn.GroupNorm's default
# the MDX hop that AudioProcessor's `quality` preset selects
QUALITY_HOP = {1: 256, 2: 1024, 3: 2048}


def mdx_chunk_size(hop: int) -> int:
    return hop * (DIM_T - 1)


def mdx_stft(x: torch.Tensor, hop: int = 1024) -> torch.Tensor:
    """(B, 2, chunk) stereo waves -> (B, 4, DIM_F, DIM_T) packed spectra."""
    b = x.shape[0]
    spec = stft(x.reshape(b * 2, -1), N_FFT, hop)[..., :DIM_T]  # (2B, bins, T)
    packed = torch.stack([spec.real, spec.imag], dim=1)  # (2B, 2, bins, T)
    return packed.reshape(b, 4, N_FFT // 2 + 1, -1)[:, :, :DIM_F]


def mdx_istft(packed: torch.Tensor, hop: int = 1024) -> torch.Tensor:
    """(B, 4, DIM_F, DIM_T) float32 -> (B, 2, chunk) stereo waves."""
    b = packed.shape[0]
    n_bins = N_FFT // 2 + 1
    full = F.pad(packed, (0, 0, 0, n_bins - DIM_F)).reshape(b * 2, 2, n_bins, -1)
    wav = istft(torch.complex(full[:, 0], full[:, 1]), N_FFT, hop, length=mdx_chunk_size(hop))
    return wav.reshape(b, 2, -1)


class GroupNorm1(nn.Module):
    """flax GroupNorm(num_groups=1) of NCHW maps: one mean and variance an
    item, over (C, H, W), in float32; the output in x's type. (torch's
    GroupNorm reduces each item's row in one thread block: six blocks for a
    30 s rung, 83 ms of a 118 ms `FusedFrontend.analyze` of 46 s on an
    NVIDIA H100.)"""

    def __init__(self, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        var, mean = torch.var_mean(x.float().reshape(x.shape[0], -1), dim=1, correction=0)
        mul = torch.rsqrt(var + self.eps)[:, None] * self.weight.float()  # (B, C)
        shift = self.bias.float() - mean[:, None] * mul
        return torch.addcmul(shift[..., None, None], x, mul[..., None, None]).to(x.dtype)


class TFCTDF(nn.Module):
    """Two GroupNorm -> GELU -> 3x3 conv steps, then the TDF: a bottleneck
    of two dense layers across frequency, added to the convs' output."""

    def __init__(self, channels: int, freq: int, bn_factor: int = 16):
        super().__init__()
        self.channels = channels
        hidden = max(freq // bn_factor, 4)
        self.gn0 = GroupNorm1(channels)
        self.conv0 = Conv2dSame(channels, channels, 3)
        self.gn1 = GroupNorm1(channels)
        self.conv1 = Conv2dSame(channels, channels, 3)
        self.tdf_gn = GroupNorm1(channels)
        self.tdf_down = Dense(freq, hidden)
        self.tdf_up = Dense(hidden, freq)

    def forward(self, x):  # (B, C, F, T)
        h = self.conv0(gelu(self.gn0(x)))
        h = self.conv1(gelu(self.gn1(h)))
        t = gelu(self.tdf_gn(h)).transpose(2, 3)  # (B, C, T, F)
        t = self.tdf_up(gelu(self.tdf_down(t))).transpose(2, 3)
        return h + t + (x if x.shape[1] == self.channels else 0)


class TDFUNet(nn.Module):
    """U-Net over packed MDX spectra, stride-2 down and up in (F, T)."""

    def __init__(self, channels: int = 32, depth: int = 4, growth: int = 16,
                 freq: int = DIM_F, in_channels: int = 4):
        super().__init__()
        self.in_conv = Conv2dSame(in_channels, channels, 1)
        self.enc, self.down, self.up, self.dec = (nn.ModuleList() for _ in range(4))
        c, f = channels, freq
        for _ in range(depth):
            self.enc.append(TFCTDF(c, f))
            self.down.append(Conv2dSame(c, c + growth, 2, stride=2))
            c, f = c + growth, f // 2
        self.bottleneck = TFCTDF(c, f)
        for _ in range(depth):
            self.up.insert(0, ConvTranspose2d(c, c - growth, 2, stride=2))
            c, f = c - growth, f * 2
            self.dec.insert(0, TFCTDF(c, f))
        self.out_conv = Conv2dSame(channels, in_channels, 1)

    def forward(self, x):  # (B, 4, F, T)
        h = self.in_conv(x)
        skips = []
        for enc, down in zip(self.enc, self.down):
            h = enc(h)
            skips.append(h)
            h = down(h)
        h = self.bottleneck(h)
        for i in reversed(range(len(self.up))):
            h = self.dec[i](self.up[i](h) + skips[i])
        return self.out_conv(h)


def spectral_gate(audio: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                  n_std: float = 1.5) -> torch.Tensor:
    """Stationary spectral gate of (T,) audio: a soft mask on each bin's
    log magnitude around its mean + n_std·std over the clip (population
    std), smoothed over 3 frames, then resynthesis."""
    n = audio.shape[-1]
    spec = stft(audio.float(), n_fft, hop)
    log_mag = torch.log(spec.abs() + 1e-8)
    mean = log_mag.mean(dim=-1, keepdim=True)
    std = log_mag.std(dim=-1, keepdim=True, correction=0)
    mask = torch.sigmoid((log_mag - (mean + n_std * std)) / 0.5)
    edge = F.pad(mask, (1, 1), mode="replicate")
    mask = (edge[..., :-2] + mask + edge[..., 2:]) / 3.0
    return istft(spec * mask, n_fft, hop, length=n)


def denoise_chain_16k(eng: "DenoiseEngine", audio: torch.Tensor, bucket: int) -> torch.Tensor:
    """`denoise_vocal` on one (bucket,) 16 kHz device buffer: resample to
    44.1 kHz, duplicate to stereo, cut MDX chunks, the U-Net, iSTFT, trim
    the margins, subtract (inst model), downmix, resample to 16 kHz."""
    hop = eng.hop
    n44 = -(-bucket * 441 // 160)
    x44 = resample(audio, MDX_SR, 16000)
    stereo = torch.stack([x44, x44])  # (2, n44)
    trim = N_FFT // 2
    cs = mdx_chunk_size(hop)
    gen = cs - 2 * trim
    n_chunks = -(-n44 // gen)
    padded = F.pad(stereo, (trim, n_chunks * gen - n44 + trim))
    waves = frame_signal(padded, cs, gen).transpose(0, 1)  # (W, 2, cs)
    pred = eng.forward_spec(mdx_stft(waves, hop))
    inner = mdx_istft(pred, hop)[:, :, trim:-trim]  # (W, 2, gen)
    out44 = inner.transpose(0, 1).reshape(2, -1)[:, :n44]
    vocals = torch.clamp(stereo - out44 if eng.is_inst_model else out44, -1.0, 1.0)
    return resample(vocals.mean(dim=0), 16000, MDX_SR)[:bucket]


class DenoiseEngine:
    """MDX vocal isolation with the reference's chunking."""

    def __init__(self, model: TDFUNet, hop: int = 1024, is_inst_model: bool = True,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()
        prepare_kernels(self.model)
        self.hop = hop
        self.is_inst_model = is_inst_model  # vocals = mix - prediction

    @classmethod
    def from_pretrained(cls, path: str, hop: int = 1024, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "DenoiseEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), hop=hop, device=device, compute_dtype=compute_dtype)

    def forward_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """Packed spectra (B, 4, DIM_F, DIM_T) -> the prediction, float32."""
        with torch.inference_mode(), exact_float32():
            return self.model(spec.to(self.compute_dtype)).float()

    def _process_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """(T, 2) stereo at 44.1 kHz -> denoised (T, 2)."""
        mix = chunk.T
        n_sample = mix.shape[1]
        trim = N_FFT // 2
        chunk_size = mdx_chunk_size(self.hop)
        gen_size = chunk_size - 2 * trim
        pad = (gen_size - (n_sample % gen_size)) % gen_size
        padded = np.concatenate([np.zeros((2, trim), np.float32), mix,
                                 np.zeros((2, pad + trim), np.float32)], axis=1)
        waves = [padded[:, c: c + chunk_size] for c in range(0, n_sample + pad, gen_size)]
        with torch.inference_mode():
            batch = torch.from_numpy(np.stack(waves)).to(self.device)
            pred = self.forward_spec(mdx_stft(batch, self.hop))
            wav = mdx_istft(pred, self.hop).cpu().numpy()
        out = wav[:, :, trim:-trim].transpose(1, 0, 2).reshape(2, -1)[:, :n_sample].T
        return np.clip(chunk - out if self.is_inst_model else out, -1.0, 1.0)

    def denoise_vocal(self, audio: np.ndarray, sr: int = 16000,
                      fast_mode: bool = False) -> np.ndarray:
        """Vocals of mono (T,) or stereo (T, 2) audio at `sr`, same shape;
        `fast_mode` runs the spectral gate instead."""
        audio = np.asarray(audio, np.float32)
        if audio.size == 0:
            return audio
        if fast_mode:
            with torch.inference_mode():
                x = torch.from_numpy(audio).to(self.device)
                return spectral_gate(x).cpu().numpy()
        work = resample_poly_np(audio, MDX_SR, sr) if sr != MDX_SR else audio
        is_mono = work.ndim == 1
        stereo = np.stack([work, work], axis=1) if is_mono else work
        chunk, margin = int(15.0 * MDX_SR), int(1.0 * MDX_SR)
        total = stereo.shape[0]
        if total <= chunk:
            out = self._process_chunk(stereo)
        else:
            pieces = []
            for i, cursor in enumerate(range(0, total, chunk)):
                start = max(0, cursor - (0 if i == 0 else margin))
                last = cursor + chunk >= total
                end = total if last else min(cursor + chunk + margin, total)
                seg = self._process_chunk(stereo[start:end])
                s_trim = 0 if i == 0 else min(margin, len(seg) // 2)
                e_trim = None if last else -min(margin, len(seg) // 2)
                pieces.append(seg[s_trim:e_trim])
            out = np.concatenate(pieces, axis=0)
        mono = out.mean(axis=1) if is_mono else out
        if sr != MDX_SR:
            mono = resample_poly_np(mono.T if mono.ndim == 2 else mono, sr, MDX_SR)
            mono = mono.T if mono.ndim == 2 else mono
        n = len(audio)
        if len(mono) >= n:
            return mono[:n]
        return np.pad(mono, [(0, n - len(mono))] + [(0, 0)] * (mono.ndim - 1))
