"""Speech enhancement by conditional flow matching, and its engine.

Counterpart of targetdiarization_tpu/models/enhancement.py. `FlowEnhancer`
predicts the flow velocity v(x_t, t | cond) over log-magnitude STFT
frames (n_fft 512, hop 128), conditioned on the degraded spectrogram: a
5x5 conv, FiLM-modulated conv blocks at three resolutions (stride-2 4x4
convs down, flax's "SAME" transposed convs up, skips cropped and added)
and a 3x3 output conv. It is NCHW over (B, C, T', F): the JAX model's
NHWC (B, T', F, C) with the channels moved. The GroupNorms take their
statistics over each of 8 contiguous channel groups in float32, in flax's
one-pass form (E[x^2] - E[x]^2).

`EnhancerEngine` integrates the flow from prior noise with the midpoint
rule over `nfe` steps (`_program`, one host loop of 2 nfe forwards),
blends the result toward the input's log magnitude by `lambd` and
resynthesizes with the input's phase. The JAX engine has no compute type:
the model computes in float32 (`exact_float32` on the card). The noise of
each 10 s piece is one draw of a `torch.Generator` seeded by `enhance`'s
`seed`, made on the host, so every device sees the same noise; it is not
the JAX package's noise (`jax.random` bits cannot be reproduced), so the
packages agree exactly only at `tau=0`, or where `_program` is handed the
same noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2dSame, ConvTranspose2d, Dense
from ..ops.stft import istft, stft
from ..runtime.precision import exact_float32

N_FFT = 512
HOP = 128
# the flow prior's std: training draws x0 ~ N(0, PRIOR_STD^2), and sampling
# starts from the same temperature (the reference's tau)
PRIOR_STD = 0.5
GN_EPS = 1e-6  # flax nn.GroupNorm's default


def _stft_mag_phase(wav: torch.Tensor):
    """wav (B, T) -> (log-magnitude (B, T', F), complex spectrum (B, T', F))."""
    spec = stft(wav, N_FFT, HOP).transpose(-1, -2)
    return torch.log1p(spec.abs()), spec


def _istft_from_mag(logmag: torch.Tensor, ref_spec: torch.Tensor, n_samples: int):
    """Log magnitude with the phase of ref_spec (B, T', F) -> (B, n_samples)."""
    mag = torch.expm1(torch.relu(logmag))
    phase = ref_spec / torch.clamp_min(ref_spec.abs(), 1e-8)
    out = istft((mag * phase).transpose(-1, -2), N_FFT, HOP)
    return out[..., :n_samples]


class GroupNorm(nn.Module):
    """flax GroupNorm of NCHW maps: each item's `groups` contiguous channel
    groups normalized over (C / groups, H, W) in float32, with flax's
    one-pass variance max(E[x^2] - E[x]^2, 0); the output in x's type."""

    def __init__(self, channels: int, groups: int = 8, eps: float = GN_EPS):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.groups, -1)
        mean = xg.mean(dim=-1)
        var = torch.clamp_min(xg.square().mean(dim=-1) - mean.square(), 0.0)
        per = c // self.groups
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per, dim=1) * self.weight.float()
        y = (x.float() - mean.repeat_interleave(per, dim=1)[..., None, None]) * mul[..., None, None]
        return (y + self.bias.float()[:, None, None]).to(x.dtype)


class FiLMBlock(nn.Module):
    """GroupNorm, FiLM by the time embedding, SiLU, a kxk conv, residual."""

    def __init__(self, ch: int, kernel: int = 5, temb_dim: int = 128):
        super().__init__()
        self.gn = GroupNorm(ch)
        self.film_s = Dense(temb_dim, ch)
        self.film_b = Dense(temb_dim, ch)
        self.conv = Conv2dSame(ch, ch, kernel)

    def forward(self, x, temb):  # x (B, C, T', F), temb (B, 128)
        scale = self.film_s(temb)[:, :, None, None]
        shift = self.film_b(temb)[:, :, None, None]
        h = F.silu(self.gn(x) * (1.0 + scale) + shift)
        return x + self.conv(h)


class FlowEnhancer(nn.Module):
    """Velocity field over log-magnitude spectrograms: x_t, t, cond ->
    v, with x_t, cond and v (B, T', F) and t (B,)."""

    def __init__(self, ch: int = 48, sample_rate: int = 16000):
        super().__init__()
        self.ch, self.sample_rate = ch, sample_rate
        self.temb1 = Dense(64, 128)
        self.temb2 = Dense(128, 128)
        self.in_conv = Conv2dSame(2, ch, 5)
        self.b0 = FiLMBlock(ch)
        self.down1 = Conv2dSame(ch, ch * 2, 4, stride=2)
        self.b1 = FiLMBlock(ch * 2)
        self.down2 = Conv2dSame(ch * 2, ch * 4, 4, stride=2)
        self.b2 = FiLMBlock(ch * 4)
        self.b3 = FiLMBlock(ch * 4)
        self.up1 = ConvTranspose2d(ch * 4, ch * 2, 4, stride=2)
        self.b4 = FiLMBlock(ch * 2)
        self.up2 = ConvTranspose2d(ch * 2, ch, 4, stride=2)
        self.b5 = FiLMBlock(ch)
        self.out_gn = GroupNorm(ch)
        self.out_conv = Conv2dSame(ch, 1, 3)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """(B,) -> (B, 128): 32 sinusoid frequencies of t * 1000, [sin | cos],
        through Dense, SiLU, Dense (float32 tables, as the JAX model's)."""
        half = 32
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                            dtype=torch.float32) / half)
        ang = t.float()[:, None] * freqs[None, :] * 1000.0
        temb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.temb2(F.silu(self.temb1(temb)))

    def forward(self, x_t, t, cond):
        temb = self.time_embedding(t)
        h = self.b0(self.in_conv(torch.stack([x_t, cond], dim=1)), temb)
        skip0 = h
        h = self.b1(self.down1(h), temb)
        skip1 = h
        h = self.b3(self.b2(self.down2(h), temb), temb)
        h = self.up1(h)[..., : skip1.shape[2], : skip1.shape[3]] + skip1
        h = self.b4(h, temb)
        h = self.up2(h)[..., : skip0.shape[2], : skip0.shape[3]] + skip0
        h = self.b5(h, temb)
        return self.out_conv(F.silu(self.out_gn(h)))[:, 0]


class EnhancerEngine:
    """Midpoint-rule sampler over the flow field with the reference
    enhancer's knobs: nfe (solver steps), lambd (blend toward the enhanced
    magnitude) and tau (prior temperature). Audio is cut in pieces of the
    smallest of BUCKETS (1, 2, 4 or 10 s) that holds it, or 10 s pieces."""

    BUCKETS = (16000, 32000, 64000, 160000)

    def __init__(self, model: FlowEnhancer, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=torch.float32).eval()

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda") -> "EnhancerEngine":
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device)

    def _program(self, wav, noise, nfe: int, lambd: float, tau: float) -> np.ndarray:
        """One padded piece through the solver: wav (B, n) and noise
        (B, n // HOP + 1, N_FFT // 2 + 1) float32 -> enhanced (B, n). Each
        of the `nfe` steps takes two forwards: v(x, t) and v at the
        midpoint x + dt/2 v, t + dt/2."""
        with torch.inference_mode(), exact_float32():
            wav, noise = (a.float() if isinstance(a, torch.Tensor)
                          else torch.from_numpy(np.array(a, np.float32)) for a in (wav, noise))
            wav, noise = wav.to(self.device), noise.to(self.device)
            cond, spec = _stft_mag_phase(wav)
            x = noise * torch.tensor(tau, dtype=torch.float32, device=self.device)
            dt = 1.0 / nfe
            dt32 = torch.tensor(dt, dtype=torch.float32, device=self.device)
            for i in range(nfe):
                # t = i * dt in float32, as the JAX loop forms it
                tv = torch.full((x.shape[0],), float(i), device=self.device) * dt32
                v1 = self.model(x, tv, cond)
                xm = x + 0.5 * dt * v1
                v2 = self.model(xm, tv + 0.5 * dt, cond)
                x = x + dt * v2
            lam = torch.tensor(lambd, dtype=torch.float32, device=self.device)
            out_mag = lam * x + (1.0 - lam) * cond
            return _istft_from_mag(out_mag, spec, wav.shape[-1]).cpu().numpy()

    def enhance(self, audio: np.ndarray, sr: int = 16000, nfe: int = 64, lambd: float = 0.9,
                tau: float = 0.5, seed: int = 0) -> np.ndarray:
        """Enhanced mono audio at `sr`, the input's length. Each piece gets
        its own draw of prior noise from one generator seeded by `seed`."""
        from ..ops.resample import resample_poly_np

        audio = np.asarray(audio, np.float32)
        t_orig = len(audio)
        msr = self.model.sample_rate
        work = resample_poly_np(audio, msr, sr) if sr != msr else audio
        n = len(work)
        if n == 0:
            return audio
        bucket = next((b for b in self.BUCKETS if b >= n), self.BUCKETS[-1])
        gen = torch.Generator().manual_seed(int(seed))
        outs = []
        for start in range(0, n, bucket):
            chunk = work[start: start + bucket]
            buf = np.pad(chunk, (0, bucket - len(chunk)))[None]
            noise = torch.randn((1, bucket // HOP + 1, N_FFT // 2 + 1), generator=gen)
            y = self._program(buf, noise, int(nfe), lambd, tau)[0]
            outs.append(y[: len(chunk)])
        out = np.concatenate(outs)[:n]
        if sr != msr:
            out = resample_poly_np(out, sr, msr)
        if len(out) >= t_orig:
            return out[:t_orig].astype(np.float32)
        return np.pad(out, (0, t_orig - len(out))).astype(np.float32)
