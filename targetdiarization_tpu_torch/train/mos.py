"""DNSMOS / SigMOS: the MOS estimators' networks and scoring harnesses.

Counterpart of targetdiarization_tpu/train/mos.py. The reference scores
audio with two ONNX estimators (DNSMOS P.835: a 120-mel spectrogram over
9.01 s hops with polynomial calibration; SigMOS P.804: a compressed-
magnitude STFT at 48 kHz). Here, as in the JAX package:
- the harnesses' semantics: the 9.01 s hop loop, the mel frontend
  `(power_to_db(ref=max) + 40) / 40`, the published calibration
  polynomials, SigMOS's sqrt-Hann 960/480 STFT with 0.3-compressed
  magnitude and compressed real and imaginary parts. Both frontends are
  host numpy (`audio_melspec`, `sigmos_frontend`);
- two CNN estimators over those frontends, `DNSMOSNet` and `SigMOSNet`,
  whose weights come from `train/recipes.py::bootstrap_mos` and
  `bootstrap_sigmos` (the shipped `checkpoints/mos-bootstrap`, with its
  P.808 head under `p808/`, and `checkpoints/sigmos-bootstrap`). Their
  convolutions are flax "SAME" convolutions (pads 1 for 3 x 3, (1, 2) for
  3 x 5) and their max pools are VALID (the last partial window dropped).

`MOSEstimator` and `SigMOSEstimator` fit `train/metrics.py::MetricsTracker`'s
`mos_estimator` and `sigmos_estimator`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01  # seconds, the reference harness's segment

# P.835 polynomial calibration (the reference harness's get_polyfit_val)
_P_OVR = np.array([-0.06766283, 1.11546468, 0.04602535])
_P_SIG = np.array([-0.08397278, 1.22083953, 0.0052439])
_P_BAK = np.array([-0.13166888, 1.60915514, -0.39604546])
_PP_OVR = np.array([-0.00533021, 0.005101, 1.18058466, -0.11236046])
_PP_SIG = np.array([-0.01019296, 0.02751166, 1.19576786, -0.24348726])
_PP_BAK = np.array([-0.04976499, 0.44276479, -0.1644611, 0.96883132])


def audio_melspec(audio: np.ndarray, n_mels: int = 120, frame_size: int = 320,
                  hop: int = 160, sr: int = SAMPLING_RATE) -> np.ndarray:
    """The DNSMOS mel frontend: power mel with n_fft = frame_size + 1
    (periodic Hann, centre reflect pad), dB re max floored at -80,
    (x + 40) / 40, frames first: (T, n_mels) float32."""
    from ..ops.mel import mel_filterbank

    n_fft = frame_size + 1
    x = np.asarray(audio, np.float32)
    x = np.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    spec = np.abs(np.fft.rfft(x[idx] * window, n=n_fft, axis=-1)).T
    power = spec ** 2  # (F, T)
    fb = np.asarray(mel_filterbank(sr, frame_size + 1, n_mels))  # (n_mels, F)
    m = fb @ power
    db = 10.0 * np.log10(np.maximum(m, 1e-10))
    db = np.maximum(db - db.max(), -80.0)  # power_to_db(ref=np.max)
    return ((db + 40.0) / 40.0).T.astype(np.float32)  # (T, n_mels)


def sigmos_frontend(audio: np.ndarray, sr: int) -> np.ndarray:
    """SigMOS's input: resampled to 48 kHz, sqrt-Hann 960/480 STFT, then
    three channels, the 0.3-power compressed magnitude and the compressed
    real and imaginary parts |X|^(c - 1) X: (3, T, 481) float32."""
    from ..ops.resample import resample_poly_np

    x = np.asarray(audio, np.float32)
    if sr != 48000:
        x = resample_poly_np(x, 48000, sr)
    dft, frame = 960, 480
    win = np.sqrt(np.hanning(dft + 1)[:-1]).astype(np.float32)
    last = len(x) % frame or frame
    x = np.pad(x, (dft - frame, dft - last))
    n_frames = 1 + (len(x) - dft) // frame
    idx = np.arange(dft)[None, :] + frame * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(x[idx] * win, n=dft, axis=-1)  # (T, 481)
    c = 0.3
    x2 = np.maximum(spec.real ** 2 + spec.imag ** 2, 1e-12)
    mag = x2 ** (c / 2)
    scale = x2 ** ((c - 1) / 2)
    return np.stack([mag, scale * spec.real, scale * spec.imag]).astype(np.float32)


class DNSMOSNet(nn.Module):
    """CNN MOS estimator over the 120-mel frontend: four 3 x 3 conv - ReLU -
    2 x 2 max pool stages, a global mean, two ReLU dense layers and the head.
    `n_out=3` is the SIG/BAK/OVRL head, `n_out=1` the P.808 head."""

    def __init__(self, n_out: int = 3, ch: int = 32):
        super().__init__()
        chans = (1, ch, ch, ch * 2, ch * 2)
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 3, padding=1))
        self.fc1 = nn.Linear(ch * 2, 128)
        self.fc2 = nn.Linear(128, 64)
        self.head = nn.Linear(64, n_out)

    def forward(self, mel):
        """mel (B, T, 120) -> (B, n_out)."""
        h = mel[:, None]
        for i in range(4):
            h = F.max_pool2d(torch.relu(getattr(self, f"conv{i}")(h)), 2, 2)
        h = h.mean(dim=(2, 3))
        h = torch.relu(self.fc2(torch.relu(self.fc1(h))))
        return self.head(h)


class SigMOSNet(nn.Module):
    """CNN estimator over SigMOS's 3-channel features: three 3 x 5 conv -
    ReLU - (2, 4) max pool stages, the mean and the max over time and
    frequency, a ReLU dense layer and the head. The 7 outputs are the P.804
    dimensions in `SigMOSEstimator.KEYS` order."""

    def __init__(self, n_out: int = 7, ch: int = 32):
        super().__init__()
        chans = (3, ch, ch * 2, ch * 2)
        for i in range(3):
            self.add_module(f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], (3, 5), padding=(1, 2)))
        self.fc1 = nn.Linear(ch * 4, 128)
        self.head = nn.Linear(128, n_out)

    def forward(self, feat):
        """feat (B, 3, T, 481) -> (B, n_out)."""
        h = feat
        for i in range(3):
            h = F.max_pool2d(torch.relu(getattr(self, f"conv{i}")(h)), (2, 4), (2, 4))
        h = torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=-1)
        return self.head(torch.relu(self.fc1(h)))


def _placed(net: nn.Module, device) -> nn.Module:
    return net.to(device=torch.device(device), dtype=torch.float32).eval()


def _seeded(net: nn.Module, seed: int) -> nn.Module:
    """`net` with a seeded draw at flax's initializer scales."""
    from .trainer import init_params

    net.load_state_dict(init_params(net, seed), strict=True)
    return net


def _load(path: str, cls) -> nn.Module:
    from ..runtime.convert import CONVERTERS
    from ..runtime.params import load_checkpoint

    tree, meta = load_checkpoint(path)
    net = cls(**meta.get("model_args", {}))
    net.load_state_dict(CONVERTERS[cls.__name__](tree), strict=True)
    return net


class SigMOSEstimator:
    """The P.804 scorer: the reference SigMOS harness around a SigMOSNet
    (a seeded draw at flax's scales when none is given). `run` returns the
    reference's result keys."""

    KEYS = ("MOS_COL", "MOS_DISC", "MOS_LOUD", "MOS_NOISE", "MOS_REVERB", "MOS_SIG",
            "MOS_OVRL")

    def __init__(self, net: SigMOSNet | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.net = _placed(net if net is not None else _seeded(SigMOSNet(n_out=7), seed),
                           self.device)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda") -> "SigMOSEstimator":
        return cls(_load(path, SigMOSNet), device=device)

    def scores(self, feats: np.ndarray) -> np.ndarray:
        """The network's outputs (B, 7) for features (B, 3, T, 481)."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(feats, np.float32), device=self.device)
            return self.net(x).cpu().numpy()

    def run(self, audio: np.ndarray, sr: int | None = None) -> dict:
        feats = sigmos_frontend(np.asarray(audio, np.float32), sr if sr else 48000)
        return {k: float(v) for k, v in zip(self.KEYS, self.scores(feats[None])[0])}


class MOSEstimator:
    """The DNSMOS scorer: the reference's 9.01 s hop loop and polynomial
    calibration around two DNSMOSNets (SIG/BAK/OVRL and P.808; seeded draws
    at flax's scales, seeds `seed` and `seed + 1`, where none is given)."""

    def __init__(self, net: DNSMOSNet | None = None, net808: DNSMOSNet | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.net = _placed(net if net is not None else _seeded(DNSMOSNet(n_out=3), seed),
                           self.device)
        self.net808 = _placed(net808 if net808 is not None
                              else _seeded(DNSMOSNet(n_out=1), seed + 1), self.device)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda") -> "MOSEstimator":
        p808 = os.path.join(path, "p808")
        return cls(_load(path, DNSMOSNet),
                   _load(p808, DNSMOSNet) if os.path.exists(p808) else None, device=device)

    def __call__(self, audio: np.ndarray, sampling_rate: int = SAMPLING_RATE,
                 is_personalized_MOS: bool = False) -> dict:
        from ..ops.resample import resample_poly_np

        fs = SAMPLING_RATE
        audio = np.asarray(audio, np.float32)
        if sampling_rate != fs:
            audio = resample_poly_np(audio, fs, sampling_rate)
        actual_len = len(audio)
        len_samples = int(INPUT_LENGTH * fs)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / fs) - INPUT_LENGTH) + 1
        raw_sig, raw_bak, raw_ovr, p808s = [], [], [], []
        for idx in range(num_hops):
            seg = audio[int(idx * fs): int((idx + INPUT_LENGTH) * fs)]
            if len(seg) < len_samples:
                continue
            mel = torch.as_tensor(audio_melspec(seg[:-160])[None], device=self.device)
            with torch.no_grad():
                s, b, o = self.net(mel)[0].cpu().numpy()
                p808s.append(float(self.net808(mel)[0, 0]))
            raw_sig.append(float(s))
            raw_bak.append(float(b))
            raw_ovr.append(float(o))
        if is_personalized_MOS:
            ps, pb, po = _PP_SIG, _PP_BAK, _PP_OVR
        else:
            ps, pb, po = _P_SIG, _P_BAK, _P_OVR
        sig = [float(np.polyval(ps, v)) for v in raw_sig]
        bak = [float(np.polyval(pb, v)) for v in raw_bak]
        ovr = [float(np.polyval(po, v)) for v in raw_ovr]
        return {
            "len_in_sec": actual_len / fs, "sr": fs, "num_hops": num_hops,
            "OVRL_raw": float(np.mean(raw_ovr)),
            "SIG_raw": float(np.mean(raw_sig)),
            "BAK_raw": float(np.mean(raw_bak)),
            "OVRL": float(np.mean(ovr)),
            "SIG": float(np.mean(sig)),
            "BAK": float(np.mean(bak)),
            "P808_MOS": float(np.mean(p808s)),
        }
