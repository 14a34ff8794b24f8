"""The offline pipeline's front end in one device pass per request.

Counterpart of `FusedFrontend` in targetdiarization_tpu/pipeline/fused.py.
"Fused" means one call per request: the audio goes up once as int16, the
engines' modules run one after the other on device tensors, and the
results come down once.

`FusedFrontend.analyze`: int16 upload -> float32 -> BS.1770 loudness
normalization over the valid samples -> MDX denoise (the whole
`denoise_vocal` chain, with the 16k <-> 44.1k resample) or, with no
denoiser, the spectral gate -> loudness again -> int16 re-quantization
(round half to even, so the returned track is exactly the samples that
were analysed) -> one fbank -> FSMN-VAD speech probabilities,
SegmentationNet activations, and ERes2NetV2 embeddings of 1.5 s windows
every 0.75 s (fbank less each window's mean). Audio is padded to a rung
of `_LADDER` (1 .. 30 s); longer audio is analysed in 30 s parts whose
outputs are concatenated.

`FusedFrontend.enroll`: the same preprocessing -> VAD at 0.5 -> the
features from the first to the last speech frame (rolled to the front,
at most 2998 frames) -> one embedding with the mean over those frames
removed.

The sharded analyze over a mesh of chips and `StreamChunkAnalyzer` are
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import features
from ..models.denoise import denoise_chain_16k, spectral_gate
from ..ops.loudness import k_weight, lufs
from ..ops.stft import frame_signal
from ..runtime.buckets import BucketLadder, pad_to

# denser than the engines' ladders: the U-Net runs over the whole rung
_LADDER = BucketLadder(tuple(int(s * 16000) for s in (1, 2, 4, 8, 10, 16, 22, 30)))

_WIN_S = 1.5  # sliding embedding window
_HOP_S = 0.75
_WIN_F = int(_WIN_S * 100)  # fbank frames per window
_HOP_F = int(_HOP_S * 100)
_MAX_EMBED_FRAMES = 2998  # about 30 s: the reference truncates the SV input


def _masked_loudness_normalize(audio: torch.Tensor, sr: int, n_valid: int,
                               target_lufs: float = -23.0) -> torch.Tensor:
    """BS.1770 normalization of the first `n_valid` samples of a padded
    (T,) buffer: gating blocks that reach past n_valid are left out. With
    no block through the gates the level is kept; the gain never lifts the
    peak above full scale (the graph goes through int16 after)."""
    t_g = int(0.4 * sr)
    hop = t_g // 4
    blocks = frame_signal(k_weight(audio, sr), t_g, hop)  # (n_blocks, t_g)
    ends = torch.arange(blocks.shape[0], device=audio.device) * hop + t_g
    z_blocks = blocks.square().mean(dim=-1)
    l_blocks = lufs(z_blocks)
    abs_mask = (l_blocks > -70.0) & (ends <= n_valid)
    z_abs = (z_blocks * abs_mask).sum() / torch.clamp_min(abs_mask.sum(), 1.0)
    rel_mask = abs_mask & (l_blocks > lufs(z_abs) - 10.0)
    z_rel = (z_blocks * rel_mask).sum() / torch.clamp_min(rel_mask.sum(), 1.0)
    gain = torch.pow(10.0, (target_lufs - lufs(z_rel)) / 20.0)
    gain = torch.where(rel_mask.sum() > 0, gain, torch.ones_like(gain))
    gain = torch.minimum(gain, 1.0 / (audio.abs().max() + 1e-9))
    return audio * gain


class FusedFrontend:
    """`analyze` and `enroll` over live engines: the VAD and speaker
    engines are required, the denoiser (else the spectral gate) and the
    segmentation engine are optional. Runs on the VAD engine's device."""

    def __init__(self, denoiser=None, vad=None, seg=None, spk=None):
        if vad is None or spk is None:
            raise ValueError("FusedFrontend needs VAD and speaker engines")
        self.denoiser, self.vad, self.seg, self.spk = denoiser, vad, seg, spk
        self.device = vad.device

    # ---------------- device pieces ----------------

    def _denoise(self, audio: torch.Tensor, bucket: int) -> torch.Tensor:
        if self.denoiser is None:
            return spectral_gate(audio)
        return denoise_chain_16k(self.denoiser, audio, bucket)

    def _preprocess(self, audio_i16: torch.Tensor, n_valid: int, bucket: int):
        """-> (float32 audio, int16 audio): the same samples."""
        valid = (torch.arange(bucket, device=self.device) < n_valid).float()
        audio = audio_i16.float() / 32768.0 * valid
        audio = _masked_loudness_normalize(audio, 16000, n_valid)
        audio = self._denoise(audio, bucket) * valid
        audio = _masked_loudness_normalize(audio, 16000, n_valid)
        out_i16 = torch.clamp(torch.round(audio * 32768.0), -32768, 32767).to(torch.int16)
        return out_i16.float() / 32768.0, out_i16

    def _vad_probs(self, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(1, T, 80) -> (T,) speech probabilities, the softmax in the
        VAD's type."""
        logits = self.vad.model(feats.to(self.vad.compute_dtype), lengths)
        return torch.softmax(logits, dim=-1)[0, :, 1].float()

    def _upload(self, audio: np.ndarray, bucket: int) -> torch.Tensor:
        # truncation to int16, as the JAX package's analyze and enroll do
        a_i16 = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        return torch.from_numpy(pad_to(a_i16, bucket)).to(self.device)

    # ---------------- analyze ----------------

    def _analyze_device(self, audio_i16: torch.Tensor, n_valid: int, bucket: int) -> dict:
        audio, out_i16 = self._preprocess(audio_i16, n_valid, bucket)
        feats = features.fbank(audio[None])  # (1, T, 80)
        return {"audio_i16": out_i16, **self._heads(feats, n_valid, bucket)}

    def _heads(self, feats: torch.Tensor, n_valid: int, bucket: int) -> dict:
        """The models on the rung's fbank (1, T, 80): speech probabilities,
        activations, and the embeddings of every window of the rung."""
        lengths = torch.tensor([features.num_frames(n_valid)], device=self.device)
        out = {"vad_probs": self._vad_probs(feats, lengths)}
        if self.seg is not None:
            out["seg_act"] = self.seg.forward_feats(feats, lengths)[0]
        t_total = features.num_frames(bucket)
        if t_total >= _WIN_F:
            wins = frame_signal(feats[0].T, _WIN_F, _HOP_F).permute(1, 2, 0)  # (n_win, WIN_F, 80)
            wins = wins - wins.mean(dim=1, keepdim=True)
            full = torch.full((wins.shape[0],), _WIN_F, device=self.device)
            out["win_embs"] = self.spk.embed_feats(wins, full)
        return out

    def analyze(self, audio: np.ndarray, sr: int = 16000) -> dict:
        """{"audio": the denoised float32 track, "audio_dev_i16": the same
        samples as the device's int16 buffer (None above 30 s), "n_samples",
        "vad_probs": (T,), "seg_act": (T // 4, K) or None, "win_embs":
        (n_win, 192) or None, "win_times": [(s, e), ...]}."""
        audio = np.asarray(audio, np.float32).ravel()
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, 16000, sr)
        top = _LADDER.rungs[-1]
        if len(audio) > top:
            parts = [self.analyze(audio[i: i + top]) for i in range(0, len(audio), top)]
            out = {"audio": np.concatenate([p["audio"] for p in parts]), "audio_dev_i16": None,
                   "n_samples": len(audio),
                   "vad_probs": np.concatenate([p["vad_probs"] for p in parts])}
            if parts[0].get("seg_act") is not None:
                out["seg_act"] = np.concatenate([p["seg_act"] for p in parts], axis=0)
            embs, times = [], []
            for i, p in enumerate(parts):
                if p.get("win_embs") is not None:
                    off = i * top / 16000.0
                    embs.append(p["win_embs"])
                    times.extend([(s + off, e + off) for s, e in p["win_times"]])
            out["win_embs"] = np.concatenate(embs, axis=0) if embs else None
            out["win_times"] = times
            return out

        n = len(audio)
        bucket = _LADDER.bucket(max(n, 1))
        with torch.inference_mode():
            dev = self._analyze_device(self._upload(audio, bucket), n, bucket)
            host = {k: v.cpu().numpy() for k, v in dev.items()}
        t = features.num_frames(n)
        out = {"audio": host["audio_i16"][:n].astype(np.float32) / 32768.0,
               "audio_dev_i16": dev["audio_i16"], "n_samples": n,
               "vad_probs": host["vad_probs"][:t], "seg_act": None, "win_embs": None,
               "win_times": []}
        if "seg_act" in host:
            out["seg_act"] = host["seg_act"][: max(t // self.seg.model.downsample, 1)]
        if "win_embs" in host:  # the windows wholly inside the valid frames
            n_win = sum(1 for i in range(host["win_embs"].shape[0])
                        if i * _HOP_F + _WIN_F <= max(t, 0))
            out["win_embs"] = host["win_embs"][:n_win]
            out["win_times"] = [(i * _HOP_S, i * _HOP_S + _WIN_S) for i in range(n_win)]
        return out

    # ---------------- enroll ----------------

    def _enroll_device(self, audio_i16: torch.Tensor, n_valid: int, bucket: int) -> dict:
        audio, out_i16 = self._preprocess(audio_i16, n_valid, bucket)
        nf = features.num_frames(n_valid)
        feats = features.fbank(audio[None])[0]  # (T, 80)
        t = feats.shape[0]
        probs = self._vad_probs(feats[None], torch.tensor([nf], device=self.device))
        idx = torch.arange(t, device=self.device)
        speech = (probs > 0.5) & (idx < nf)
        # [first, last] speech frame, rolled to the front (no speech: first = t)
        first = torch.where(speech, idx, t).min()
        last = torch.where(speech, idx, -1).max()
        n_in = torch.clamp(last - first + 1, 0, _MAX_EMBED_FRAMES)
        rolled = feats[(idx + first) % t][None]  # (1, T, 80)
        pmask = (idx < n_in).float()[None, :, None]
        mean = (rolled * pmask).sum(dim=1, keepdim=True) / torch.clamp_min(
            pmask.sum(dim=1, keepdim=True), 1.0)
        emb = self.spk.embed_feats((rolled - mean) * pmask, n_in[None])[0]
        return {"emb": emb, "vad_probs": probs, "audio_i16": out_i16}

    def enroll(self, audio: np.ndarray, sr: int = 16000) -> dict:
        """{"emb": (192,), "vad_probs": (T,), "audio": the denoised float32
        track} of a target-enrollment clip (cut at 30 s)."""
        audio = np.asarray(audio, np.float32).ravel()
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, 16000, sr)
        audio = audio[:_LADDER.rungs[-1]]
        n = len(audio)
        bucket = _LADDER.bucket(max(n, 1))
        with torch.inference_mode():
            host = {k: v.cpu().numpy() for k, v in
                    self._enroll_device(self._upload(audio, bucket), n, bucket).items()}
        t = features.num_frames(n)
        return {"emb": host["emb"], "vad_probs": host["vad_probs"][:t],
                "audio": host["audio_i16"][:n].astype(np.float32) / 32768.0}
