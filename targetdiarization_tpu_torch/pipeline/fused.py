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

`FusedSeparation.separate_score`: the overlap clips as one int16 batch
-> MossFormer2 -> Apollo restoration of the streams when the restorer is
16 kHz-native -> on the streams before restoration: fbank, speech
probabilities, and embeddings with the mean over each stream's valid
frames removed -> the streams back as int16.

`FusedASR.transcribe_masked`: each speaker's track as interval masks of
`analyze`'s device int16 buffer -> fbank -> LFR -> CMVN -> Paraformer ->
argmax -> CT-Transformer punctuation classes of those ids, when the two
vocabularies are the same.

`StreamChunkAnalyzer.analyze_chunk`: the streaming flush decision's
speech probabilities and speaker-change cosine in one pass (below).

The sharded analyze over a mesh of chips is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import features
from ..models.denoise import denoise_chain_16k, spectral_gate
from ..ops.loudness import k_weight, lufs
from ..ops.stft import frame_signal
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import exact_float32, quantize_i16
from ..runtime.trace import trace

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
        with trace("fused/analyze"), torch.inference_mode():
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
        with trace("fused/enroll"), torch.inference_mode():
            host = {k: v.cpu().numpy() for k, v in
                    self._enroll_device(self._upload(audio, bucket), n, bucket).items()}
        t = features.num_frames(n)
        return {"emb": host["emb"], "vad_probs": host["vad_probs"][:t],
                "audio": host["audio_i16"][:n].astype(np.float32) / 32768.0}


def _n_frames(n_valid: torch.Tensor) -> torch.Tensor:
    """`features.num_frames` of a tensor of sample counts."""
    return torch.where(n_valid < 400, 0, 1 + torch.div(n_valid - 400, 160, rounding_mode="floor"))


class StreamChunkAnalyzer:
    """One device pass per streaming chunk decision. The flush cascade
    (`pipeline/streaming.py`) needs, per chunk, the VAD's speech
    probabilities of the whole buffer and of the last chunk, and the cosine
    between the embeddings of the buffer before the chunk and of the chunk
    (speaker change). One pass: int16 upload of both -> fbank of each ->
    VAD probabilities of each -> prefix-masked ERes2NetV2 embeddings of
    "buffer minus chunk" (the buffer's first n_comb - n_chunk samples' frames,
    less their mean) and of the chunk -> their cosine (0 where either is
    zero). The buffer pads to a rung of `_LADDER` (its last 30 s kept), the
    chunk to one of CHUNK_LADDER; concurrent sessions' decisions at the same
    rungs coalesce into one pass of ROW_LADDER rows (padded rows are zeros
    of length one, masked out of every row but their own)."""

    CHUNK_SAMPLES = 16000  # 1 s, the clients' chunk
    # a larger chunk takes a larger rung rather than being cut, so none of
    # its samples count as the buffer before it
    CHUNK_LADDER = BucketLadder((16000, 32000, 64000, 160000))
    ROW_LADDER = BucketLadder((1, 2, 4, 8))

    def __init__(self, vad, spk):
        from ..runtime import microbatch

        self.vad, self.spk = vad, spk
        self.device = vad.device
        self._mb = microbatch.MicroBatcher(self._run_batch) if microbatch.enabled() else None

    def _embed(self, feats: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
        m = (torch.arange(feats.shape[1], device=self.device)[None, :, None]
             < nf[:, None, None]).float()
        mean = (feats * m).sum(dim=1, keepdim=True) / torch.clamp_min(
            m.sum(dim=1, keepdim=True), 1.0)
        return self.spk.embed_feats((feats - mean) * m, nf)  # (nb, 192)

    def _vad_probs(self, feats: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
        logits = self.vad.model(feats.to(self.vad.compute_dtype), nf)
        return torch.softmax(logits, dim=-1)[..., 1].float()

    def _device(self, comb_i16, n_comb, chunk_i16, n_chunk) -> dict:
        return self._heads(features.fbank(comb_i16.float() / 32768.0), n_comb,
                           features.fbank(chunk_i16.float() / 32768.0), n_chunk)

    def _heads(self, feats_c, n_comb, feats_k, n_chunk) -> dict:
        """The pass after the fbanks: feats_c (nb, Tc, 80) of the buffers,
        feats_k (nb, Tk, 80) of the chunks, and their sample counts."""
        nf_chunk = _n_frames(n_chunk)
        emb_prev = self._embed(feats_c, _n_frames(torch.clamp_min(n_comb - n_chunk, 0)))
        emb_chunk = self._embed(feats_k, nf_chunk)
        n_prev, n_chk = emb_prev.norm(dim=-1), emb_chunk.norm(dim=-1)
        cos = torch.where((n_prev > 0) & (n_chk > 0),
                          (emb_prev * emb_chunk).sum(-1) / torch.clamp_min(n_prev * n_chk, 1e-9),
                          torch.zeros_like(n_prev))
        return {"probs_comb": self._vad_probs(feats_c, _n_frames(n_comb)),
                "probs_chunk": self._vad_probs(feats_k, nf_chunk), "similarity": cos}

    def _run_batch(self, key: tuple, items: list) -> list:
        """(buffer rung, chunk rung), [(buffer, chunk), ...] -> one result
        an item, from one pass of a ROW_LADDER rung of rows."""
        bucket, cs = key
        nb = self.ROW_LADDER.bucket(len(items))
        comb = np.zeros((nb, bucket), np.int16)
        chk = np.zeros((nb, cs), np.int16)
        n_comb = np.ones(nb, np.int64)
        n_chunk = np.ones(nb, np.int64)
        for i, (combined, chunk) in enumerate(items):
            comb[i, : len(combined)] = quantize_i16(combined)
            chk[i, : len(chunk)] = quantize_i16(chunk)
            n_comb[i], n_chunk[i] = len(combined), len(chunk)
        with trace("fused/stream_chunk"), torch.inference_mode(), exact_float32():
            dev = self._device(*(torch.from_numpy(a).to(self.device)
                                 for a in (comb, n_comb, chk, n_chunk)))
            host = {k: v.cpu().numpy() for k, v in dev.items()}
        return [{"probs_comb": host["probs_comb"][i, :features.num_frames(len(combined))],
                 "probs_chunk": host["probs_chunk"][i, :features.num_frames(len(chunk))],
                 "similarity": float(host["similarity"][i])}
                for i, (combined, chunk) in enumerate(items)]

    def analyze_chunk(self, combined: np.ndarray, chunk: np.ndarray) -> dict:
        """{"probs_comb", "probs_chunk", "similarity"} of a buffer and its
        last chunk, in one pass shared with the other sessions that call
        at the same moment."""
        chunk = np.asarray(chunk, np.float32)[-self.CHUNK_LADDER.rungs[-1]:]
        combined = np.asarray(combined, np.float32)[-_LADDER.rungs[-1]:]
        key = (_LADDER.bucket(max(len(combined), 1)),
               self.CHUNK_LADDER.bucket(max(len(chunk), 1)))
        if self._mb is not None:
            return self._mb.submit(key, (combined, chunk))
        return self._run_batch(key, [(combined, chunk)])[0]


class FusedSeparation:
    """Separation of the overlap clips and the scoring of both streams in
    one device pass: the clips pad to one rung of LADDER and the batch to
    one of N_LADDER; a clip above the top rung, an empty clip or more than
    four clips give None, and the caller takes the windowed path.

    Any two-speaker 16 kHz separator runs here padded to the rung, a zoo
    class that is not pad-safe too (the JAX package's fused program does
    not route by pad safety). A separator with another speaker count or
    rate (BSRNN: 4 stems at 44.1 kHz) gives None on every call: the JAX
    program fails on its output's shape and `infer` falls back to the
    windowed path there; the port takes that path by `takes_separator`."""

    LADDER = BucketLadder((32000, 64000, 96000, 160000))
    N_LADDER = BucketLadder((1, 2, 4))

    def __init__(self, sep, spk, vad=None, restorer=None):
        self.sep, self.spk, self.vad = sep, spk, vad
        # restoration in the same pass only when the restorer runs at 16 kHz
        self.restorer = restorer if (restorer is not None
                                     and getattr(restorer.model, "sr", 0) == 16000) else None
        self.device = sep.device
        self.takes_separator = sep.num_spks == 2 and sep.sample_rate == 16000

    def _device(self, clips_i16: torch.Tensor, lengths: torch.Tensor) -> dict:
        nb, bucket = clips_i16.shape
        wav = clips_i16.float() / 32768.0
        est = self.sep.model(wav.to(self.sep.compute_dtype), lengths).float()  # (nb, 2, bucket)
        streams = est.reshape(nb * 2, bucket)
        out_streams = streams
        if self.restorer is not None:
            out_streams = self.restorer.forward(
                streams.to(self.restorer.compute_dtype).float())
        # embeddings and speech probabilities of the streams before restoration
        nf = _n_frames(torch.repeat_interleave(lengths, 2))
        feats = features.fbank(streams)  # (2 nb, T, 80)
        m = (torch.arange(feats.shape[1], device=self.device)[None, :, None]
             < nf[:, None, None]).float()
        mean = (feats * m).sum(dim=1, keepdim=True) / torch.clamp_min(
            m.sum(dim=1, keepdim=True), 1.0)
        out = {"streams_i16": torch.clamp(torch.round(out_streams * 32768.0), -32768, 32767
                                          ).to(torch.int16).reshape(nb, 2, bucket),
               "embs": self.spk.embed_feats((feats - mean) * m, nf).reshape(nb, 2, -1)}
        if self.vad is not None:
            logits = self.vad.model(feats.to(self.vad.compute_dtype), nf)
            out["vad_probs"] = torch.softmax(logits, dim=-1)[..., 1].float().reshape(nb, 2, -1)
        return out

    def separate_score(self, clips: list, sr: int = 16000) -> list | None:
        """Per clip {"streams": (2, n) float32, "embs": (2, 192), "vads":
        [segments of stream 0, of stream 1]} (each segment clipped to the
        clip), or None for the windowed path."""
        from ..models.vad import VADConfig, segment_probs

        clips = [np.asarray(c, np.float32) for c in clips]
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            clips = [resample_poly_np(c, 16000, sr) for c in clips]
        top = self.LADDER.rungs[-1]
        if not self.takes_separator or not clips \
                or any(len(c) > top or len(c) == 0 for c in clips) \
                or len(clips) > self.N_LADDER.rungs[-1]:
            return None
        bucket = self.LADDER.bucket(max(len(c) for c in clips))
        nb = self.N_LADDER.bucket(len(clips))
        batch = np.zeros((nb, bucket), np.int16)
        lengths = np.full(nb, 1, np.int64)
        for i, c in enumerate(clips):
            batch[i, : len(c)] = quantize_i16(c)
            lengths[i] = len(c)
        with trace("fused/separate"), torch.inference_mode(), exact_float32():
            dev = self._device(torch.from_numpy(batch).to(self.device),
                               torch.from_numpy(lengths).to(self.device))
            host = {k: v.cpu().numpy() for k, v in dev.items()}
        out = []
        for i, c in enumerate(clips):
            n = len(c)
            streams = host["streams_i16"][i, :, :n].astype(np.float32) / 32768.0
            if "vad_probs" in host:
                t, dur = features.num_frames(n), n / 16000.0
                vads = [[[max(0.0, s), min(dur, e)] for s, e in
                         segment_probs(host["vad_probs"][i, j, :t], VADConfig())]
                        for j in range(2)]
            else:
                vads = [[[0.0, n / 16000.0]]] * 2
            out.append({"streams": streams, "embs": host["embs"][i], "vads": vads})
        return out


class FusedASR:
    """Paraformer ASR and punctuation of every speaker's track in one
    device pass over `FusedFrontend.analyze`'s int16 buffer: each track is
    the buffer under the speaker's intervals (sample ranges in float32),
    speakers pad to a rung of N_SPK_LADDER and their interval lists to one
    of SEG_LADDER. Punctuation runs on the ASR's ids only when the two
    engines share a vocabulary."""

    N_SPK_LADDER = BucketLadder((1, 2, 4, 8))
    SEG_LADDER = BucketLadder((2, 4, 8, 16, 32))

    def __init__(self, asr_engine, punc_engine=None):
        self.asr = asr_engine
        self.punc = punc_engine if (punc_engine is not None and punc_engine.tokenizer.vocab
                                    == asr_engine.tokenizer.vocab) else None
        self.device = asr_engine.device

    def _device(self, audio_i16: torch.Tensor, ranges: torch.Tensor,
                n_lfr: torch.Tensor) -> dict:
        from ..models.asr import LFR_M, LFR_N

        asr, punc = self.asr, self.punc
        bucket = audio_i16.shape[-1]
        audio = audio_i16.float() / 32768.0
        t_idx = torch.arange(bucket, device=self.device, dtype=torch.float32)[None, None, :]
        seg_m = (t_idx >= ranges[..., :1]) & (t_idx < ranges[..., 1:2])
        tracks = audio[None, :] * seg_m.any(dim=1)  # (n_spk, bucket)
        feats = features.lfr(features.fbank(tracks), LFR_M, LFR_N)
        if asr.cmvn is not None:
            feats = features.apply_cmvn(feats, *asr.cmvn)
        mask = (torch.arange(feats.shape[1], device=self.device)[None, :]
                < n_lfr[:, None]).float()
        out = asr.model(feats.to(asr.compute_dtype), mask.to(asr.compute_dtype))
        ids = torch.argmax(out["logits"], dim=-1)
        res = {"ids": ids, "n_tokens": out["n_tokens"], "fire_frames": out["fire_frames"]}
        if punc is not None:
            tok_mask = (torch.arange(ids.shape[1], device=self.device)[None, :]
                        < out["n_tokens"][:, None]).float()
            plogits = punc.model(ids, tok_mask.to(punc.compute_dtype)).float()
            res["punc_cls"] = torch.argmax(plogits, dim=-1)
        return res

    def transcribe_masked(self, audio_dev_i16: torch.Tensor, n_samples: int,
                          spk_ranges: list) -> list:
        """spk_ranges: per speaker a list of (start_s, end_s). Per speaker
        {"text", "timestamp", "punc_cls"}: the ASR result with `<blank>`,
        `<s>`, `</s>` and `<unk>` left out, and a punctuation class per
        kept character (None without punctuation)."""
        from ..models.asr import LFR_N, fire_frames_to_timestamps

        b = self.N_SPK_LADDER.bucket(max(len(spk_ranges), 1))
        max_segs = self.SEG_LADDER.bucket(max(max((len(r) for r in spk_ranges), default=1), 1))
        ranges = np.zeros((b, max_segs, 2), np.float32)
        n_lfr = np.ones(b, np.int64)
        for i, segs in enumerate(spk_ranges):
            end_max = 0.0
            for j, (s, e) in enumerate(segs[:max_segs]):
                ranges[i, j] = (s * 16000.0, e * 16000.0)
                end_max = max(end_max, e)
            n_valid = min(int(end_max * 16000), n_samples)
            n_lfr[i] = max(-(-features.num_frames(n_valid) // LFR_N), 1)
        with trace("fused/asr"), torch.inference_mode(), exact_float32():
            dev = self._device(audio_dev_i16, torch.from_numpy(ranges).to(self.device),
                               torch.from_numpy(n_lfr).to(self.device))
            host = {k: v.cpu().numpy() for k, v in dev.items()}
        results = []
        vocab = self.asr.tokenizer.vocab
        for i in range(len(spk_ranges)):
            n_tok = int(host["n_tokens"][i])
            ts_all = fire_frames_to_timestamps(host["fire_frames"][i, :n_tok], int(n_lfr[i]))
            chars, ts, pcls = [], [], []
            for j, tid in enumerate(host["ids"][i, :n_tok]):
                name = vocab[int(tid)]
                if name in ("<blank>", "<s>", "</s>", "<unk>"):
                    continue  # chars, timestamps and classes stay aligned
                chars.append(name)
                if j < len(ts_all):
                    ts.append(ts_all[j])
                if "punc_cls" in host:
                    pcls.append(int(host["punc_cls"][i, j]))
            results.append({"text": "".join(chars), "timestamp": ts,
                            "punc_cls": pcls if "punc_cls" in host else None})
        return results
