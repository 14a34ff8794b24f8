"""Paraformer and SenseVoice ASR, and their engine.

Counterpart of targetdiarization_tpu/models/asr.py. The Paraformer is a
SAN-M encoder, a CIF predictor and a SAN-M decoder; SenseVoice is the
same SAN-M encoder over 4 learned tag rows and the LFR frames, with a CTC
head on the frames and language, emotion and event heads on the tag rows.
The encoder's and decoder's SAN-M blocks are multi-head attention plus,
in self-attention only, a depthwise FSMN memory on the masked values
(`ops.dwconv`, 11 taps, SAME), added before the output projection. The
CIF predictor integrates frame weights in float32 with the JAX package's
closed form (`cif_fire`), including the 0.45 tail frame at speech end.
The decoder runs once over all token slots and the engine takes the
argmax on the device before the copy to the host (for SenseVoice, of the
CTC and tag logits; the CTC ids are collapsed on the host). The scanned
layer stacks of the JAX model are `nn.ModuleList`s here.
"""

from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dwconv import dw_conv1d
from ..ops.kernels import prepare_kernels
from ..ops.kernels.dwconv import prepare_taps
from ..runtime import microbatch
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import (dequantize_audio, promote_after, quantize_i16,
                                 resolve_compute_dtype)
from . import features
from .tokenizer import CharTokenizer

LFR_M, LFR_N = 7, 6
FRAME_MS = 10.0 * LFR_N  # 60 ms per LFR frame
SR = 16000
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def sinusoid(t: int, dim: int, device) -> torch.Tensor:
    """(t, dim) positions: [sin | cos] concatenated, inv = 1/10000^(2i/dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    ang = torch.arange(t, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------- SAN-M blocks ----------------


class SANMAttention(nn.Module):
    """Multi-head attention; in self-attention, plus a depthwise FSMN memory
    over the masked values."""

    def __init__(self, dim: int, heads: int = 4, fsmn_kernel: int = 11, memory: bool = True):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.fsmn = nn.Parameter(torch.zeros(fsmn_kernel, 1, dim)) if memory else None
        self.fsmn_taps = None

    def prepare_kernel(self, owner: str = ""):
        if self.fsmn is not None:
            self.fsmn_taps = prepare_taps(self.fsmn, owner)

    def forward(self, x, mask, context=None):
        # x (B, T, D); mask (B, T). Cross-attention sees every context
        # frame, padded ones included, as the JAX model does.
        src = x if context is None else context
        b, t, _ = x.shape
        s = src.shape[1]
        hd = self.dim // self.heads
        q = self.q(x).reshape(b, t, self.heads, hd).transpose(1, 2)
        k = self.k(src).reshape(b, s, self.heads, hd).transpose(1, 2)
        v = self.v(src)
        vh = v.reshape(b, s, self.heads, hd).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if context is None:
            att = att.masked_fill(~(mask[:, None, None, :] > 0), -1e9)
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, vh).transpose(1, 2).reshape(b, t, self.dim)
        if context is None:
            out = out + dw_conv1d(v * mask[..., None], self.fsmn, taps=self.fsmn_taps)
        return self.out(out)


class SANMBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, ffn: int = 2048, cross: bool = False):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SANMAttention(dim, heads)
        if cross:
            self.ln_cross = nn.LayerNorm(dim, eps=LN_EPS)
            self.cross_attn = SANMAttention(dim, heads, memory=False)
        self.cross = cross
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, ffn)
        self.ff2 = nn.Linear(ffn, dim)

    def forward(self, x, mask, context=None):
        x = x + self.attn(self.ln1(x), mask)
        if self.cross and context is not None:
            x = x + self.cross_attn(self.ln_cross(x), mask, context=context)
        h = self.ff2(torch.relu(self.ff1(self.ln2(x))))
        return (x + h) * mask[..., None]


class SANMEncoder(nn.Module):
    def __init__(self, dim: int = 512, heads: int = 4, ffn: int = 2048, n_layers: int = 12,
                 in_dim: int = 80 * LFR_M):
        super().__init__()
        self.dim = dim
        self.in_proj = nn.Linear(in_dim, dim)
        self.blocks = nn.ModuleList([SANMBlock(dim, heads, ffn) for _ in range(n_layers)])
        self.out_ln = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, feats, mask):
        x = self.in_proj(feats) * (self.dim ** 0.5)
        # the float32 table promotes x to float32, as in the JAX model
        x = x + sinusoid(x.shape[1], self.dim, x.device)[None]
        x = x * mask[..., None]
        for block in self.blocks:
            x = block(x, mask)
        return self.out_ln(x) * mask[..., None]


# ---------------- CIF predictor ----------------


def cif_fire(hidden: torch.Tensor, alphas: torch.Tensor, threshold: float = 1.0):
    """CIF integration in closed form (targetdiarization_tpu/models/asr.py::
    cif_fire): token k integrates the alpha mass of [k*thr, (k+1)*thr) on
    the cumulative axis and fires at the first frame whose cumulative sum
    reaches (k+1)*thr. hidden (B, T, D), alphas (B, T), both float32.
    Returns tokens (B, T, D), fire_frames (B, T) (-1 past n_tokens) and
    n_tokens (B,)."""
    t = hidden.shape[1]
    csum = torch.cumsum(alphas, dim=1)
    prev = csum - alphas
    k = torch.arange(t, device=alphas.device, dtype=csum.dtype)
    lo = k[None, :, None] * threshold
    hi = lo + threshold
    w = torch.clamp_min(torch.minimum(csum[:, None, :], hi)
                        - torch.maximum(prev[:, None, :], lo), 0.0)
    tokens = torch.matmul(w / threshold, hidden)
    n_tokens = torch.floor(csum[:, -1] / threshold + 1e-6).to(torch.int32)
    crossed = (csum[:, None, :] >= hi - 1e-6).to(torch.int32)
    fire_frames = t - crossed.sum(dim=-1)
    valid = k[None, :] < n_tokens[:, None]
    fire_frames = torch.where(valid, fire_frames, -1).to(torch.int32)
    tokens = torch.where(valid[..., None], tokens, 0.0)
    return tokens, fire_frames, n_tokens


class CIFPredictor(nn.Module):
    """Frame weights alpha from a 3-tap conv and a sigmoid, integrated and
    fired in float32. At inference a virtual frame carrying 0.45 of alpha
    mass follows the last valid frame, so a last token short of the
    threshold still fires; its fire frame is clamped to the last valid one.
    With `target_len` (B,) (forced alignment) the alphas are scaled, in
    their own type, to sum to it, and no tail frame is added. Returns
    tokens, fire frames, token counts, the alphas the CIF integrated and
    `alphas_raw`, the alphas before that scaling (the training recipe's
    quantity and alignment losses read them)."""

    def __init__(self, dim: int = 512, threshold: float = 1.0, tail_threshold: float = 0.45):
        super().__init__()
        self.threshold, self.tail_threshold = threshold, tail_threshold
        self.conv = nn.Conv1d(dim, dim, 3, padding=1)
        self.alpha = nn.Linear(dim, 1)

    def forward(self, enc, mask, target_len=None):
        h = torch.relu(self.conv(enc.transpose(1, 2)).transpose(1, 2))
        alphas = alphas_raw = torch.sigmoid(self.alpha(h))[..., 0] * mask
        if target_len is not None:
            total = torch.clamp_min(alphas.sum(dim=1, keepdim=True), 1e-6)
            alphas = alphas / total * target_len.to(alphas.dtype)[:, None]
            tokens, fire_frames, n_tokens = cif_fire(enc.float(), alphas.float(), self.threshold)
            return tokens.to(enc.dtype), fire_frames, n_tokens, alphas, alphas_raw
        enc_f, alphas_f = enc.float(), alphas.float()
        b, t = alphas.shape
        # the valid-frame count in the mask's type, as the JAX model sums it:
        # in bf16 a count above 256 rounds, which moves the tail frame
        valid = mask.sum(dim=1).to(torch.int64)
        # a count rounded past T puts the tail nowhere (jax.nn.one_hot's zeros)
        slots = torch.arange(t + 1, device=mask.device)
        ext = (slots[None, :] == valid[:, None]).float() * self.tail_threshold
        alphas_f = F.pad(alphas_f, (0, 1)) + ext
        enc_f = F.pad(enc_f, (0, 0, 0, 1))
        tokens, fire_frames, n_tokens = cif_fire(enc_f, alphas_f, self.threshold)
        last_valid = torch.clamp_min(valid - 1, 0)[:, None].to(torch.int32)
        fire_frames = torch.where(fire_frames >= 0, torch.minimum(fire_frames, last_valid), -1)
        return tokens[:, :t].to(enc.dtype), fire_frames[:, :t], n_tokens, alphas, alphas_raw


# ---------------- the model ----------------


class Paraformer(nn.Module):
    """Non-autoregressive encoder - CIF - decoder ASR."""

    def __init__(self, vocab_size: int = 21001, dim: int = 512, heads: int = 4,
                 ffn: int = 2048, enc_layers: int = 50, dec_layers: int = 16):
        super().__init__()
        self.encoder = SANMEncoder(dim, heads, ffn, enc_layers)
        self.predictor = CIFPredictor(dim)
        self.decoder_blocks = nn.ModuleList(
            [SANMBlock(dim, heads, ffn, cross=True) for _ in range(dec_layers)])
        self.dec_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.vocab_proj = nn.Linear(dim, vocab_size)

    def forward(self, feats, mask, target_len=None) -> dict:
        """feats (B, T, 560), mask (B, T) -> logits (B, T, V) over T token
        slots, n_tokens (B,), fire_frames (B, T), alphas, alphas_raw (before
        `target_len` scaling), encoder_out; with
        `target_len` (B,), the CIF is forced to that many tokens."""
        enc = self.encoder(feats, mask)
        tokens, fire_frames, n_tokens, alphas, alphas_raw = self.predictor(enc, mask, target_len)
        u = tokens.shape[1]
        tok_mask = (torch.arange(u, device=feats.device)[None, :]
                    < n_tokens[:, None]).to(feats.dtype)
        x = tokens
        for block in self.decoder_blocks:
            x = block(x, tok_mask, context=enc)
        logits = self.vocab_proj(self.dec_ln(x))
        return {"logits": logits, "n_tokens": n_tokens, "fire_frames": fire_frames,
                "alphas": alphas, "alphas_raw": alphas_raw, "encoder_out": enc}


class SenseVoice(nn.Module):
    """Encoder-only CTC ASR with a rich-tag prefix: the 4 rows of
    `tag_queries` go ahead of the (CMVN'd) LFR features and the mask is
    extended by ones, so every SAN-M memory runs over T + 4 rows; the
    first three encoded rows feed the language, emotion and event heads,
    the rest the CTC head."""

    def __init__(self, vocab_size: int = 21001, dim: int = 512, heads: int = 4,
                 ffn: int = 2048, enc_layers: int = 50, n_lang: int = 8, n_emotion: int = 8,
                 n_event: int = 8):
        super().__init__()
        self.tag_queries = nn.Parameter(torch.zeros(4, 80 * LFR_M))
        self.encoder = SANMEncoder(dim, heads, ffn, enc_layers)
        self.ctc = nn.Linear(dim, vocab_size)
        self.lang_head = nn.Linear(dim, n_lang)
        self.emotion_head = nn.Linear(dim, n_emotion)
        self.event_head = nn.Linear(dim, n_event)

    def forward(self, feats, mask) -> dict:
        """feats (B, T, 560), mask (B, T) -> ctc_logits (B, T, V) and the
        lang, emotion and event logits (B, n)."""
        b = feats.shape[0]
        prefix = self.tag_queries.to(feats.dtype)[None].expand(b, -1, -1)
        feats = torch.cat([prefix, feats], dim=1)
        mask = torch.cat([torch.ones(b, 4, dtype=mask.dtype, device=mask.device), mask], dim=1)
        enc = self.encoder(feats, mask)
        tags = enc[:, :4]
        return {"ctc_logits": self.ctc(enc[:, 4:]), "lang_logits": self.lang_head(tags[:, 0]),
                "emotion_logits": self.emotion_head(tags[:, 1]),
                "event_logits": self.event_head(tags[:, 2])}


LANGS = ["zh", "en", "yue", "ja", "ko", "nospeech", "auto", "other"]
EMOTIONS = ["NEUTRAL", "HAPPY", "ANGRY", "SAD", "FEARFUL", "DISGUSTED", "SURPRISED", "UNKNOWN"]
EVENTS = ["Speech", "BGM", "Applause", "Laughter", "Cough", "Sneeze", "Breath", "Cry"]


def ctc_greedy(ids, blank_id: int) -> list:
    """Repeats collapsed, then blanks removed."""
    out, prev = [], -1
    for i in ids:
        i = int(i)
        if i != prev and i != blank_id:
            out.append(i)
        prev = i
    return out


@dataclass
class ASRResult:
    text: str
    timestamp: list  # [[start_ms, end_ms], ...] a character (Paraformer)
    raw_text: str = ""
    language: str = ""
    emotion: str = ""
    event: str = ""

    def to_dict(self) -> dict:
        d = {"text": self.text, "timestamp": self.timestamp}
        for key in ("raw_text", "language", "emotion", "event"):
            if getattr(self, key):
                d[key] = getattr(self, key)
        return d


# ---------------- engine ----------------

_SAMPLE_LADDER = BucketLadder(tuple(int(s * SR) for s in (1, 2, 4, 8, 16, 30, 60)))


def fire_frames_to_timestamps(fire_frames, total_frames: int) -> list:
    """CIF fire frames -> [start_ms, end_ms] per token (60 ms LFR frames)."""
    out = []
    prev = 0
    for f in fire_frames:
        f = int(f)
        if f < 0:
            break
        out.append([int(round(prev * FRAME_MS)), int(round((f + 1) * FRAME_MS))])
        prev = f + 1
    return out


class ASREngine:
    """Bucketed Paraformer or SenseVoice (`engine` says which) with the
    reference's result contract: [{"text": ..., "timestamp": [[start_ms,
    end_ms], ...]}], for SenseVoice with no timestamps and with
    "raw_text" (<|lang|><|emotion|><|event|>text), "language", "emotion"
    and "event". One synchronous
    forward per call (per sample rung for a batch; concurrent callers'
    single utterances at one rung share one forward of ROW_LADDER rows,
    `_run_mb`); audio goes up as int16
    and fbank + LFR + CMVN run on the device in float32. In a reduced
    compute type only `in_proj` computes in it (`promote_after`)."""

    def __init__(self, model: Paraformer | SenseVoice, tokenizer: CharTokenizer | None = None, cmvn=None,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.engine = "sensevoice" if isinstance(model, SenseVoice) else "paraformer"
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = promote_after(model.to(self.device), model.encoder.in_proj,
                                   self.compute_dtype).eval()
        prepare_kernels(self.model)
        self.tokenizer = tokenizer or CharTokenizer()
        self.cmvn = None if cmvn is None else tuple(
            torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in cmvn)
        # concurrent sessions' single utterances at one sample rung coalesce
        # into one batched forward (runtime/microbatch.py)
        self._mb = microbatch.MicroBatcher(self._run_mb) if microbatch.enabled() else None

    # row rungs of coalesced single-utterance forwards
    ROW_LADDER = (1, 2, 4, 8)

    def _run_mb(self, key: int, items: list) -> list:
        """The batcher's callback: (int16 row, LFR frames) items at one
        sample rung, padded to a row rung with rows of one frame, in one
        forward; each item's decoded result."""
        nb = self.ROW_LADDER[min(bisect.bisect_left(self.ROW_LADDER, len(items)),
                                 len(self.ROW_LADDER) - 1)]
        nb = max(nb, len(items))
        batch = np.zeros((nb, key), np.int16)
        ts = [1] * nb
        for i, (row, t) in enumerate(items):
            batch[i] = row
            ts[i] = t
        out = self._dispatch(batch, ts)
        return [self._decode_row(out, i, t) for i, (_, t) in enumerate(items)]

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "ASREngine":
        from ..runtime.registry import from_pretrained

        tok = CharTokenizer(vocab_file=os.path.join(path, "vocab.txt"))
        cmvn = None
        cmvn_file = os.path.join(path, "cmvn.npz")
        if os.path.exists(cmvn_file):
            with np.load(cmvn_file) as z:
                cmvn = (z["mean"], z["istd"])
        return cls(from_pretrained(path), tokenizer=tok, cmvn=cmvn, device=device,
                   compute_dtype=compute_dtype)

    def forward_device(self, batch: np.ndarray, ts: list, target_len: list | None = None) -> dict:
        """(rows, bucket) float or int16 audio and LFR frame counts -> the
        model's output dict, on the device (call under torch.inference_mode);
        `target_len`, a token count per row, forces the CIF to it."""
        audio = torch.from_numpy(quantize_i16(batch)).to(self.device)
        feats = features.lfr(features.fbank(dequantize_audio(audio)), LFR_M, LFR_N)
        if self.cmvn is not None:
            feats = features.apply_cmvn(feats, *self.cmvn)
        t = feats.shape[1]
        n = torch.tensor(ts, device=self.device)
        mask = (torch.arange(t, device=self.device)[None, :] < n[:, None]).to(self.compute_dtype)
        if target_len is None:
            return self.model(feats.to(self.compute_dtype), mask)
        target_len = torch.tensor(target_len, device=self.device, dtype=torch.float32)
        return self.model(feats.to(self.compute_dtype), mask, target_len)

    def _dispatch(self, batch: np.ndarray, ts: list) -> dict:
        with torch.inference_mode():
            out = self.forward_device(batch, ts)
            if self.engine == "sensevoice":
                heads = {"ctc_ids": "ctc_logits", "lang_id": "lang_logits",
                         "emotion_id": "emotion_logits", "event_id": "event_logits"}
                return {k: torch.argmax(out[v], dim=-1).cpu().numpy() for k, v in heads.items()}
            ids = torch.argmax(out["logits"], dim=-1)
            return {"ids": ids.cpu().numpy(), "n_tokens": out["n_tokens"].cpu().numpy(),
                    "fire_frames": out["fire_frames"].cpu().numpy()}

    def _decode_row(self, out: dict, row: int, t: int) -> dict:
        if self.engine == "sensevoice":
            text = self.tokenizer.decode(ctc_greedy(out["ctc_ids"][row, :t],
                                                    self.tokenizer.blank_id))
            lang, emo, ev = (LANGS[int(out["lang_id"][row])],
                             EMOTIONS[int(out["emotion_id"][row])],
                             EVENTS[int(out["event_id"][row])])
            return ASRResult(text=text, timestamp=[], raw_text=f"<|{lang}|><|{emo}|><|{ev}|>{text}",
                             language=lang, emotion=emo, event=ev).to_dict()
        n_tok = int(out["n_tokens"][row])
        fire_frames = out["fire_frames"][row, :n_tok]
        ids = out["ids"][row, :n_tok] if n_tok else np.zeros(0, np.int64)
        text = self.tokenizer.decode(ids)
        ts_list = fire_frames_to_timestamps(fire_frames, t)
        keep = [i for i, tid in enumerate(ids)
                if self.tokenizer.vocab[int(tid)] not in ("<blank>", "<s>", "</s>")]
        return {"text": text, "timestamp": [ts_list[i] for i in keep if i < len(ts_list)]}

    def force_align(self, audio: np.ndarray, n_tokens: int, sr: int = SR) -> list:
        """[start_ms, end_ms] per token for a known token count, by CIF forced
        alignment: the alphas scaled so that n_tokens fire (at most one per
        LFR frame). Audio past the top rung (60 s) is dropped. Fewer
        entries come back where the scaled alphas' float32 sum lands short
        of the last token's threshold; none from SenseVoice, which has no
        CIF."""
        if self.engine != "paraformer" or n_tokens <= 0:
            return []
        audio = np.asarray(audio, np.float32)
        if sr != SR:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, SR, sr)
        audio = audio[:_SAMPLE_LADDER.rungs[-1]]
        n_valid = features.num_frames(len(audio))
        if n_valid == 0:
            return []
        t = -(-n_valid // LFR_N)
        n_tokens = min(n_tokens, t)
        padded = pad_to(audio, _SAMPLE_LADDER.bucket(len(audio)))[None]
        with torch.inference_mode():
            fire = self.forward_device(padded, [t], [n_tokens])["fire_frames"]
            fire = fire[0, :n_tokens].cpu().numpy()
        return fire_frames_to_timestamps(fire, t)

    def asr_detection(self, audio: np.ndarray, sr: int = SR) -> list:
        """[{"text", "timestamp"}] for one utterance; audio above the top
        rung (60 s) is windowed there, texts joined and timestamps offset."""
        audio = np.asarray(audio, np.float32)
        if sr != SR:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, SR, sr)
            sr = SR
        top = _SAMPLE_LADDER.rungs[-1]
        if len(audio) > top:
            text_parts, ts_parts = [], []
            for i in range(0, len(audio), top):
                sub = self.asr_detection(audio[i: i + top], sr)[0]
                text_parts.append(sub["text"])
                off = int(i / sr * 1000)
                ts_parts.extend([[s + off, e + off] for s, e in sub["timestamp"]])
            return [{"text": "".join(text_parts), "timestamp": ts_parts}]
        n_valid = features.num_frames(len(audio), sr)
        if n_valid == 0:
            return [{"text": "", "timestamp": []}]
        t = -(-n_valid // LFR_N)
        bucket = _SAMPLE_LADDER.bucket(len(audio))
        padded = quantize_i16(pad_to(audio, bucket)[None])
        if self._mb is not None:
            return [self._mb.submit(bucket, (padded[0], t))]
        return [self._decode_row(self._dispatch(padded, [t]), 0, t)]

    def asr_detection_batch(self, audios: list, sr: int = SR) -> list:
        """asr_detection over several utterances, one forward per sample
        rung; the same result per item, in order."""
        audios = [np.asarray(a, np.float32) for a in audios]
        if sr != SR:
            from ..ops.resample import resample_poly_np

            audios = [resample_poly_np(a, SR, sr) for a in audios]
            sr = SR
        top = _SAMPLE_LADDER.rungs[-1]
        results: list = [None] * len(audios)
        by_bucket: dict = {}
        for i, a in enumerate(audios):
            if len(a) > top or features.num_frames(len(a), sr) == 0:
                results[i] = self.asr_detection(a, sr)[0]
            else:
                by_bucket.setdefault(_SAMPLE_LADDER.bucket(len(a)), []).append(i)
        for bucket, idxs in by_bucket.items():
            batch = np.stack([pad_to(audios[i], bucket) for i in idxs])
            ts = [-(-features.num_frames(len(audios[i]), sr) // LFR_N) for i in idxs]
            out = self._dispatch(batch, ts)
            for row, i in enumerate(idxs):
                results[i] = self._decode_row(out, row, ts[row])
        return results
