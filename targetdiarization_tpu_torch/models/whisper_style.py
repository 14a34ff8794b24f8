"""Whisper-style encoder-decoder ASR and its greedy engine.

Counterpart of targetdiarization_tpu/models/whisper_style.py, the
`whisper`, `whisper_v2`, `whisper_v3` and `whisper_finetune` engines of
`ASRProcessor`. The encoder normalizes each utterance's log-mel frames
over its valid frames (mean and variance, rsqrt(var + 1e-5)), runs two
3-tap convs ("SAME"; the second of stride 2, so an even T is padded by
(0, 1) and an odd T by (1, 1)), adds the [sin | cos] positions and runs
pre-norm transformer layers whose keys and values are the layer's
un-normed input, as the JAX model's `enc_attn(ln1(x), x)` gives them. The
decoder is causal over learned positions, with cross-attention to the
valid encoder frames. Attention is flax's: the query scaled by 1/sqrt(hd)
first, masked logits set to the type's most negative value; `nn.gelu` is
the tanh approximation.

The JAX engine decodes all `max_decode` steps, each over the whole token
row; a step's argmax at position i depends only on the tokens before it
(the mask is causal), so the port decodes the prefix of i + 1 tokens and
projects only its last position: the same greedy ids, without the
padded rows' work. A token after EOS is EOS. No kernel of the port runs
here: the model is attention, LayerNorm, convolutions and GEMMs.

In a reduced compute type the JAX engine casts only the features and the
weights, and its stream promotes to float32 where a float32 operand
joins: the encoder at once (the float32 mask), the decoder at the first
cross-attention (the float32 encoder output). The engine does the same:
the token embedding, the first decoder block's self-attention, its two
LayerNorms before that point and its cross-attention's query projection
compute in the compute type; the rest in float32 from rounded weights.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ..ops.conv import Conv1dSame, gelu
from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import promote_after, resolve_compute_dtype
from . import features
from .asr import LN_EPS, sinusoid
from .tokenizer import CharTokenizer

_SAMPLE_LADDER = BucketLadder(tuple(int(s * 16000) for s in (1, 2, 4, 8, 16, 30)))


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention: queries from `x`, keys and values
    from `kv`, `mask` (broadcast to (B, H, T, S)) True where attended. The
    three projections may hold different types; the product runs in their
    promoted type."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, kv, mask):
        b, t, dim = x.shape
        hd = dim // self.heads

        def heads(z):
            return z.reshape(b, z.shape[1], self.heads, hd).transpose(1, 2)

        q, k, v = self.query(x), self.key(kv), self.value(kv)
        dtype = torch.promote_types(q.dtype, k.dtype)
        q, k, v = heads(q.to(dtype)) / math.sqrt(hd), heads(k.to(dtype)), heads(v.to(dtype))
        att = torch.matmul(q, k.transpose(-1, -2))
        att = torch.softmax(att.masked_fill(~mask, torch.finfo(att.dtype).min), dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, t, dim)
        return self.out(out.to(self.out.weight.dtype))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, ffn: int = 1024):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attn = Attention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = Attention(dim, heads)
        self.ln3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, ffn)
        self.ff2 = nn.Linear(ffn, dim)

    def forward(self, x, enc, self_mask, enc_mask):
        h = self.ln1(x)
        x = x + self.self_attn(h, h, self_mask)
        x = x + self.cross_attn(self.ln2(x), enc, enc_mask)
        return x + self.ff2(gelu(self.ff1(self.ln3(x))))


class WhisperStyleASR(nn.Module):
    """Conv-downsampled log-mel encoder and causal transformer decoder."""

    def __init__(self, vocab_size: int = 21001, dim: int = 256, heads: int = 4, ffn: int = 1024,
                 enc_layers: int = 6, dec_layers: int = 4, max_tokens: int = 224):
        super().__init__()
        self.dim, self.max_tokens = dim, max_tokens
        self.conv1 = Conv1dSame(80, dim, 3)
        self.conv2 = Conv1dSame(dim, dim, 3, stride=2)
        self.enc_ln1 = nn.ModuleList([nn.LayerNorm(dim, eps=LN_EPS) for _ in range(enc_layers)])
        self.enc_attn = nn.ModuleList([Attention(dim, heads) for _ in range(enc_layers)])
        self.enc_ln2 = nn.ModuleList([nn.LayerNorm(dim, eps=LN_EPS) for _ in range(enc_layers)])
        self.enc_ff1 = nn.ModuleList([nn.Linear(dim, ffn) for _ in range(enc_layers)])
        self.enc_ff2 = nn.ModuleList([nn.Linear(ffn, dim) for _ in range(enc_layers)])
        self.enc_out_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.dec_pos = nn.Parameter(torch.zeros(max_tokens, dim))
        self.dec_blocks = nn.ModuleList([DecoderBlock(dim, heads, ffn) for _ in range(dec_layers)])
        self.dec_out_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.vocab_proj = nn.Linear(dim, vocab_size)

    @staticmethod
    def enc_mask(feat_mask: torch.Tensor, s: int) -> torch.Tensor:
        """(B, T) frame mask -> (B, 1, 1, S) bool over the encoder's frames."""
        return (feat_mask[:, ::2][:, :s] > 0)[:, None, None, :]

    def encode(self, feats, feat_mask):
        """feats (B, T, 80) log-mel, feat_mask (B, T) float32 -> (B, ceil(T/2), dim)."""
        m = feat_mask[..., None]
        denom = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
        mean = (feats * m).sum(dim=1, keepdim=True) / denom
        var = ((feats - mean).square() * m).sum(dim=1, keepdim=True) / denom
        x = (feats - mean) * torch.rsqrt(var + 1e-5) * m
        x = gelu(self.conv1(x.transpose(1, 2)))
        x = gelu(self.conv2(x)).transpose(1, 2)
        t = x.shape[1]
        x = x + sinusoid(t, self.dim, x.device)[None]
        mask = self.enc_mask(feat_mask, t)
        for ln1, attn, ln2, ff1, ff2 in zip(self.enc_ln1, self.enc_attn, self.enc_ln2,
                                            self.enc_ff1, self.enc_ff2):
            x = x + attn(ln1(x), x, mask)
            x = x + ff2(gelu(ff1(ln2(x))))
        return self.enc_out_ln(x) * feat_mask[:, ::2][:, :t, None]

    def decode(self, tokens, enc, enc_mask, last_only: bool = False):
        """tokens (B, U) -> logits (B, U, V), or (B, V) of the last position
        with `last_only`."""
        u = tokens.shape[1]
        x = self.tok_embed(tokens)
        x = x + self.dec_pos[:u].to(x.dtype)
        causal = torch.ones(u, u, dtype=torch.bool, device=tokens.device).tril()[None, None]
        for block in self.dec_blocks:
            x = block(x, enc, causal, enc_mask)
        if last_only:
            x = x[:, -1]
        return self.vocab_proj(self.dec_out_ln(x))

    def forward(self, feats, feat_mask, tokens):
        """Teacher-forced: tokens (B, U) -> logits (B, U, V)."""
        enc = self.encode(feats, feat_mask)
        return self.decode(tokens, enc, self.enc_mask(feat_mask, enc.shape[1]))


class WhisperStyleEngine:
    """Greedy decoding of `max_decode` (at most 64) tokens after <s>, one
    padded forward a call on a sample rung (1 .. 30 s; a longer clip
    raises, as in the JAX engine). The audio goes to the device as float32
    and the whole loop runs there; the ids come back once."""

    def __init__(self, model: WhisperStyleASR, tokenizer: CharTokenizer | None = None,
                 max_decode: int = 64, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        block = model.dec_blocks[0]
        first = [model.tok_embed, block.ln1, block.self_attn, block.ln2, block.cross_attn.query]
        self.model = promote_after(model.to(self.device), first, self.compute_dtype).eval()
        self.tokenizer = tokenizer or CharTokenizer()
        self.max_decode = min(max_decode, model.max_tokens)
        self.engine = "whisper"

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "WhisperStyleEngine":
        from ..runtime.registry import from_pretrained

        model = from_pretrained(path)
        if not isinstance(model, WhisperStyleASR):
            raise ValueError(f"{path!r} holds a {type(model).__name__}, not a WhisperStyleASR")
        tok = CharTokenizer(vocab_file=os.path.join(path, "vocab.txt"))
        return cls(model, tokenizer=tok, device=device, compute_dtype=compute_dtype)

    def encode(self, batch: np.ndarray, n_frames: list) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, bucket) float32 audio -> the encoder output and its mask
        (call under torch.inference_mode)."""
        audio = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)
        feats = features.fbank(audio)
        t = feats.shape[1]
        n = torch.tensor(n_frames, device=self.device)
        fmask = (torch.arange(t, device=self.device)[None, :] < n[:, None]).float()
        enc = self.model.encode(feats.to(self.compute_dtype), fmask)
        return enc, self.model.enc_mask(fmask, enc.shape[1])

    def greedy(self, batch: np.ndarray, n_frames: list) -> np.ndarray:
        """(rows, bucket) audio -> (rows, max_decode) greedy ids after <s>."""
        eos = self.tokenizer.eos_id
        with torch.inference_mode():
            enc, enc_mask = self.encode(batch, n_frames)
            b = enc.shape[0]
            toks = torch.full((b, 1), self.tokenizer.sos_id, dtype=torch.long, device=self.device)
            done = torch.zeros(b, dtype=torch.bool, device=self.device)
            for _ in range(self.max_decode):
                nxt = torch.argmax(self.model.decode(toks, enc, enc_mask, last_only=True), dim=-1)
                nxt = torch.where(done, eos, nxt)
                toks = torch.cat([toks, nxt[:, None]], dim=1)
                done = done | (nxt == eos)
            return toks[:, 1:].cpu().numpy()

    def asr_detection(self, audio: np.ndarray, sr: int = 16000, **_) -> list:
        """[{"text", "timestamp": []}]: the ids up to the first EOS."""
        audio = np.asarray(audio, np.float32)
        if sr != 16000:
            from ..ops.resample import resample_poly_np

            audio = resample_poly_np(audio, 16000, sr)
        t = features.num_frames(len(audio))
        if t == 0:
            return [{"text": "", "timestamp": []}]
        padded = pad_to(audio, _SAMPLE_LADDER.bucket(len(audio)))[None]
        out = []
        for i in self.greedy(padded, [t])[0]:
            if int(i) == self.tokenizer.eos_id:
                break
            out.append(int(i))
        return [{"text": self.tokenizer.decode(out), "timestamp": []}]
