"""CT-Transformer punctuation restoration and its engine.

Counterpart of targetdiarization_tpu/models/punctuation.py: a small
bidirectional transformer over character tokens that predicts, for each
position, the punctuation mark (if any) that follows it. The attention
is flax's `MultiHeadDotProductAttention`: the query scaled by 1/sqrt(hd)
before the product, masked keys set to the type's most negative value.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ..runtime.buckets import BucketLadder, pad_to
from ..runtime.precision import promote_after, resolve_compute_dtype
from .asr import LN_EPS, sinusoid
from .tokenizer import CharTokenizer

PUNC_LIST = ["", "，", "。", "？", "、", "！"]  # class 0 = no punctuation


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, key mask)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, t, dim = x.shape
        hd = dim // self.heads

        def heads(z):
            return z.reshape(b, t, self.heads, hd).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(hd)
        att = torch.matmul(q, heads(self.key(x)).transpose(-1, -2))
        att = att.masked_fill(~(mask[:, None, None, :] > 0), torch.finfo(att.dtype).min)
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, heads(self.value(x))).transpose(1, 2).reshape(b, t, dim)
        return self.out(out)


class PuncLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, ffn)
        self.ff2 = nn.Linear(ffn, dim)

    def forward(self, x, mask):
        x = x + self.attn(self.ln1(x), mask)
        h = self.ff2(torch.relu(self.ff1(self.ln2(x))))
        return (x + h) * mask[..., None]


class CTTransformerPunc(nn.Module):
    def __init__(self, vocab_size: int = 21001, dim: int = 256, heads: int = 4,
                 ffn: int = 1024, n_layers: int = 4, n_classes: int = len(PUNC_LIST)):
        super().__init__()
        self.dim = dim
        self.embed = nn.Embedding(vocab_size, dim)
        self.layers = nn.ModuleList([PuncLayer(dim, heads, ffn) for _ in range(n_layers)])
        self.head = nn.Linear(dim, n_classes)

    def forward(self, token_ids, mask):
        """token_ids (B, T) int, mask (B, T) -> logits (B, T, n_classes)."""
        x = self.embed(token_ids)
        # the float32 table promotes x to float32, as in the JAX model
        x = x + sinusoid(x.shape[1], self.dim, x.device)[None]
        x = x * mask[..., None]
        for layer in self.layers:
            x = layer(x, mask)
        return self.head(x)


_TOKEN_LADDER = BucketLadder((16, 32, 64, 128, 256, 512, 1024))


class PunctuationEngine:
    """Punctuation classes per character, one forward per call (texts
    padded to a token rung), argmax on the device. In a reduced compute
    type only the embedding is in it (`runtime.precision.promote_after`)."""

    def __init__(self, model: CTTransformerPunc, tokenizer: CharTokenizer | None = None,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None):
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = promote_after(model.to(self.device), model.embed,
                                   self.compute_dtype).eval()
        self.tokenizer = tokenizer or CharTokenizer()

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None) -> "PunctuationEngine":
        from ..runtime.registry import from_pretrained

        tok = CharTokenizer(vocab_file=os.path.join(path, "vocab.txt"))
        return cls(from_pretrained(path), tokenizer=tok, device=device,
                   compute_dtype=compute_dtype)

    def predict_classes_batch(self, texts: list) -> list:
        """Class ids per character of each text (empty for an empty text)."""
        ids_list = [self.tokenizer.encode(t) for t in texts]
        lens = [len(i) for i in ids_list]
        out: list = [np.zeros(0, np.int64)] * len(texts)
        idxs = [i for i, n in enumerate(lens) if n > 0]
        if not idxs:
            return out
        bucket = _TOKEN_LADDER.bucket(max(lens[i] for i in idxs))
        arr = np.stack([pad_to(np.asarray(ids_list[i], np.int64), bucket) for i in idxs])
        mask = np.zeros((len(idxs), bucket), np.float32)
        for r, i in enumerate(idxs):
            mask[r, :lens[i]] = 1.0
        with torch.inference_mode():
            logits = self.model(torch.from_numpy(arr).to(self.device),
                                torch.from_numpy(mask).to(self.device, self.compute_dtype))
            cls = torch.argmax(logits.float(), dim=-1).cpu().numpy()
        for r, i in enumerate(idxs):
            out[i] = cls[r, :lens[i]]
        return out

    def predict_classes(self, text: str) -> np.ndarray:
        return self.predict_classes_batch([text])[0]

    @staticmethod
    def _apply_classes(text: str, classes) -> str:
        out = []
        for ch, c in zip(text, classes):
            out.append(ch)
            out.append(PUNC_LIST[int(c)])
        restored = "".join(out)
        if restored and restored[-1] not in "。？！.!?":  # a terminal mark at the end
            restored += "。"
        return restored

    def punctuation_restore(self, text: str) -> str:
        """text with the predicted mark after each character."""
        if not text:
            return text
        return self._apply_classes(text, self.predict_classes(text))

    def punctuation_restore_batch(self, texts: list) -> list:
        classes = self.predict_classes_batch(texts)
        return [self._apply_classes(t, c) if t else t for t, c in zip(texts, classes)]
