"""Character tokenizer of the ASR and punctuation models.

Copy of targetdiarization_tpu/models/tokenizer.py (plain Python; the port
keeps its own copy because importing the JAX package loads flax). A
checkpoint's `vocab.txt` holds one token per line; without one the
built-in vocabulary is the four specials, printable ASCII and the CJK
Unified Ideographs block. Special ids: blank 0, `<s>` 1, `</s>` 2, `<unk>` 3.
"""

from __future__ import annotations

import os

BLANK, SOS, EOS, UNK = "<blank>", "<s>", "</s>", "<unk>"


def default_vocab() -> list:
    specials = [BLANK, SOS, EOS, UNK]
    ascii_printable = [chr(c) for c in range(0x20, 0x7F)]
    cjk = [chr(c) for c in range(0x4E00, 0x9FA6)]
    return specials + ascii_printable + cjk


class CharTokenizer:
    def __init__(self, vocab: list | None = None, vocab_file: str | None = None):
        if vocab is None and vocab_file and os.path.exists(vocab_file):
            with open(vocab_file, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.vocab = vocab or default_vocab()
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self.blank_id = self.token_to_id.get(BLANK, 0)
        self.sos_id = self.token_to_id.get(SOS, 1)
        self.eos_id = self.token_to_id.get(EOS, 2)
        self.unk_id = self.token_to_id.get(UNK, 3)

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> list:
        return [self.token_to_id.get(ch, self.unk_id) for ch in text]

    def decode(self, ids, strip_special: bool = True) -> str:
        """Tokens joined; blank, <s> and </s> stripped and <unk> dropped
        (with strip_special); ids outside the vocabulary skipped."""
        out = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.vocab):
                continue
            tok = self.vocab[i]
            if strip_special and tok in (BLANK, SOS, EOS):
                continue
            out.append("" if (strip_special and tok == UNK) else tok)
        return "".join(out)

    def save(self, path: str):
        """The vocabulary, one token a line (what `vocab_file` reads)."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.vocab))
