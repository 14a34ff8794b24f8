"""Procedural supervised speech synthesis: a small synthetic language.

The port's own copy of targetdiarization_tpu/train/synth.py (numpy only):
a fixed set of characters, each rendered as a distinct formant-synthesized
syllable with exact per-character time boundaries, so any character
sequence becomes audio with a known transcript and timestamps. The same
generator state gives the JAX package's samples.
"""

from __future__ import annotations

import numpy as np

SR = 16000

# 32-character synthetic vocabulary (all in the default CharTokenizer)
BOOT_CHARS = "一二三四五六七八九十天地人日月水火山石田土王中大小上下左右心口手"

# last char of a "question" utterance (punctuation rule, see punc_corpus)
QUESTION_CHAR = "上"


def _char_params(idx: int) -> dict:
    """Deterministic acoustic identity for char #idx."""
    f1 = 280.0 + 170.0 * (idx % 6)  # 280..1130 Hz
    f2 = 1000.0 + 240.0 * ((idx // 6) % 6)  # 1000..2200 Hz
    dur = 0.16 + 0.05 * (idx % 3)  # 160/210/260 ms classes
    fricative = (idx % 8) == 7  # every 8th char is noise-band
    return {"f1": f1, "f2": f2, "dur": dur, "fricative": fricative}


def synth_char(idx: int, rng: np.random.Generator, sr: int = SR) -> np.ndarray:
    """Render one syllable for char #idx with natural jitter."""
    p = _char_params(idx)
    dur = p["dur"] * rng.uniform(0.9, 1.1)
    n = int(dur * sr)
    t = np.arange(n) / sr
    bw = 130.0
    if p["fricative"]:
        # band-passed noise centered between the two formants
        noise = rng.standard_normal(n).astype(np.float32)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        shape = (np.exp(-((freqs - p["f1"]) / (2 * bw)) ** 2)
                 + 0.8 * np.exp(-((freqs - p["f2"]) / (2 * bw)) ** 2))
        out = np.fft.irfft(spec * shape, n=n).astype(np.float32)
    else:
        f0 = rng.uniform(95.0, 220.0)  # speaker-like variation
        out = np.zeros(n, np.float32)
        k_max = int(4000.0 / f0)
        for k in range(1, k_max + 1):
            fk = k * f0
            amp = (np.exp(-((fk - p["f1"]) / bw) ** 2)
                   + 0.7 * np.exp(-((fk - p["f2"]) / bw) ** 2)
                   + 0.02 / k)
            phase = rng.uniform(0, 2 * np.pi)
            out += (amp * np.sin(2 * np.pi * fk * t + phase)).astype(np.float32)
    # attack/decay envelope
    att = max(int(0.02 * sr), 1)
    env = np.ones(n, np.float32)
    env[:att] = np.linspace(0, 1, att)
    env[-att:] *= np.linspace(1, 0, att)
    out *= env
    peak = np.abs(out).max() + 1e-9
    return (out / peak * rng.uniform(0.25, 0.6)).astype(np.float32)


class UnitPool:
    """Pre-rendered jittered variants of every char's syllable — makes
    corpus sampling ~50× faster than per-utterance harmonic synthesis
    (training was host-synthesis-bound at ~1.1 s/step)."""

    def __init__(self, variants: int = 24, seed: int = 1234, sr: int = SR):
        rng = np.random.default_rng(seed)
        self.sr = sr
        self.units = [
            [synth_char(i, rng, sr) for _ in range(variants)]
            for i in range(len(BOOT_CHARS))
        ]

    def utterance(self, text: str, rng: np.random.Generator,
                  noise_snr_db: float | None = None):
        """Same contract as synth_utterance, drawing units from the pool."""
        sr = self.sr
        pieces = [np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32)]
        cursor = len(pieces[0])
        ranges = []
        for i, ch in enumerate(text):
            idx = BOOT_CHARS.index(ch)
            variants = self.units[idx]
            unit = variants[int(rng.integers(len(variants)))]
            ranges.append((cursor / sr, (cursor + len(unit)) / sr))
            pieces.append(unit)
            cursor += len(unit)
            if i < len(text) - 1:
                gap = np.zeros(int(rng.uniform(0.02, 0.07) * sr), np.float32)
                pieces.append(gap)
                cursor += len(gap)
        pieces.append(np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32))
        audio = np.concatenate(pieces)
        if noise_snr_db is not None:
            noise = rng.standard_normal(len(audio)).astype(np.float32)
            sig_p = np.mean(audio ** 2) + 1e-12
            noise *= np.sqrt(sig_p / np.mean(noise ** 2)
                             * 10 ** (-noise_snr_db / 10))
            audio = audio + noise
        return audio.astype(np.float32), ranges


def synth_utterance(text: str, rng: np.random.Generator, sr: int = SR,
                    noise_snr_db: float | None = None):
    """Render `text` (chars from BOOT_CHARS) → (audio, char_ranges).

    char_ranges[i] = (start_s, end_s) of text[i] in the waveform."""
    pieces = [np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32)]
    cursor = len(pieces[0])
    ranges = []
    for i, ch in enumerate(text):
        idx = BOOT_CHARS.index(ch)
        unit = synth_char(idx, rng, sr)
        ranges.append((cursor / sr, (cursor + len(unit)) / sr))
        pieces.append(unit)
        cursor += len(unit)
        if i < len(text) - 1:
            gap = np.zeros(int(rng.uniform(0.02, 0.07) * sr), np.float32)
            pieces.append(gap)
            cursor += len(gap)
    pieces.append(np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32))
    audio = np.concatenate(pieces)
    if noise_snr_db is not None:
        noise = rng.standard_normal(len(audio)).astype(np.float32)
        sig_p = np.mean(audio ** 2) + 1e-12
        noise_p = np.mean(noise ** 2)
        noise *= np.sqrt(sig_p / noise_p * 10 ** (-noise_snr_db / 10))
        audio = audio + noise
    return audio.astype(np.float32), ranges


def random_text(rng: np.random.Generator, min_len: int = 2,
                max_len: int = 12) -> str:
    n = int(rng.integers(min_len, max_len + 1))
    return "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                   for _ in range(n))


def punctuate_by_rule(text: str) -> tuple[str, list]:
    """Deterministic punctuation rules for the punc bootstrap — the
    learnable ground truth. Returns (punctuated_text, classes) where
    classes[i] is the PUNC_LIST index following char i:
      - a '，' after every 4th char (except the last)
      - final char gets '？' if it is QUESTION_CHAR, else '。'
    """
    from ..models.punctuation import PUNC_LIST

    comma = PUNC_LIST.index("，")
    period = PUNC_LIST.index("。")
    question = PUNC_LIST.index("？")
    classes = []
    out = []
    for i, ch in enumerate(text):
        out.append(ch)
        if i == len(text) - 1:
            c = question if ch == QUESTION_CHAR else period
        elif (i + 1) % 4 == 0:
            c = comma
        else:
            c = 0
        classes.append(c)
        if c:
            out.append(PUNC_LIST[c])
    return "".join(out), classes


def cer(ref: str, hyp: str) -> float:
    """Character error rate (Levenshtein / len(ref))."""
    if not ref:
        return 0.0 if not hyp else 1.0
    d = np.arange(len(hyp) + 1, dtype=np.int32)
    for i, rc in enumerate(ref, 1):
        prev = d[0]
        d[0] = i
        for j, hc in enumerate(hyp, 1):
            cur = d[j]
            d[j] = min(d[j] + 1, d[j - 1] + 1, prev + (rc != hc))
            prev = cur
    return float(d[-1]) / len(ref)
