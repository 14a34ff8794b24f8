"""ASRProcessor: VAD, the ASR engines, punctuation, timestamps, emotion, the
segmentation diarizer and F0.

Counterpart of targetdiarization_tpu/processors/asr.py::ASRProcessor.
The local engines (LOCAL_ENGINES) run on the device: "paraformer" and
"sensevoice" load `ASREngine` (the checkpoint's model picks Paraformer or
SenseVoice), the four whisper names `WhisperStyleEngine`. The cloud
engines (API_ENGINES) are the clients of `cloud_asr.py`, with the
credentials of `config_file` (`config.json`, one object per service:
"tencent", "gemini", "jzx", "xunfei"); with one of them the local
checkpoint, if given, still loads, for forced alignment and the rest.
Each engine is loaded from the checkpoint path it is given, or the
constructor raises; an empty path leaves the engine out:
`vad_detection` then returns the whole clip, `asr_detection` an empty
result, `punctuation_restore` the text unchanged, `emotion_detection`
no labels (or SenseVoice's emotion tag) and `speaker_diarization` no
segments. Unlike the JAX package, no path means no VAD: there is no
random-weight engine, and an engine name outside both lists raises. The
calls run inside the JAX package's trace spans (`asr/...`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.asr import EMOTIONS, ASREngine
from ..models.punctuation import PunctuationEngine
from ..models.vad import VADEngine
from ..models.whisper_style import WhisperStyleEngine
from ..runtime.trace import trace


def _load(engine_cls, path: str, what: str, device, compute_dtype):
    if not path:
        return None
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{what} checkpoint {path!r} not found")
    return engine_cls.from_pretrained(path, device=device, compute_dtype=compute_dtype)


def _pcm16(audio) -> bytes:
    return np.clip(np.asarray(audio) * 32768.0, -32768, 32767).astype(np.int16).tobytes()


class ASRProcessor:
    LOCAL_ENGINES = ("paraformer", "sensevoice", "whisper", "whisper_v2", "whisper_v3",
                     "whisper_finetune")
    API_ENGINES = ("tencent_api", "xunfei_api", "gemini_api", "jzx_api")

    def __init__(self, vad_model: str = "", asr_model: str = "", asr_engine: str = "paraformer",
                 punc_model: str = "", emotion_model: str = "", diarization_model: str = "",
                 config_file: str = "config.json", verbose_log: bool = False,
                 device: str | torch.device = "cuda", compute_dtype: str | None = None):
        if asr_engine not in self.LOCAL_ENGINES + self.API_ENGINES:
            raise ValueError(f"unknown ASR engine {asr_engine!r}; one of "
                             f"{self.LOCAL_ENGINES + self.API_ENGINES}")
        self.asr_engine = asr_engine
        self.verbose_log = verbose_log
        self.api_config = {}
        if os.path.exists(config_file):
            try:
                with open(config_file) as f:
                    self.api_config = json.load(f)
            except Exception as e:
                self._log(f"config.json unreadable: {e}")
        self.vad = _load(VADEngine, vad_model, "VAD", device, compute_dtype)
        engine_cls = WhisperStyleEngine if asr_engine.startswith("whisper") else ASREngine
        self.asr = _load(engine_cls, asr_model, "ASR", device, compute_dtype)
        self.punc = _load(PunctuationEngine, punc_model, "punctuation", device, compute_dtype)
        from ..models.diarization import SegmentationEngine
        from ..models.emotion import EmotionEngine

        self.emotion = _load(EmotionEngine, emotion_model, "emotion", device, compute_dtype)
        self.diarizer = _load(SegmentationEngine, diarization_model, "diarization", device,
                              compute_dtype)

    def _log(self, msg: str):
        if self.verbose_log:
            print(msg)

    # ---------------- VAD ----------------

    @property
    def is_vad(self) -> bool:
        return self.vad is not None

    def vad_detection(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                      max_end_silence_time: float | None = None, min_clip_sec: float = 0.0,
                      max_clip_sec: float = 0.0) -> list:
        """[[start_s, end_s], ...], with per-call silence and clip-length
        overrides; without a VAD, the whole clip."""
        if self.vad is None:
            return [[0.0, len(audio_data) / sampling_rate]]
        over = {"min_clip_sec": min_clip_sec, "max_clip_sec": max_clip_sec}
        if max_end_silence_time is not None:
            over["max_end_silence_time"] = max_end_silence_time
        with trace("asr/vad_detection"):
            return self.vad.vad_detection(audio_data, sr=sampling_rate, **over)

    def vad_detection_batch(self, clips: list, sampling_rate: int = 16000,
                            **vad_kwargs) -> list:
        """vad_detection for several clips in one forward."""
        if self.vad is None:
            return [[[0.0, len(c) / sampling_rate]] for c in clips]
        with trace("asr/vad_detection"):
            return self.vad.vad_detection_batch(clips, sr=sampling_rate, **vad_kwargs)

    def asr_vad_split(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                      **vad_kwargs) -> list:
        """[(start_s, end_s, clip_audio), ...]"""
        segs = self.vad_detection(audio_data, sampling_rate, **vad_kwargs)
        return [(s, e, audio_data[int(s * sampling_rate): int(e * sampling_rate)])
                for s, e in segs]

    # ---------------- ASR ----------------

    @property
    def is_asr(self) -> bool:
        return self.asr is not None

    def asr_detection(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                      asr_engine: str | None = None, prompt: str = "",
                      no_punc: bool = False, **_) -> list:
        """[{"text", "timestamp", ...}]: a cloud engine (`asr_engine`, or the
        processor's, in API_ENGINES) through `asr_detection_api` with
        `prompt` as its hot words or context; else the local engine (which
        ignores `prompt`, as in the JAX package), its text punctuated
        unless no_punc."""
        engine = asr_engine or self.asr_engine
        if engine in self.API_ENGINES:
            return self.asr_detection_api(audio_data, sampling_rate, engine, prompt)
        if self.asr is None:
            return [{"text": "", "timestamp": []}]
        with trace("asr/asr_detection"):
            res = self.asr.asr_detection(audio_data, sr=sampling_rate)
        if not no_punc and self.punc is not None and res and res[0]["text"]:
            res[0]["text"] = self.punctuation_restore(res[0]["text"])
        return res

    def asr_detection_batch(self, audios: list, sampling_rate: int = 16000,
                            no_punc: bool = False, **_) -> list:
        """asr_detection over several utterances with the local engine: one
        forward per sample rung, or one call each for an engine without a
        batch method (whisper)."""
        if self.asr is None:
            return [{"text": "", "timestamp": []} for _ in audios]
        with trace("asr/asr_detection"):
            if hasattr(self.asr, "asr_detection_batch"):
                results = self.asr.asr_detection_batch(audios, sr=sampling_rate)
            else:
                results = [self.asr.asr_detection(a, sr=sampling_rate)[0] for a in audios]
        if not no_punc and self.punc is not None:
            for r in results:
                if r["text"]:
                    r["text"] = self.punctuation_restore(r["text"])
        return results

    def asr_detection_api(self, audio_data: np.ndarray, sampling_rate: int, engine: str,
                          prompt: str = "", language: str = "auto", transport=None) -> list:
        """A cloud engine's [{"text", "timestamp", "language"}] (the
        language detected from the text unless given); a failure, missing
        credentials or an unknown service give an empty text with "error".
        `transport` replaces the client's (the tests' stub)."""
        from . import cloud_asr

        engine = engine.replace("_api", "").lower()
        creds = self.api_config.get(engine, {})
        if not creds:
            self._log(f"{engine}: no credentials in config.json")
            return [{"text": "", "timestamp": [], "error": "missing credentials"}]

        def lang_of(text):
            return language if language not in ("", "auto") else self.detect_language(text)

        try:
            if engine == "tencent":
                client = cloud_asr.TencentFlashASR(
                    appid=creds.get("appid", ""), secret_id=creds.get("secret_id", ""),
                    secret_key=creds.get("secret_key", ""), transport=transport)
                lang = "16k_zh" if language in ("", "auto") else f"16k_{language.lower()}"
                res = client.recognize(cloud_asr.wav_bytes(audio_data, sampling_rate),
                                       engine_type=lang,
                                       hotword_list=cloud_asr.format_hotwords(prompt))
                return [{"text": res["text"],
                         "timestamp": [[x["start_ms"], x["end_ms"]] for x in res["sentences"]],
                         "language": lang_of(res["text"])}]
            if engine == "gemini":
                client = cloud_asr.GeminiASR(
                    api_key=creds.get("api_key", ""), base_url=creds.get("base_url", ""),
                    model_id=creds.get("model_id", "gemini-2.5-flash"), transport=transport)
                asr_lang = {"zh": "zh-CN", "en": "en-US", "ja": "ja-JP"}.get(language, "zh-CN")
                text = client.get_result(
                    cloud_asr.wav_bytes(audio_data, sampling_rate),
                    audio_language="unknown" if language in ("", "auto") else asr_lang,
                    asr_language=asr_lang)
                return [{"text": text, "timestamp": [], "language": lang_of(text)}]
            if engine == "jzx":
                client = cloud_asr.JzxASR(endpoint=creds.get("endpoint", ""), transport=transport)
                res = client.recognize(_pcm16(audio_data), context=prompt)
                # (word, [start, end]) pairs, as the reference gives them
                return [{"text": res["text"], "timestamp": res["words"],
                         "language": lang_of(res["text"])}]
            if engine == "xunfei":
                client = cloud_asr.XunfeiIatASR(
                    appid=creds.get("appid", ""), api_key=creds.get("api_key", ""),
                    api_secret=creds.get("api_secret", ""), transport=transport)
                text = client.get_result(_pcm16(audio_data),
                                         language={"en": "en_us"}.get(language.lower(), "zh_cn"),
                                         hotword=prompt)
                return [{"text": text, "timestamp": [], "language": lang_of(text)}]
        except Exception as e:
            self._log(f"{engine} failed: {e}")
            return [{"text": "", "timestamp": [], "error": str(e)}]
        self._log(f"{engine}: unknown cloud ASR engine")
        return [{"text": "", "timestamp": [], "error": f"unknown engine {engine}"}]

    def detect_language(self, text: str = "", audio_data: np.ndarray | None = None,
                        sampling_rate: int = 16000) -> str:
        """SenseVoice's language tag of `audio_data` where the engine is
        SenseVoice; else "zh" when at least a quarter of the characters
        of `text` (and one) are CJK ideographs, "en" otherwise; "unknown"
        for no text."""
        if audio_data is not None and getattr(self.asr, "engine", "") == "sensevoice":
            res = self.asr.asr_detection(audio_data, sr=sampling_rate)[0]
            if res.get("language"):
                return res["language"]
        if text:
            cjk = sum(1 for ch in text if "\u4e00" <= ch <= "\u9fff")
            return "zh" if cjk >= max(1, len(text) // 4) else "en"
        return "unknown"

    # ---------------- punctuation ----------------

    @property
    def is_punc(self) -> bool:
        return self.punc is not None

    def punctuation_restore(self, text: str) -> str:
        if self.punc is None or not text:
            return text
        with trace("asr/punctuation"):
            return self.punc.punctuation_restore(text)

    def punctuation_restore_batch(self, texts: list) -> list:
        """punctuation_restore over many texts in one forward."""
        if self.punc is None:
            return list(texts)
        todo = [t for t in texts if t]
        if not todo:
            return list(texts)
        with trace("asr/punctuation"):
            done = iter(self.punc.punctuation_restore_batch(todo))
        return [next(done) if t else t for t in texts]

    def timestamp_prediction(self, audio_data: np.ndarray, text: str,
                             sampling_rate: int = 16000) -> list:
        """[start_ms, end_ms] per character of `text`. With the Paraformer,
        CIF forced alignment to the count of non-space characters, taken
        when it gives that many; otherwise (SenseVoice, whisper, no engine)
        the VAD's speech (or the whole clip) split evenly over every
        character of `text`, spaces included, as the JAX package does."""
        if not text:
            return []
        chars = [c for c in text if not c.isspace()]
        if getattr(self.asr, "engine", "") == "paraformer" and chars:
            ts = self.asr.force_align(audio_data, len(chars), sr=sampling_rate)
            if len(ts) == len(chars):
                return ts
        segs = self.vad_detection(audio_data, sampling_rate)
        if not segs:
            segs = [[0.0, len(audio_data) / sampling_rate]]
        per_char = sum(e - s for s, e in segs) / len(text)
        out = []
        seg_iter = iter(segs)
        seg = next(seg_iter)
        pos = seg[0]
        for _ in text:
            start = pos
            remain = per_char
            while remain > 0 and seg is not None:
                avail = seg[1] - pos
                if avail >= remain:
                    pos += remain
                    remain = 0
                else:
                    remain -= avail
                    seg = next(seg_iter, None)
                    pos = seg[0] if seg else pos
            out.append([int(start * 1000), int(pos * 1000)])
        return out

    # ---------------- emotion ----------------

    def emotion_detection(self, audio_data: np.ndarray, sampling_rate: int = 16000) -> dict:
        """{"labels", "scores"} of the emotion engine; without one, from
        SenseVoice's emotion tag (score 1 for it, 0 for the others); else no
        labels."""
        if self.emotion is not None:
            return self.emotion.emotion_detection(audio_data, sr=sampling_rate)
        if getattr(self.asr, "engine", "") == "sensevoice":
            emo = self.asr.asr_detection(audio_data, sr=sampling_rate)[0].get("emotion", "UNKNOWN")
            return {"labels": list(EMOTIONS), "scores": [float(e == emo) for e in EMOTIONS]}
        return {"labels": [], "scores": []}

    # ---------------- diarization ----------------

    def speaker_diarization(self, audio_data: np.ndarray, sampling_rate: int = 16000) -> dict:
        """{"text": [[start, end, spk], ...]} by start, from the segmentation
        diarizer; no segments without one."""
        if self.diarizer is None:
            return {"text": []}
        sd = self.diarizer.diarize(audio_data, sr=sampling_rate)
        return {"text": sorted(([s, e, int(spk)] for spk, ranges in sd.items()
                                for s, e in ranges), key=lambda x: x[0])}

    # ---------------- F0 ----------------

    def f0_compute(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                   fmin: float = 65.0, fmax: float = 400.0) -> np.ndarray:
        """F0 in Hz per 10 ms hop of 40 ms frames by normalized
        autocorrelation (0 where the frame is silent or the peak is at most
        0.3), on the host."""
        a = np.asarray(audio_data, np.float32)
        frame, hop = int(0.04 * sampling_rate), int(0.01 * sampling_rate)
        if len(a) < frame:
            return np.zeros(0, np.float32)
        n = 1 + (len(a) - frame) // hop
        lag_min = int(sampling_rate / fmax)
        lag_max = min(int(sampling_rate / fmin), frame - 1)
        out = np.zeros(n, np.float32)
        for i in range(n):
            w = a[i * hop: i * hop + frame]
            w = w - w.mean()
            ac = np.correlate(w, w, "full")[frame - 1:]
            if ac[0] <= 1e-9:
                continue
            ac = ac / ac[0]
            seg = ac[lag_min:lag_max]
            if seg.size == 0:
                continue
            peak = int(np.argmax(seg)) + lag_min
            if ac[peak] > 0.3:
                out[i] = sampling_rate / peak
        return out
