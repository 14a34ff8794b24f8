"""TargetASR: enrollment embeddings, cosine scoring, the target-speaker
ASR strategies and the batched separation of overlap clips.

Counterpart of targetdiarization_tpu/pipeline/target_asr.py. It composes
one AudioProcessor, one ASRProcessor and one SpeakerEngine. Entries have
the JAX package's schema: {"timerange": [s, e], "text", "score",
"sampling_rate", "audio"}. The strategies:
- `single_speaker_asr`: the clip's text, score 1;
- `target_speaker_asr`: VAD clips scored against the target embedding
  (one batched embedding pass), the matching ones transcribed each or
  merged;
- `target_speaker_separate_asr` / `multi_speakers_separate_asr`: the
  separator's two streams scored against the target; the better one (or
  both, target first) restored and transcribed;
- `batch_target_speaker_asr`, `target_speaker_duration` and the streaming
  helper `mix_audio_processor`.
`more_args` take the JAX package's keys ("vad_model", "asr_engine",
"preprocess", "prompt", "no_punc"); a cloud `asr_engine` transcribes
through `ASRProcessor.asr_detection_api`. The speaker engine is
ERes2NetV2 or CAM++, whichever the embedding checkpoint holds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.speaker import SpeakerEngine, cosine_similarity
from ..processors.asr import ASRProcessor
from ..processors.audio import AudioProcessor


class TargetASR:
    def __init__(self, audio_processor: AudioProcessor | None = None,
                 asr_processor: ASRProcessor | None = None,
                 speaker_engine: SpeakerEngine | None = None, embedding_model: str = "",
                 device: str | torch.device = "cuda", compute_dtype: str | None = None,
                 verbose_log: bool = False):
        """The speaker engine is `speaker_engine` or loaded from the
        `embedding_model` checkpoint; with neither, or a path that does not
        exist, the constructor raises (there is no random-weight engine)."""
        self.verbose_log = verbose_log
        self.ap = audio_processor or AudioProcessor(device=device, compute_dtype=compute_dtype,
                                                    verbose_log=verbose_log)
        self.asrp = asr_processor or ASRProcessor(device=device, compute_dtype=compute_dtype)
        if speaker_engine is not None:
            self.spk = speaker_engine
        elif embedding_model and os.path.isdir(embedding_model):
            self.spk = SpeakerEngine.from_pretrained(embedding_model, device=device,
                                                     compute_dtype=compute_dtype)
        else:
            raise FileNotFoundError(f"speaker embedding checkpoint {embedding_model!r} not found")
        self._fused_sep = None

    # ---------------- embeddings ----------------

    def input_audio_preprocess(self, audio):
        """A path, bytes, `io.BytesIO` or ndarray (taken as 16 kHz) ->
        (mono float32 at 16 kHz, 16000)."""
        if isinstance(audio, np.ndarray):
            audio_data, sr = audio.astype(np.float32), 16000
        else:
            audio_data, sr = self.ap.read_audio(audio)
        if audio_data.ndim > 1:
            audio_data = self.ap.audio_to_mono(audio_data)
        return self.ap.audio_resample(audio_data, sr, 16000)

    def get_speaker_embedding(self, wav_file, sampling_rate: int = 16000, **_) -> np.ndarray:
        if isinstance(wav_file, np.ndarray):
            audio = wav_file
        else:
            audio, sampling_rate = self.input_audio_preprocess(wav_file)
        return self.spk.get_speaker_embedding(audio, sr=sampling_rate)

    def get_target_embedding(self, target_audio, is_preprocess: bool = False,
                             output_embedding_list: bool = False, **_):
        """The enrollment embedding of one input, or the mean (or the list
        with output_embedding_list) over a list of inputs."""
        if isinstance(target_audio, list):
            embs = []
            for a in target_audio:
                audio, sr = self.input_audio_preprocess(a)
                embs.append(self._enroll_one(audio, sr, is_preprocess))
            embs = [e for e in embs if np.linalg.norm(e) > 0]
            if not embs:
                return np.zeros(192, np.float32)
            return embs if output_embedding_list else np.mean(embs, axis=0)
        audio, sr = self.input_audio_preprocess(target_audio)
        emb = self._enroll_one(audio, sr, is_preprocess)
        return [emb] if output_embedding_list else emb

    def _enroll_one(self, audio: np.ndarray, sr: int, is_preprocess: bool):
        if is_preprocess and self.ap.is_denoise_vocal:
            audio = self.ap.denoise_vocal(audio, sr)
        vad = self.asrp.vad_detection(audio, sr)
        return self.spk.get_target_embedding(audio, sr=sr, vad_segments=vad or None)

    def cosine_similarity(self, embedding_a, embedding_b) -> float:
        return cosine_similarity(embedding_a, embedding_b)

    def _best_similarity(self, emb, target_embedding) -> float:
        """The highest cosine to one enrollment or to any of a list (1.0
        for an empty list)."""
        if isinstance(target_embedding, list):
            if not target_embedding:
                return 1.0
            return max(cosine_similarity(emb, t) for t in target_embedding)
        return cosine_similarity(emb, target_embedding)

    def is_same_person(self, existed_embeddings, target_embedding, threshold: float = 0.4,
                       verbose_result: bool = False):
        if isinstance(existed_embeddings, np.ndarray):
            existed_embeddings = [existed_embeddings]
        score = cosine_similarity(np.mean(existed_embeddings, axis=0), target_embedding)
        if verbose_result:
            return {"is_same": bool(score >= threshold), "score": round(score, 3)}
        return bool(score >= threshold)

    # ---------------- strategies ----------------

    @staticmethod
    def _more(more_args: dict | None) -> dict:
        more = {"vad_model": "funasr", "asr_engine": None, "preprocess": [], "prompt": "",
                "no_punc": True}
        more.update(more_args or {})
        return more

    def _preprocess_chain(self, audio: np.ndarray, sr: int, steps: list) -> np.ndarray:
        if "vocal_denoise" in steps and self.ap.is_denoise_vocal:
            audio = self.ap.denoise_vocal(audio, sr)
        if "loudness_control" in steps:
            audio = self.ap.audio_loudness_control(audio, sr)
        return audio

    def _vad(self, audio: np.ndarray, sr: int, more: dict) -> list:
        if more.get("vad_model") == "none":
            return [[0.0, round(len(audio) / sr, 3)]]
        return self.asrp.vad_detection(audio, sr)

    def _asr_text(self, audio: np.ndarray, sr: int, more: dict) -> str:
        res = self.asrp.asr_detection(audio, sr, asr_engine=more.get("asr_engine"),
                                      prompt=more.get("prompt", ""),
                                      no_punc=more.get("no_punc", True))
        return res[0]["text"] if res else ""

    def _seed_embedding(self, audio, sr, vad, target_audio):
        """The target's embedding: of `target_audio`, or of the first VAD clip."""
        if target_audio is None:
            return self.spk.get_speaker_embedding(self.ap.split_audio_by_time(audio, sr, *vad[0]),
                                                  sr)
        t_audio, t_sr = self.input_audio_preprocess(target_audio)
        return self.spk.get_speaker_embedding(t_audio, t_sr)

    def single_speaker_asr(self, asr_audio, is_output_audio: bool = False,
                           more_args: dict | None = None) -> list:
        """The whole clip's text as one entry with score 1."""
        more = self._more(more_args)
        audio, sr = self.input_audio_preprocess(asr_audio)
        audio = self._preprocess_chain(audio, sr, more["preprocess"])
        text = self._asr_text(audio, sr, more)
        return [self._entry([0.0, round(len(audio) / sr, 2)], text, 1.0, sr,
                            audio if is_output_audio else None)]

    def target_speaker_asr(self, asr_audio, target_audio=None, target_embedding=None,
                           threshold: float = 0.4, audio_input_type: str = "merge",
                           is_output_audio: bool = False, more_args: dict | None = None) -> list:
        """The VAD clips (of at least 0.1 s) whose embedding scores at least
        `threshold` against the target, transcribed clip by clip
        ("separate") or joined into one utterance ("merge"). Without a
        target, the first clip's speaker (or `target_audio`'s enrollment)."""
        more = {"vad_model": "funasr", "asr_engine": None, "preprocess": [], "prompt": ""}
        more.update(more_args or {})
        audio, sr = self.input_audio_preprocess(asr_audio)
        audio = self._preprocess_chain(audio, sr, more["preprocess"])
        vad = self._vad(audio, sr, more)
        if not vad:
            return []
        if target_embedding is None:
            target_embedding = (self.get_target_embedding(target_audio) if target_audio is not None
                                else self._seed_embedding(audio, sr, vad, None))
        clips, ranges = [], []
        for s, e in vad:
            clip = self.ap.split_audio_by_time(audio, sr, s, e)
            if len(clip) < int(0.1 * sr):
                continue
            if "loudness_control" in more["preprocess"]:
                clip = self.ap.audio_loudness_control(clip, sr)
            clips.append(clip)
            ranges.append([s, e])
        if not clips:
            return []
        result, merged, merged_ranges = [], [], []
        for clip, rng, emb in zip(clips, ranges, self.spk.embed_batch(clips, sr=sr)):
            if np.isnan(emb).any():
                continue
            score = self._best_similarity(emb, target_embedding)
            if score < threshold:
                continue
            if audio_input_type == "separate":
                result.append(self._entry(rng, self._asr_text(clip, sr, more), score, sr,
                                          clip if is_output_audio else None))
            else:
                merged.append(clip)
                merged_ranges.append(rng)
        if audio_input_type == "merge" and merged:
            merged_audio = self.ap.combine_audio_chunks(merged)
            score = self._best_similarity(self.spk.get_speaker_embedding(merged_audio, sr),
                                          target_embedding)
            result.append(self._entry([merged_ranges[0][0], merged_ranges[-1][1]],
                                      self._asr_text(merged_audio, sr, more), score, sr,
                                      merged_audio if is_output_audio else None))
        return result

    def _separate_and_score(self, asr_audio, target_audio, target_embedding, threshold: float,
                            more_args: dict | None):
        """(audio, sr, vad, ((score, stream), (score, stream))) with the
        stream nearer the target first; None without speech or when both
        streams score below `threshold`."""
        more = self._more(more_args)
        audio, sr = self.input_audio_preprocess(asr_audio)
        audio = self._preprocess_chain(audio, sr, more["preprocess"])
        vad = self._vad(audio, sr, more)
        if not vad:
            return None
        if target_embedding is None:
            target_embedding = self._seed_embedding(audio, sr, vad, target_audio)
        spk1, spk2 = self.ap.separate_speaker(audio, sr)
        embs = self.spk.embed_batch([spk1, spk2], sr=sr)
        s1 = self._best_similarity(embs[0], target_embedding)
        s2 = self._best_similarity(embs[1], target_embedding)
        if s1 < threshold and s2 < threshold:
            return None
        scored = ((round(s1, 2), spk1), (round(s2, 2), spk2))
        return audio, sr, vad, scored if s1 >= s2 else scored[::-1]

    def target_speaker_separate_asr(self, asr_audio, target_audio=None, target_embedding=None,
                                    threshold: float = 0.4, is_output_asr: bool = True,
                                    is_output_audio: bool = True,
                                    more_args: dict | None = None) -> list:
        """The separated stream nearer the target, restored and transcribed,
        over the clip's speech range."""
        res = self._separate_and_score(asr_audio, target_audio, target_embedding, threshold,
                                       more_args)
        if res is None:
            return []
        _, sr, vad, ((score, best), _) = res
        if self.ap.is_restore_audio:
            best = self.ap.restore_audio(best, sr)
        text = self._asr_text(best, sr, self._more(more_args)) if is_output_asr else ""
        return [self._entry([vad[0][0], vad[-1][1]], text, score, sr,
                            best if is_output_audio else None)]

    def multi_speakers_separate_asr(self, asr_audio, target_audio=None, target_embedding=None,
                                    threshold: float = 0.4, is_output_asr: bool = True,
                                    is_output_audio: bool = True,
                                    more_args: dict | None = None) -> list:
        """Both separated streams, the target's first, each restored and,
        where its VAD (one batched pass over both) finds speech,
        transcribed over its speech range."""
        more = self._more(more_args)
        res = self._separate_and_score(asr_audio, target_audio, target_embedding, threshold,
                                       more_args)
        if res is None:
            return []
        _, sr, _, scored = res
        if self.ap.is_restore_audio:
            scored = tuple((score, self.ap.restore_audio(a, sr)) for score, a in scored)
        result = []
        for (score, out_audio), sub_vad in zip(
                scored, self.asrp.vad_detection_batch([a for _, a in scored], sr)):
            if not sub_vad:
                continue
            text = self._asr_text(out_audio, sr, more) if is_output_asr else ""
            result.append(self._entry([sub_vad[0][0], sub_vad[-1][1]], text, score, sr,
                                      out_audio if is_output_audio else None))
        return result

    def batch_target_speaker_asr(self, asr_audio_list: list, target_audio_list=None,
                                 prompt_list=None, threshold: float = 0.4,
                                 more_args: dict | None = None) -> list:
        """One enrollment (the mean over `target_audio_list`), many inputs:
        each input's target-speaker texts joined by spaces."""
        target_audio_list = target_audio_list or []
        if isinstance(target_audio_list, str):
            target_audio_list = [target_audio_list]
        prompt_list = prompt_list or []
        target_embedding = (self.get_target_embedding(target_audio_list)
                            if target_audio_list else None)
        texts = []
        for i, asr_audio in enumerate(asr_audio_list):
            more = dict(more_args or {})
            if len(prompt_list) == len(asr_audio_list):
                more["prompt"] = prompt_list[i]
            res = self.target_speaker_asr(asr_audio, target_embedding=target_embedding,
                                          threshold=threshold, more_args=more)
            texts.append(" ".join(r["text"] for r in res if r.get("text")).strip())
        return texts

    def target_speaker_duration(self, input_audio, target_embedding=None,
                                threshold: float = 0.4, more_args: dict | None = None) -> dict:
        """{"target_duration": VAD clips scoring in [threshold, 1),
        "others_duration": clips below threshold}."""
        more = self._more(more_args)
        audio, sr = self.input_audio_preprocess(input_audio)
        audio = self._preprocess_chain(audio, sr, more["preprocess"])
        result = {"target_duration": [], "others_duration": []}
        vad = self._vad(audio, sr, more)
        if not vad or target_embedding is None:
            return result
        clips = [self.ap.split_audio_by_time(audio, sr, s, e) for s, e in vad]
        keep = [i for i, c in enumerate(clips) if len(c) >= int(0.1 * sr)]
        for i, emb in zip(keep, self.spk.embed_batch([clips[i] for i in keep], sr=sr)):
            if np.isnan(emb).any():
                continue
            score = self._best_similarity(emb, target_embedding)
            if threshold <= score < 1.0:
                result["target_duration"].append(vad[i])
            elif score < threshold:
                result["others_duration"].append(vad[i])
        return result

    def mix_audio_processor(self, audio, target_embedding=None, similarity_threshold: float = 0.4,
                            loudness_threshold: float = -40.0) -> dict:
        """A chunk classified "noise", "single" or "multi" (by the
        diarizer's speakers, else by VAD) with the audio to keep: near
        silence for noise, the denoised chunk for one speaker, the stream
        nearer the target (if either reaches the threshold) for several."""
        audio_data, sr = self.input_audio_preprocess(audio)
        result = {"audio": audio_data, "sampling_rate": sr, "type": "noise", "score": 0.0}
        if len(audio_data) / sr >= 0.4:
            if self.ap.meter_loudness(audio_data, sr) <= loudness_threshold:
                return result
            audio_data = self.ap.denoise_vocal(audio_data, sr)
            audio_data = self.ap.audio_loudness_control(audio_data, sr)
        sd = {seg[2] for seg in self.asrp.speaker_diarization(audio_data, sr)["text"]}
        if not sd:
            speaker_type = "single" if self.asrp.vad_detection(audio_data, sr) else "noise"
        else:
            speaker_type = "single" if len(sd) == 1 else "multi"
        result["type"] = speaker_type
        if speaker_type == "noise":
            result["audio"] = np.full(len(audio_data), 1e-5, np.float32)
            return result
        if speaker_type == "single":
            result.update(audio=audio_data, score=1.0)
            return result
        if target_embedding is None:
            result.update(audio=audio_data, score=0.0)
            return result
        spk1, spk2 = self.ap.separate_speaker(audio_data, sr)
        embs = self.spk.embed_batch([spk1, spk2], sr=sr)
        s1 = cosine_similarity(embs[0], target_embedding)
        s2 = cosine_similarity(embs[1], target_embedding)
        result["score"] = round(max(s1, s2), 3)
        if s1 < similarity_threshold and s2 < similarity_threshold:
            result["audio"] = audio_data
        else:
            result["audio"] = spk1 if s1 >= s2 else spk2
        return result

    # ---------------- separation of overlap clips ----------------

    def multi_speakers_separate_batch(self, clips: list, target_embedding,
                                      threshold: float = 0.0, sr: int = 16000) -> list:
        """Both separated streams of each clip, the one nearer the target
        first, as entries without text (audio included); a clip whose
        streams both score below `threshold` gives [], a stream without
        speech no entry. Up to four clips of at most 10 s go through
        `FusedSeparation` in one device pass (restored there when the
        restorer runs at 16 kHz); otherwise the separator's batch, one
        embedding pass, one VAD pass and the restorer per stream."""
        fused_res = None
        if self.ap.separator is not None:
            fused_res = self._fused_separation().separate_score(clips, sr=sr)
        already_restored = False
        if fused_res is not None:
            already_restored = self._fused_separation().restorer is not None
            seps = [r["streams"] for r in fused_res]
            embs = [e for r in fused_res for e in r["embs"]]
            vads = [v for r in fused_res for v in r["vads"]]
        else:
            if self.ap.separator is None:  # the input twice, as separate_speaker gives
                seps = [np.stack([np.asarray(c, np.float32)] * 2) for c in clips]
            else:
                seps = self.ap.separator.separate_batch(clips, sr=sr)
            streams = [s for pair in seps for s in (pair[0], pair[1])]
            embs = self.spk.embed_batch(streams, sr=sr)
            vads = (self.asrp.vad_detection_batch(streams, sr) if self.asrp.vad is not None
                    else [[[0.0, len(s) / sr]] for s in streams])
        out = []
        for ci in range(len(clips)):
            s1, s2 = seps[ci][0], seps[ci][1]
            sc1 = self._best_similarity(embs[2 * ci], target_embedding)
            sc2 = self._best_similarity(embs[2 * ci + 1], target_embedding)
            if sc1 < threshold and sc2 < threshold:
                out.append([])
                continue
            first = ((round(sc1, 2), s1, vads[2 * ci]), (round(sc2, 2), s2, vads[2 * ci + 1]))
            ordered = first if sc1 >= sc2 else first[::-1]
            entries = []
            for score, audio, sub_vad in ordered:
                if not sub_vad:
                    continue
                if self.ap.is_restore_audio and not already_restored:
                    audio = self.ap.restore_audio(audio, sr)
                entries.append(self._entry([sub_vad[0][0], sub_vad[-1][1]], "", score, sr,
                                           audio))
            out.append(entries)
        return out

    def _fused_separation(self):
        """The FusedSeparation over the live engines, made at first use."""
        if self._fused_sep is None:
            from .fused import FusedSeparation

            self._fused_sep = FusedSeparation(sep=self.ap.separator, spk=self.spk,
                                              vad=self.asrp.vad, restorer=self.ap.restorer)
        return self._fused_sep

    @staticmethod
    def _entry(timerange, text, score, sr, audio) -> dict:
        return {"timerange": [round(float(timerange[0]), 3), round(float(timerange[1]), 3)],
                "text": text, "score": round(float(score), 2), "sampling_rate": sr,
                "audio": audio if audio is not None else np.array([], np.float32)}
