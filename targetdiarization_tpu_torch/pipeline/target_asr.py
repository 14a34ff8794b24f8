"""TargetASR: enrollment embeddings, cosine scoring and the batched
separation of overlap clips.

Counterpart of the parts of targetdiarization_tpu/pipeline/target_asr.py
that `TargetDiarization.infer` reaches. It composes one AudioProcessor,
one ASRProcessor and one SpeakerEngine. Entries have the JAX package's
schema: {"timerange": [s, e], "text", "score", "sampling_rate", "audio"}.
The other strategies (`target_speaker_asr`, `target_speaker_separate_asr`,
`multi_speakers_separate_asr`, `single_speaker_asr`, the batch API,
`target_speaker_duration`, `mix_audio_processor`) are not ported.
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
