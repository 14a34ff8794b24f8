"""TargetDiarization: the offline pipeline, `infer` end to end.

Counterpart of targetdiarization_tpu/pipeline/offline.py:

    infer(wav, target) -> (target_spk,
                           [{"speaker", "timerange", "text", "type", "score"}, ...],
                           target_audio | None)

`FusedFrontend.analyze` preprocesses and analyses the audio in one device
pass, `enroll` embeds the target (cached by content). Below 30 s the
segmentation engine diarizes and its clean pieces are re-clustered by
speaker embedding (average-linkage AHC, `models/clustering.py`); at 30 s
and above `ClusterDiarizer` clusters the sliding-window embeddings. The
target's overlap clips are separated (`FusedSeparation`, with Apollo in the
same pass), and each speaker's track is transcribed: by `FusedASR` on the
analysed device buffer when the engine is a Paraformer and no clip was
separated, else by the batched ASR and punctuation of the ASR processor
(SenseVoice, whisper: one entry a speaker, with no timestamps to slice).

Unlike the JAX package, an error in a fused program or an engine
propagates: there is no per-engine fallback that hides it. The JAX
package's branches stay: the windowed separation for long or many
clips, the batched ASR when a clip was separated, the diarizer's own pass
when there are no window embeddings. The pipeline needs the VAD and the
speaker engines (the front end runs on them).

`audio_preprocess` is the per-engine chain the streaming pipeline runs on
each flushed buffer (mono, 16 kHz, loudness, the separator's louder stream
or the denoiser, loudness); unlike the JAX package it lets an error
through. `prewarm` loads the kernels' library and runs one pass of each
device program an `n_samples`-long request reaches, so that the library,
the cuBLAS and cuDNN handles and the tables exist before the first request.
"""

from __future__ import annotations

import hashlib
import io
import math
import os
from typing import Union

import numpy as np

from ..models.clustering import agglomerative_cosine_average
from ..models.diarization import ClusterDiarizer, DiarizeConfig, activations_to_diarization
from ..models.punctuation import PUNC_LIST
from ..models.vad import VADConfig, segment_probs
from ..runtime.trace import trace
from . import intervals as iv
from .fused import FusedASR, FusedFrontend
from .target_asr import TargetASR


class TargetDiarization:
    def __init__(self, target_asr: TargetASR, cluster_diarizer=None, segmentation_engine=None,
                 asr_engine: str = "paraformer", target_similarity_threshold: float = 0.0,
                 long_audio_threshold: float = 30.0, pyannote_clustering_threshold: float = 0.0,
                 verbose_log: bool = False):
        self.verbose_log = verbose_log
        self.asr_engine = asr_engine
        self.target_similarity_threshold = target_similarity_threshold
        self.long_audio_threshold = long_audio_threshold
        # cosine distance of the re-clustering after segmentation
        self.recluster_threshold = pyannote_clustering_threshold or 0.6
        self.tasr = target_asr
        self.ap = target_asr.ap
        if cluster_diarizer is None:
            cfg = DiarizeConfig()
            if pyannote_clustering_threshold:
                cfg.clustering_threshold = pyannote_clustering_threshold
            cluster_diarizer = ClusterDiarizer(target_asr.spk, vad_engine=target_asr.asrp.vad,
                                               cfg=cfg)
        self.sd_pipeline = cluster_diarizer
        self.od_pipeline = segmentation_engine
        self.fused = FusedFrontend(denoiser=self.ap.denoiser, vad=target_asr.asrp.vad,
                                   seg=segmentation_engine, spk=target_asr.spk)
        # FusedASR runs wherever the local engine is a Paraformer, whatever
        # `asr_engine` names, as in the JAX package
        self.fused_asr = FusedASR(target_asr.asrp.asr, target_asr.asrp.punc) \
            if getattr(target_asr.asrp.asr, "engine", "") == "paraformer" else None
        self._enroll_cache: dict = {}

    def _log(self, *args):
        if self.verbose_log:
            print(*args)

    # ---------------- interval algebra ----------------

    calc_single_iou = staticmethod(iv.calc_single_iou)
    calc_multi_iou = staticmethod(iv.calc_multi_iou)
    calc_iou_score = staticmethod(iv.calc_iou_score)
    sd_key_matcher = staticmethod(iv.sd_key_matcher)
    merge_timeranges = staticmethod(iv.merge_timeranges)
    subtract_timeranges = staticmethod(iv.subtract_timeranges)
    apply_od_result = staticmethod(iv.apply_od_result)
    subtract_overlap = staticmethod(iv.subtract_overlap)
    get_speaker_num = staticmethod(iv.get_speaker_num)
    get_speaker_overlap = staticmethod(iv.get_speaker_overlap)

    # ---------------- parsers ----------------

    def sd_result_parser(self, sd_result: dict, is_single: bool = False,
                         combine_timerange: bool = False) -> dict:
        """{"text": [[s, e, spk], ...]} -> {spk: [(s, e), ...]}."""
        if not sd_result or not sd_result.get("text"):
            return {}
        return iv.parse_segments(sd_result["text"], is_single=is_single,
                                 combine=combine_timerange)

    def od_result_parser(self, od_result: dict, sd_result: dict | None = None,
                         is_single: bool = False, output_overlap: bool = True):
        """A segmentation diarization, its keys matched onto sd_result's,
        reduced to the pairwise overlaps."""
        if not od_result:
            return {}
        result = od_result
        if is_single:
            merged = [r for ranges in od_result.values() for r in ranges]
            result = {"0": iv.merge_timeranges(merged)}
        if sd_result:
            result = iv.sd_key_matcher(sd_result, result)
        if output_overlap:
            result = iv.get_speaker_overlap(result)
        return result

    # ---------------- target selection ----------------

    def sd_result_to_target_embedding(self, audio_data, sampling_rate=16000, sd_result=None,
                                      overlap_map=None, target_spk: str = "", fr=None):
        """The longest speaker as the target, with the mean embedding of its
        windows (or clips) outside the overlaps."""
        sd_result = sd_result or {}
        if not sd_result:
            return "", self.tasr.get_target_embedding(audio_data)
        if not target_spk or target_spk not in sd_result:
            target_spk = max(sd_result, key=lambda s: iv.total_duration(sd_result[s])) \
                if len(sd_result) > 1 else list(sd_result)[0]
        work = iv.subtract_overlap(sd_result, overlap_map) if overlap_map else sd_result
        ranges = [(s, e) for s, e in work.get(target_spk, []) if (e - s) >= 0.4]
        if fr is not None and fr.get("win_embs") is not None and ranges:
            embs = self._window_embs_in_ranges(fr, ranges)
            if len(embs):
                return target_spk, np.mean(embs, axis=0)
        clips = [self.ap.split_audio_by_time(audio_data, sampling_rate, s, e) for s, e in ranges]
        target = np.concatenate(clips, axis=0) if clips else audio_data
        return target_spk, self.tasr.get_target_embedding(target)

    @staticmethod
    def _window_embs_in_ranges(fr, ranges) -> np.ndarray:
        """The front end's window embeddings (non-zero) whose midpoint lies
        in one of `ranges`."""
        out = []
        for (s, e), emb in zip(fr["win_times"], fr["win_embs"]):
            mid = (s + e) / 2.0
            if np.linalg.norm(emb) == 0:
                continue
            if any(rs <= mid <= re for rs, re in ranges):
                out.append(emb)
        return np.asarray(out) if out else np.zeros((0, 192), np.float32)

    def target_embedding_to_target_spk(self, target_embedding, audio_data, sampling_rate=16000,
                                       sd_result=None, overlap_map=None, fr=None) -> str:
        """The speaker whose windows (or, without any, clips) outside the
        overlaps have the highest mean cosine to the enrollment."""
        sd_result = sd_result or {}
        if not sd_result:
            return ""
        work = iv.subtract_overlap(sd_result, overlap_map or [])
        score_map, pending = [], []
        for spk, ranges in work.items():
            if fr is not None and fr.get("win_embs") is not None:
                embs = self._window_embs_in_ranges(fr, ranges)
                if len(embs):
                    scores = [self.tasr.cosine_similarity(target_embedding, e) for e in embs]
                    score_map.append([spk, sum(scores) / len(scores)])
                    continue
            pending.append((spk, ranges))
        for spk, ranges in pending:
            clips = [self.ap.split_audio_by_time(audio_data, sampling_rate, s, e)
                     for s, e in ranges]
            clips = [c for c in clips if c.size]
            if not clips:
                continue
            embs = self.tasr.spk.embed_batch(clips, sr=sampling_rate, single_dispatch=True)
            scores = [self.tasr.cosine_similarity(target_embedding, e) for e in embs
                      if np.linalg.norm(e) > 0]
            if scores:
                score_map.append([spk, sum(scores) / len(scores)])
        if not score_map:
            return ""
        score_map.sort(key=lambda x: x[1], reverse=True)
        return score_map[0][0]

    def recheck_target_speaker(self, result: list, target_spk: str, target_embedding,
                               method: str = "recheck_target") -> list:
        """Scores every entry -1; with a threshold, re-scores the target's
        (or the others') entries by cosine and moves them to or from the
        target ("-1")."""
        if not result:
            return []
        for item in result:
            item["score"] = -1.0
        if target_embedding is None or not self.target_similarity_threshold:
            return result
        idxs, audios = [], []
        for i, item in enumerate(result):
            if method == "recheck_target" and item["speaker"] != target_spk:
                continue
            if method == "recheck_others" and item["speaker"] == target_spk:
                continue
            if item.get("audio") is None:
                continue
            idxs.append(i)
            audios.append(item["audio"])
        if not audios:
            return result
        for i, emb in zip(idxs, self.tasr.spk.embed_batch(audios)):
            score = self.tasr.cosine_similarity(target_embedding, emb)
            result[i]["score"] = round(score, 3)
            if score >= self.target_similarity_threshold:
                result[i]["speaker"] = target_spk
            elif result[i]["speaker"] == target_spk:
                result[i]["speaker"] = "-1"
        return result

    # ---------------- ASR assembly ----------------

    def sd_result_to_asr_audio(self, audio_data, sampling_rate=16000, sd_result=None,
                               overlap_map=None, target_spk: str = "", target_embedding=None,
                               fr=None) -> list:
        """Per-speaker clips (the target's overlaps separated), one ASR per
        speaker over its silence-padded track, and the characters sliced
        back onto each clip by their timestamps, then punctuated."""
        sd_result = sd_result or {}
        overlap_map = overlap_map or []
        asr_result: list = []
        if not sd_result:
            return asr_result
        if overlap_map:
            singles = iv.subtract_overlap(sd_result, overlap_map)
            overlaps = iv.subtract_overlap(sd_result, overlap_map, reverse_output=True)
        else:
            singles, overlaps = sd_result, {}

        def clip(s, e):
            return self.ap.split_audio_by_time(audio_data, sampling_rate, s, e)

        for spk, ranges in singles.items():
            for s, e in ranges:
                asr_result.append({"speaker": spk, "timerange": [s, e], "text": "",
                                   "type": "single", "audio": clip(s, e)})
        if not target_spk or target_embedding is None:
            for spk, ranges in overlaps.items():
                for s, e in ranges:
                    asr_result.append({"speaker": spk, "timerange": [s, e], "text": "",
                                       "type": "overlap", "audio": clip(s, e)})
        else:
            noise_spks = sorted(set(sd_result) - {target_spk})
            tasks = [(spk, s, e) for spk, ranges in overlaps.items() if spk not in noise_spks
                     for s, e in ranges]
            clips = [clip(s, e) for _, s, e in tasks]
            seps = self.tasr.multi_speakers_separate_batch(
                clips, target_embedding, threshold=0.0, sr=sampling_rate) if clips else []
            for (spk, s, e), sep in zip(tasks, seps):
                if not sep:
                    continue
                t_audio = self.ap.audio_loudness_control(sep[0]["audio"], sampling_rate)
                t_range = [round(s + sep[0]["timerange"][0], 3),
                           round(s + sep[0]["timerange"][1], 3)]
                asr_result.append({"speaker": spk, "timerange": t_range, "text": "",
                                   "type": "overlap", "audio": t_audio, "_sep": True})
                if noise_spks and len(sep) > 1:
                    n_range = [round(s + sep[1]["timerange"][0], 3),
                               round(s + sep[1]["timerange"][1], 3)]
                    asr_result.append({"speaker": noise_spks[0], "timerange": n_range,
                                       "text": "", "type": "overlap",
                                       "audio": sep[1]["audio"], "_sep": True})
        if not asr_result:
            return asr_result
        asr_result.sort(key=lambda x: x["timerange"][0])

        speakers = sorted({item["speaker"] for item in asr_result})
        combined_map = {spk: self.combine_audio_chunks(asr_result, spk, sampling_rate)
                        for spk in speakers}
        speakers = [s for s in speakers if combined_map[s] is not None]
        asr_results = None
        punc_in_graph = False
        spk_ranges = [[item["timerange"] for item in asr_result if item["speaker"] == spk]
                      for spk in speakers]
        if (self.fused_asr is not None and fr is not None
                and fr.get("audio_dev_i16") is not None
                and not any(item.get("_sep") for item in asr_result)
                and len(speakers) <= 8 and all(len(r) <= 32 for r in spk_ranges)):
            asr_results = self.fused_asr.transcribe_masked(fr["audio_dev_i16"],
                                                           fr["n_samples"], spk_ranges)
            punc_in_graph = all(r.get("punc_cls") is not None for r in asr_results)
        if asr_results is None:  # one batched ASR pass over the combined tracks
            asr_results = self.tasr.asrp.asr_detection_batch(
                [combined_map[s] for s in speakers], sampling_rate, no_punc=True)

        new_result = []
        for spk, asr in zip(speakers, asr_results):
            timestamps = asr.get("timestamp") or []
            if not timestamps:
                entry = {"speaker": spk,
                         "timerange": [asr_result[0]["timerange"][0],
                                       asr_result[-1]["timerange"][1]],
                         "text": asr["text"].strip(), "type": "single",
                         "audio": combined_map[spk]}
                if punc_in_graph and asr.get("punc_cls"):
                    entry.update(_chars=list(asr["text"]), _cls=asr["punc_cls"], _joiner="")
                new_result.append(entry)
                continue
            lang = asr.get("language") or self.tasr.asrp.detect_language(asr["text"])
            chars = list(asr["text"])
            pcls = asr.get("punc_cls") if punc_in_graph else None
            joiner = "" if lang in ("zh", "ja", "ko", "yue") else " "
            for item in asr_result:
                if item["speaker"] != spk:
                    continue
                lo = math.floor(item["timerange"][0] * 10) / 10 * 1000
                hi = math.ceil(item["timerange"][1] * 10) / 10 * 1000
                idxs = [i for i, (ts, te) in enumerate(timestamps)
                        if i < len(chars) and lo <= ts <= hi]
                item["text"] = joiner.join(chars[i] for i in idxs).strip()
                if pcls is not None:
                    item.update(_chars=[chars[i] for i in idxs],
                                _cls=[pcls[i] if i < len(pcls) else 0 for i in idxs],
                                _joiner=joiner)
                new_result.append(item)

        if punc_in_graph:  # the program's classes, applied token by token
            for item in new_result:
                chars = item.pop("_chars", None)
                cls = item.pop("_cls", None)
                joiner = item.pop("_joiner", "")
                if not item["text"] or not chars:
                    continue
                text = joiner.join(ch + PUNC_LIST[int(c)] for ch, c in zip(chars, cls)).strip()
                if text and text[-1] not in "。？！.!?":
                    text += "。"
                item["text"] = text
        else:  # one punctuation pass over every segment's text
            restored = self.tasr.asrp.punctuation_restore_batch(
                [item["text"] for item in new_result])
            for item, text in zip(new_result, restored):
                item["text"] = text
        for item in new_result:
            for key in ("_sep", "_chars", "_cls", "_joiner"):
                item.pop(key, None)
        new_result.sort(key=lambda x: x["timerange"][0])
        return new_result

    @staticmethod
    def combine_audio_chunks(asr_result: list, speaker: str, sampling_rate: int = 16000):
        """One speaker's clips on a silence-padded timeline; None without any."""
        pieces = []
        cursor = 0.0
        for item in asr_result:
            if item["speaker"] != speaker:
                continue
            if cursor < item["timerange"][0]:
                pieces.append(np.zeros(int((item["timerange"][0] - cursor) * sampling_rate),
                                       np.float32))
            pieces.append(np.asarray(item["audio"], np.float32))
            cursor = item["timerange"][1]
        return np.concatenate(pieces, axis=0) if pieces else None

    def asr_audio_parser(self, asr_result: list, target_spk: str,
                         output_target_audio: bool = True):
        """(entries without audio, the target's silence-padded track or None)."""
        result = []
        if not asr_result:
            return result, None
        if isinstance(asr_result, dict):
            asr_result = [asr_result]
        if not output_target_audio:
            for item in asr_result:
                item.pop("audio", None)
                result.append(item)
            return result, None
        sr = 16000
        asr_result.sort(key=lambda x: x["timerange"][0])
        pieces = []
        cursor = 0.0
        for item in asr_result:
            if item["speaker"] == target_spk:
                gap = int((item["timerange"][0] - cursor) * sr)
                if gap > 0:
                    pieces.append(np.zeros(gap, np.float32))
                clip = item.get("audio")
                if clip is None:
                    clip = np.zeros(int((item["timerange"][1] - item["timerange"][0]) * sr),
                                    np.float32)
                pieces.append(np.asarray(clip, np.float32))
                cursor = item["timerange"][1]
            item.pop("audio", None)
            result.append(item)
        if cursor < asr_result[-1]["timerange"][1]:
            pieces.append(np.zeros(int((asr_result[-1]["timerange"][1] - cursor) * sr),
                                   np.float32))
        return result, (np.concatenate(pieces) if pieces else None)

    # ---------------- preprocessing ----------------

    def audio_preprocess(self, audio_data: np.ndarray, sampling_rate: int = 16000,
                         stream_mode: bool = False, output_audio_only: bool = False):
        """mono -> float32 -> 16 kHz -> loudness -> the separator's louder
        stream (`stream_mode`) or the denoiser -> loudness; the audio, or
        (audio, 16000)."""
        audio_data = self.ap.int16_to_float32(self.ap.audio_to_mono(np.asarray(audio_data)))
        audio_data, sampling_rate = self.ap.audio_resample(audio_data, sampling_rate, 16000)
        audio_data = self.ap.audio_loudness_control(audio_data, sampling_rate)
        if stream_mode:
            audio_data = self.ap.separate_speaker(audio_data, sampling_rate)[0]
        else:
            audio_data = self.ap.denoise_vocal(audio_data, sampling_rate)
        audio_data = self.ap.audio_loudness_control(audio_data, sampling_rate)
        if output_audio_only:
            return audio_data
        return audio_data, sampling_rate

    def prewarm(self, n_samples: int, target_samples: int = 0, n_spk: int = 2) -> float:
        """Loads the kernels' library (built first if needed) and runs one
        pass of the front end at `n_samples`, the enrollment at
        `target_samples` (if given), `FusedASR` for `n_spk` speakers and
        `FusedSeparation` on a 1 s clip, on silence. Returns the seconds
        it took."""
        import time

        import torch

        from .fused import _LADDER

        t0 = time.perf_counter()
        if self.fused.device.type == "cuda":
            from ..ops.kernels._build import load_library

            load_library()
        n = max(int(n_samples), 1600)
        self.fused.analyze(np.zeros(n, np.float32))
        if target_samples:
            self.fused.enroll(np.zeros(max(int(target_samples), 1600), np.float32))
        if self.fused_asr is not None:
            bucket = _LADDER.bucket(min(n, _LADDER.rungs[-1]))
            self.fused_asr.transcribe_masked(
                torch.zeros(bucket, dtype=torch.int16, device=self.fused_asr.device), bucket,
                [[(0.0, 0.5)]] * n_spk)
        if self.ap.separator is not None:
            self.tasr._fused_separation().separate_score([np.zeros(16000, np.float32)])
        return time.perf_counter() - t0

    # ---------------- main entry ----------------

    def infer(self, wav_file: Union[str, np.ndarray, io.BytesIO],
              target_file: Union[str, np.ndarray, io.BytesIO, None] = None,
              sampling_rate: int = 16000, is_single: bool = False,
              output_target_audio: bool = True):
        """(target_spk, results, target_audio) of one recording; an ndarray
        is taken at `sampling_rate`, a path or URL is read by
        `AudioProcessor.read_audio` (PCM WAV, or any format through ffmpeg)
        and an `io.BytesIO` as PCM WAV."""
        if isinstance(wav_file, (str, io.BytesIO)):
            audio_data, sampling_rate = self.ap.read_audio(wav_file)
        else:
            audio_data = np.asarray(wav_file)
        with trace("infer/preprocess"):
            fr = self.fused.analyze(self.ap.audio_to_mono(audio_data), sr=sampling_rate)
            audio_data, sampling_rate = fr["audio"], 16000

        target_embedding = None
        if target_file is not None:
            with trace("infer/target_enroll"):
                target_embedding = self._enroll_target(target_file, sampling_rate)

        duration = len(audio_data) / sampling_rate
        sd_result = None
        seg_sd = None
        if duration >= self.long_audio_threshold or self.od_pipeline is None:
            with trace("infer/diarize_cluster"):
                raw = {"text": self._cluster_segments(audio_data, sampling_rate, fr=fr)}
            sd_result = self.sd_result_parser(raw, is_single=is_single)
        if not sd_result and self.od_pipeline is not None:
            with trace("infer/diarize_segmentation"):
                seg_sd = self._segmentation_sd(audio_data, sampling_rate, fr)
            if is_single:
                # the whole clip to the ASR up to 30 s, the merged spans above
                if duration <= 30.0:
                    sd_result = {"0": [(0.0, round(duration, 3))]}
                else:
                    merged = [r for ranges in seg_sd.values() for r in ranges]
                    sd_result = {"0": iv.merge_timeranges(merged)} if merged else {}
            else:
                with trace("infer/recluster"):
                    sd_result = self._recluster_sd(audio_data, sampling_rate, seg_sd)
                if sd_result is not seg_sd:
                    # the re-clustered labels hold each overlap under both voices
                    seg_sd = sd_result
        sd_result = sd_result or {}
        self._log("sd_result:", sd_result)

        overlap_map = []
        target_spk = ""
        if not is_single:
            od_result = {}
            if self.od_pipeline is not None:
                if seg_sd is None:
                    seg_sd = self._segmentation_sd(audio_data, sampling_rate, fr)
                od_result = self.od_result_parser(seg_sd, sd_result=sd_result)
            sd_result, overlap_map = iv.apply_od_result(sd_result, od_result)
            self._log("refined sd_result:", sd_result, "overlap_map:", overlap_map)
            with trace("infer/target_id"):
                if target_embedding is not None:
                    target_spk = self.target_embedding_to_target_spk(
                        target_embedding, audio_data, sampling_rate, sd_result, overlap_map,
                        fr=fr)
                else:
                    target_spk, target_embedding = self.sd_result_to_target_embedding(
                        audio_data, sampling_rate, sd_result, overlap_map, fr=fr)
            self._log("target_spk:", target_spk)

        with trace("infer/asr_assembly"):
            asr_result = self.sd_result_to_asr_audio(audio_data, sampling_rate, sd_result,
                                                     overlap_map, target_spk, target_embedding,
                                                     fr=fr)
        with trace("infer/recheck"):
            asr_result = self.recheck_target_speaker(asr_result, target_spk, target_embedding)
        asr_result, target_audio = self.asr_audio_parser(asr_result, target_spk,
                                                         output_target_audio)
        return target_spk, asr_result, target_audio

    def _cluster_segments(self, audio_data, sampling_rate, fr=None) -> list:
        sd = None
        if fr is not None and fr.get("win_embs") is not None \
                and hasattr(self.sd_pipeline, "diarize_from_windows"):
            wins, embs = self._speech_windows(fr)
            if wins:
                sd = self.sd_pipeline.diarize_from_windows(wins, embs)
        if sd is None:
            sd = self.sd_pipeline.diarize(audio_data, sr=sampling_rate)
        segments = sorted(([s, e, int(spk)] for spk, ranges in sd.items() for s, e in ranges),
                          key=lambda x: x[0])
        if not segments:
            raise RuntimeError("cluster diarizer produced no segments")
        return segments

    def _recluster_sd(self, audio_data, sampling_rate, seg_sd: dict) -> dict:
        """Global speaker labels over the segmentation's local channels:
        clean pieces (one channel active, at least 0.1 s) of 0.3 s or more
        are embedded in one pass and clustered (average-linkage AHC on
        cosine distance below `recluster_threshold`), shorter pieces take
        the label of the nearest clustered piece, and each overlap span
        goes under the clusters of the clean pieces on either side of it.
        Labels are renumbered by first appearance."""
        channels = {k: iv.merge_timeranges(v) for k, v in seg_sd.items()}
        if len([r for rs in channels.values() for r in rs]) < 2:
            return seg_sd
        pair_map = iv.get_speaker_overlap(channels, min_overlap_sec=0.2)
        overlap_spans = iv.merge_timeranges([r for rs in pair_map.values() for r in rs])
        clean = sorted((s, e) for ranges in channels.values()
                       for s, e in iv.subtract_timeranges(ranges, overlap_spans)
                       if e - s >= 0.1)
        if not clean:
            return seg_sd
        big = [i for i, (s, e) in enumerate(clean) if e - s >= 0.3]
        if len(big) >= 2:
            embs = np.asarray(self.tasr.spk.embed_batch(
                [self.ap.split_audio_by_time(audio_data, sampling_rate, *clean[i]) for i in big],
                sr=sampling_rate))
            embs = embs / np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True), 1e-9)
            labels = agglomerative_cosine_average(embs,
                                                  distance_threshold=self.recluster_threshold)
        elif len(big) == 1:
            labels = [0]
        else:
            return seg_sd
        cluster = dict(zip(big, (int(x) for x in labels)))
        for i, (s, e) in enumerate(clean):  # short pieces: the nearest clustered piece's
            if i not in cluster:
                mid = (s + e) / 2
                j = min(big, key=lambda k: abs((clean[k][0] + clean[k][1]) / 2 - mid))
                cluster[i] = cluster[j]
        out: dict = {}
        for i, (s, e) in enumerate(clean):
            out.setdefault(cluster[i], []).append((s, e))
        n_clusters = len(set(cluster.values()))
        fresh = max(cluster.values()) + 1
        for s, e in overlap_spans:
            labs = []
            prev = [i for i, (cs, ce) in enumerate(clean) if ce <= s + 1e-6]
            nxt = [i for i, (cs, ce) in enumerate(clean) if cs >= e - 1e-6]
            if prev:
                labs.append(cluster[max(prev, key=lambda i: clean[i][1])])
            if nxt:
                labs.append(cluster[min(nxt, key=lambda i: clean[i][0])])
            labs = list(dict.fromkeys(labs))
            if len(labs) < 2:  # an overlap has two voices
                others = [c for c in set(cluster.values()) if c not in labs]
                labs.append(others[0] if others else fresh)
            for lab in labs[:2]:
                out.setdefault(lab, []).append((s, e))
        out = {k: iv.merge_timeranges(v) for k, v in out.items()}
        order = {k: i for i, (k, _) in enumerate(sorted(out.items(), key=lambda kv: kv[1][0][0]))}
        out = {str(order[k]): v for k, v in out.items()}
        self._log("reclustered sd_result:", out, f"({n_clusters} voice clusters)")
        return out

    def _segmentation_sd(self, audio_data, sampling_rate, fr=None) -> dict:
        """The segmentation engine's diarization (from the front end's
        activations), its edges snapped to the VAD's first and last speech
        when they lie within 0.3 s of the audio's ends."""
        if fr is not None and fr.get("seg_act") is not None:
            sd = activations_to_diarization(fr["seg_act"], self.od_pipeline.fps)
        else:
            sd = self.od_pipeline.diarize(audio_data, sr=sampling_rate)
        dur = round(len(audio_data) / sampling_rate, 3)
        lo, hi = 0.0, dur
        if fr is not None and fr.get("vad_probs") is not None:
            spans = segment_probs(np.asarray(fr["vad_probs"]), VADConfig(speech_pad=0.0))
            if spans:
                lo = min(max(spans[0][0], 0.0), dur)
                hi = max(min(spans[-1][1], dur), lo)
        snap = 0.3
        out = {}
        for k, v in sd.items():
            ranges = []
            for s, e in v:
                if s >= dur:
                    continue
                e = min(e, dur)
                # as the JAX package does it: this can leave s > e
                if s < snap:
                    s = min(lo, s + snap)
                if dur - e < snap:
                    e = max(hi, e - snap)
                ranges.append((s, e))
            if ranges:
                out[k] = ranges
        return out

    def _speech_windows(self, fr):
        """The front end's windows (non-zero embedding) that overlap VAD
        speech by at least the diarizer's `min_window`."""
        speech = segment_probs(np.asarray(fr["vad_probs"]), VADConfig())
        min_cov = getattr(getattr(self.sd_pipeline, "cfg", None), "min_window", 0.5)
        wins, embs = [], []
        for (s, e), emb in zip(fr["win_times"], fr["win_embs"]):
            cov = sum(max(0.0, min(e, se) - max(s, ss)) for ss, se in speech)
            if cov >= min_cov and np.linalg.norm(emb) > 0:
                wins.append((s, e))
                embs.append(emb)
        return wins, np.asarray(embs) if embs else np.zeros((0, 192), np.float32)

    def _enroll_target(self, target_file, sampling_rate: int):
        """The target's embedding by `FusedFrontend.enroll`, cached by the
        file's content (32 entries); None when the clip has no speech."""
        key = self._enroll_key(target_file)
        if key is not None and key in self._enroll_cache:
            return self._enroll_cache[key]
        if isinstance(target_file, (str, io.BytesIO)):
            t_audio, t_sr = self.ap.read_audio(target_file)
        else:
            t_audio, t_sr = np.asarray(target_file), sampling_rate
        target_embedding = None
        er = self.fused.enroll(self.ap.audio_to_mono(t_audio), sr=t_sr)
        t_vad = segment_probs(er["vad_probs"], VADConfig())
        if t_vad:
            if t_vad[-1][1] - t_vad[0][0] < 4.0:
                print("WARNING: The valid speaking duration of target audio is less than 4s. "
                      "This may cause a bad result.")
            target_embedding = er["emb"]
        else:
            print("ERROR: No VAD result in target audio. Automatically select one speaker "
                  "from the input audio as the target.")
        if key is not None:
            self._enroll_cache[key] = target_embedding
            if len(self._enroll_cache) > 32:
                self._enroll_cache.pop(next(iter(self._enroll_cache)))
        return target_embedding

    @staticmethod
    def _enroll_key(target_file):
        """A key of the enrollment's content: a path with its mtime and size,
        or a hash of the array's or the buffer's bytes; None otherwise."""
        if isinstance(target_file, str):
            try:
                st = os.stat(target_file)
            except OSError:
                return None
            return ("path", target_file, st.st_mtime_ns, st.st_size)
        if isinstance(target_file, np.ndarray):
            return ("arr", hashlib.blake2b(np.ascontiguousarray(target_file).tobytes(),
                                           digest_size=16).hexdigest())
        if isinstance(target_file, io.BytesIO):
            return ("bytes", hashlib.blake2b(target_file.getvalue(),
                                             digest_size=16).hexdigest())
        return None
