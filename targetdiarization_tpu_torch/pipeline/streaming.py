"""TargetDiarizationStream: the chunked real-time pipeline.

Counterpart of targetdiarization_tpu/pipeline/streaming.py.
`infer_stream(chunks, target)` takes audio chunks (1 s from the clients)
and yields `(target_spk, [result], target_audio)` for each flushed buffer,
where a result is {"speaker": "1" (the target) or "0", "timerange",
"text", "type": "single" or "overlap"}. All mutable state of a session
lives in its own `StreamState`, so concurrent sessions share nothing but
the engines.

Per chunk, `should_wait_for_next_chunk` decides whether the buffer is
flushed, from one `StreamChunkAnalyzer` pass (speech probabilities of the
buffer and of the chunk, and the speaker cosine between them):
  R1 buffer >= max_buffer_duration -> flush
  R2 a silent chunk with a trailing gap >= vad_min_silence -> flush
  R3 no speech in the chunk -> the chunk becomes near silence, wait
  R4 a trailing gap >= vad_min_silence (speech complete) -> flush
  R5 a speaker change between the buffer and the chunk -> flush
A flushed buffer goes through `process_single_chunk`: the overlap check,
`audio_preprocess` in stream mode (the separator's louder stream), then
`single_speaker_asr` or, on overlap, `multi_speakers_separate_asr`, and
the target check. The first flushed buffer enrolls the target when no
target file was given.

With TD_ASYNC_FLUSH (default on) the flushes of a session run in order on
one worker thread of its own (`_FlushQueue`), so the chunk intake never
waits for a flush; at most TD_MAX_INFLIGHT_FLUSH (2) wait unfinished, and
a further flush first takes the oldest one's results. Across sessions the
engines' MicroBatchers coalesce concurrent calls at one rung into one
batched forward. Unlike the JAX package, an error in the analyzer's pass
propagates.
"""

from __future__ import annotations

import io
import os
import re
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Generator, Union

import numpy as np
import torch

from ..models.vad import VADConfig, segment_probs
from .fused import StreamChunkAnalyzer
from .offline import TargetDiarization


class _FlushQueue:
    """A session's flushes, run in order on one worker thread. `submit`
    returns the results of the flushes it had to wait for (at most
    `max_inflight` stay unfinished); `drain_ready` yields those of the
    finished ones at the head, `drain_all` waits for every one. `on_emit`
    is called with the latency from the arrival of the chunk that caused a
    flush to the hand-over of each of its results."""

    def __init__(self, run, max_inflight: int = 2, on_emit=None):
        self._run = run
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._pending: deque = deque()
        self._max = max(1, int(max_inflight))
        self._on_emit = on_emit

    def _emit(self, fut, t_arrival) -> list:
        results = fut.result()
        if self._on_emit is not None and t_arrival is not None and results:
            lat = time.perf_counter() - t_arrival
            for _ in results:
                self._on_emit(lat)
        return results

    def submit(self, audio, t_arrival=None) -> list:
        forced: list = []
        while len(self._pending) >= self._max:
            forced.extend(self._emit(*self._pending.popleft()))
        self._pending.append((self._ex.submit(self._run, audio), t_arrival))
        return forced

    def drain_ready(self):
        while self._pending and self._pending[0][0].done():
            yield from self._emit(*self._pending.popleft())

    def drain_all(self):
        while self._pending:
            yield from self._emit(*self._pending.popleft())

    def close(self):
        self._ex.shutdown(wait=False)


@dataclass
class StreamState:
    """One session's mutable state."""

    current_time: float = 0.0
    target_embedding: np.ndarray | None = None
    prev_asr_text: str = ""
    vad_buffer: list = field(default_factory=list)
    buffer_duration: float = 0.0
    system_loudness_diff: float = 0.0
    on_emit: object = None  # on_emit(latency_s), per result handed back

    def clear_buffer(self):
        self.vad_buffer.clear()
        self.buffer_duration = 0.0


class TargetDiarizationStream(TargetDiarization):
    def __init__(self, is_vad_buffer: bool = True, use_asr_prompt: bool = False,
                 similarity_threshold: float = 0.4, vad_min_silence: float = 0.3,
                 max_buffer_duration: float = 30.0, loudness_diff_threshold: float = 12.0,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        vad = self.tasr.asrp.vad
        self._stream_analyzer = StreamChunkAnalyzer(vad, self.tasr.spk) if vad is not None \
            else None
        self.is_vad_buffer = is_vad_buffer
        self.use_asr_prompt = use_asr_prompt
        self.similarity_threshold = similarity_threshold
        self.vad_min_silence = vad_min_silence
        self.max_buffer_duration = max_buffer_duration
        self.loudness_diff_threshold = loudness_diff_threshold
        self.async_flush = os.environ.get("TD_ASYNC_FLUSH", "1") != "0"
        self.max_inflight_flushes = int(os.environ.get("TD_MAX_INFLIGHT_FLUSH", "2"))

    # ---------------- warm-up ----------------

    def prewarm_streaming(self, max_sessions: int = 8) -> int:
        """One pass of every device program that up to `max_sessions`
        concurrent sessions reach, at each rung and row count: the
        analyzer's (buffer rung x row rung) grid, the ASR's (sample rung x
        row rung), the speaker engine's sample rungs at 1 and 2 rows, and
        the separator's (window rung x row rung), up to the rung of
        max_buffer_duration. On the card it loads the kernels' library
        first. Returns the number of passes."""
        from ..models.asr import _SAMPLE_LADDER as ASR_LADDER
        from ..models.speaker import _SAMPLE_LADDER as SPK_LADDER
        from .fused import _LADDER

        if self.fused.device.type == "cuda":
            from ..ops.kernels._build import load_library

            load_library()
        n = 0
        max_bucket = _LADDER.bucket(min(int(self.max_buffer_duration * 16000), _LADDER.rungs[-1]))

        def rows_of(rungs):
            return [r for r in rungs if r <= max(max_sessions, 1)]

        sa = self._stream_analyzer
        if sa is not None:
            cs = sa.CHUNK_LADDER.bucket(sa.CHUNK_SAMPLES)
            for bucket in (b for b in _LADDER.rungs if b <= max_bucket):
                for nb in rows_of(sa.ROW_LADDER.rungs):
                    sa._run_batch((bucket, cs), [(np.zeros(min(bucket, cs), np.float32),
                                                  np.zeros(cs, np.float32))] * nb)
                    n += 1
        asr = self.tasr.asrp.asr
        if hasattr(asr, "_run_mb"):  # the Paraformer and SenseVoice engine, not whisper
            for bucket in (b for b in ASR_LADDER.rungs if b <= max(max_bucket, ASR_LADDER.rungs[0])):
                for nb in rows_of(asr.ROW_LADDER):
                    asr._run_mb(bucket, [(np.zeros(bucket, np.int16), 16000)] * nb)
                    n += 1
        for bucket in (b for b in SPK_LADDER.rungs if b <= max(max_bucket, SPK_LADDER.rungs[0])):
            for rows in (1, 2):
                self.tasr.spk.embed_batch([np.zeros(bucket, np.float32)] * rows)
                n += 1
        sep = self.ap.separator
        if sep is not None:
            for bucket in (b for b in sep.ladder.rungs if b <= max(max_bucket, 32000)):
                for nb in rows_of(sep.ROW_LADDER):
                    sep._run_mb(bucket, [(np.zeros((1, bucket), np.float32),
                                          np.ones(1, np.int64))] * nb)
                    n += 1
        return n

    # ---------------- preprocessing ----------------

    def chunk_preprocess(self, audio_data: np.ndarray, sampling_rate: int) -> np.ndarray:
        """mono -> float32 -> 16 kHz."""
        audio_data = self.ap.int16_to_float32(self.ap.audio_to_mono(np.asarray(audio_data)))
        audio_data, _ = self.ap.audio_resample(audio_data, sampling_rate, 16000)
        return audio_data

    # ---------------- main loop ----------------

    def infer_stream(self, audio_stream_generator: Generator,
                     target_file: Union[str, np.ndarray, io.BytesIO, None] = None,
                     sampling_rate: int = 16000, is_single: bool = False,
                     output_target_audio: bool = False, metrics: dict | None = None):
        """Yields (target_spk, asr_result, target_audio) per flushed segment.
        With `metrics` (a dict), "emission_s" collects one latency a yielded
        segment: the wall seconds from the arrival of the chunk that caused
        its flush to its hand-over."""
        state = StreamState()
        if metrics is not None:
            state.on_emit = metrics.setdefault("emission_s", []).append
        if target_file is not None:
            self._enroll_stream_target(target_file, sampling_rate, state)
        fq = None
        if self.async_flush:
            fq = _FlushQueue(lambda a: self._flush(a, is_single, state),
                             self.max_inflight_flushes, on_emit=state.on_emit)

        def parsed(result):
            asr_result, target_audio = self.asr_audio_parser([result], "1", output_target_audio)
            return "1", asr_result, target_audio

        try:
            try:
                for pcm_chunk in audio_stream_generator:
                    t_recv = time.perf_counter()
                    chunk = self.chunk_preprocess(pcm_chunk, sampling_rate)
                    if fq is not None:
                        for result in fq.drain_ready():
                            yield parsed(result)
                    for result in self.process_vad_chunk(chunk, is_single, state,
                                                         flush_queue=fq, t_arrival=t_recv):
                        yield parsed(result)
            finally:
                if state.vad_buffer:
                    t_fin = time.perf_counter()
                    combined = np.concatenate(state.vad_buffer)
                    sink = (fq.submit(combined, t_fin) if fq is not None else
                            self.process_single_chunk(combined, is_single, state))
                    for result in sink:
                        if fq is None and state.on_emit is not None:
                            state.on_emit(time.perf_counter() - t_fin)
                        yield parsed(result)
                    state.clear_buffer()
                if fq is not None:
                    for result in fq.drain_all():
                        yield parsed(result)
        finally:
            if fq is not None:
                fq.close()

    def _enroll_stream_target(self, target_file, sampling_rate: int, state: StreamState):
        """The target's embedding (and the loudness gate's level) from a
        target clip of at least 1 s: stream-mode preprocessing, then its
        speech from the first to the last VAD segment."""
        if not isinstance(target_file, np.ndarray):
            target_audio, sampling_rate = self.ap.read_audio(target_file)
        else:
            target_audio = target_file.copy()
        if len(target_audio) / sampling_rate < 1.0:
            return
        target_loudness = self.ap.meter_loudness(target_audio, sampling_rate)
        if np.isfinite(target_loudness):
            state.system_loudness_diff = target_loudness + 23.0
        target_audio = self.audio_preprocess(target_audio, sampling_rate, stream_mode=True,
                                             output_audio_only=True)
        t_vad = self.tasr.asrp.vad_detection(target_audio, 16000)
        if t_vad:
            start, end = t_vad[0][0], t_vad[-1][1]
            if end - start < 4.0:
                print("WARNING: The valid speaking duration of target audio is less than 4s. "
                      "This may cause a bad result.")
            target_audio = self.ap.split_audio_by_time(target_audio, 16000, start, end)
        state.target_embedding = self.tasr.get_target_embedding(target_audio)

    def _flush(self, audio: np.ndarray, is_single: bool, state: StreamState) -> list:
        """A flush on the session's worker thread (inference mode is per
        thread)."""
        with torch.inference_mode():
            return list(self.process_single_chunk(audio, is_single, state))

    # ---------------- buffering ----------------

    def process_vad_chunk(self, pcm_chunk: np.ndarray, is_single: bool, state: StreamState,
                          flush_queue=None, t_arrival: float | None = None):
        """Routes one 16 kHz chunk: the loudness gate (a chunk far below the
        target's level becomes near silence), the buffer, and the flush
        decision. With `flush_queue` a flush goes to the session's worker
        and what is yielded are earlier flushes' results."""
        if pcm_chunk is None or len(pcm_chunk) == 0:
            return

        def sync_flush(audio):
            for r in self.process_single_chunk(audio, is_single, state):
                if state.on_emit is not None and t_arrival is not None:
                    state.on_emit(time.perf_counter() - t_arrival)
                yield r

        is_silence = False
        if state.system_loudness_diff != 0.0:
            loud = self.ap.meter_loudness(pcm_chunk, 16000)
            gate = -23.0 + state.system_loudness_diff - self.loudness_diff_threshold
            if loud < gate:
                is_silence = True
                pcm_chunk = np.full_like(pcm_chunk, 1e-5, dtype=np.float32)
            self._log(f"PCM loudness: {loud} | {gate}")
        state.vad_buffer.append(pcm_chunk)
        state.buffer_duration += round(len(pcm_chunk) / 16000, 3)
        if not self.is_vad_buffer:
            if is_silence:
                return
            current = state.vad_buffer[-1]
            if flush_queue is not None:
                yield from flush_queue.submit(current, t_arrival)
            else:
                yield from sync_flush(current)
            state.clear_buffer()
            return
        if self.should_wait_for_next_chunk(state, is_silence=is_silence):
            return
        combined = np.concatenate(state.vad_buffer)
        if flush_queue is not None:
            yield from flush_queue.submit(combined, t_arrival)
        else:
            yield from sync_flush(combined)
        state.clear_buffer()

    def should_wait_for_next_chunk(self, state: StreamState, is_silence: bool = False) -> bool:
        """The flush cascade R1..R5; False means flush now."""

        def trailing_gap_ok(audio: np.ndarray, vad_result: list) -> bool:
            if not vad_result:
                return True
            return len(audio) / 16000 - vad_result[-1][-1] >= self.vad_min_silence

        if state.buffer_duration >= self.max_buffer_duration:  # R1
            self._log("Buffer duration exceeds max_buffer_duration, processing")
            return False
        if not state.vad_buffer:
            return True
        combined = np.concatenate(state.vad_buffer)
        similarity = None
        if self._stream_analyzer is not None:  # built whenever there is a VAD
            fr = self._stream_analyzer.analyze_chunk(combined, state.vad_buffer[-1])
            buffer_vad = segment_probs(fr["probs_comb"], VADConfig(max_end_silence_time=0.1),
                                       fps=100.0)
            chunk_vad = segment_probs(fr["probs_chunk"], VADConfig(), fps=100.0)
            similarity = fr["similarity"]
        else:
            buffer_vad = [[0.0, len(combined) / 16000]]
            chunk_vad = [[0.0, 1.0]]
        if is_silence:  # R2
            if trailing_gap_ok(combined, buffer_vad):
                self._log("Silence with sufficient gap, processing")
                return False
            return True
        if not chunk_vad:  # R3
            state.vad_buffer[-1] = np.full_like(state.vad_buffer[-1], 1e-5, dtype=np.float32)
            return True
        if trailing_gap_ok(combined, buffer_vad):  # R4
            self._log("Speech appears complete, processing")
            return False
        if len(state.vad_buffer) > 1:  # R5
            if similarity is None:
                embs = self.tasr.spk.embed_batch([np.concatenate(state.vad_buffer[:-1]),
                                                  state.vad_buffer[-1]])
                similarity = self.tasr.cosine_similarity(embs[0], embs[1])
            if similarity < self.similarity_threshold:
                self._log("Different speaker detected, processing")
                return False
        return True

    # ---------------- per-segment processing ----------------

    def process_single_chunk(self, pcm_chunk: np.ndarray, is_single: bool, state: StreamState):
        """The overlap check, then `asr_audio_streaming`; yields its result
        (if any)."""
        is_overlap = False
        if self.od_pipeline is not None and not is_single:
            is_overlap = self.od_pipeline.is_overlap(pcm_chunk, sr=16000)
        result = self.asr_audio_streaming(pcm_chunk, is_overlap, state)
        if result is not None:
            state.prev_asr_text = result["text"]
            yield result

    def asr_audio_streaming(self, audio_data: np.ndarray, is_overlap: bool, state: StreamState,
                            is_output_audio: bool = False):
        """One flushed buffer (at least 0.4 s) -> its result, or None for
        silence, no speech or no text. The session's first buffer, when it
        has no target, enrolls it (and is taken as single-speaker)."""

        def remove_punc(text: str) -> str:
            return re.sub(r"[^\w\s]", "", text or "").lower().strip()

        duration = round(len(audio_data) / 16000, 3)
        if duration < 0.4:
            return None
        segment_start = state.current_time
        state.current_time += duration
        more_args = {"asr_engine": self.asr_engine, "no_punc": False, "preprocess": []}
        if self.use_asr_prompt and state.prev_asr_text:
            more_args["prompt"] = state.prev_asr_text
        if state.target_embedding is None:
            loud = self.ap.meter_loudness(audio_data, 16000)
            if np.isfinite(loud):
                state.system_loudness_diff = loud + 23.0
            audio_data = self.audio_preprocess(audio_data, 16000, stream_mode=True,
                                               output_audio_only=True)
            state.target_embedding = self.tasr.spk.get_speaker_embedding(audio_data, 16000)
            is_overlap = False
        else:
            audio_data = self.audio_preprocess(audio_data, 16000, stream_mode=True,
                                               output_audio_only=True)
        loud = self.ap.meter_loudness(audio_data, 16000)
        if loud < -23.0 + state.system_loudness_diff - self.loudness_diff_threshold:
            return None
        vad_result = self.tasr.asrp.vad_detection(audio_data, 16000)
        if not vad_result:
            return None
        if is_overlap:
            clips = self.tasr.multi_speakers_separate_asr(
                audio_data, target_embedding=state.target_embedding, more_args=more_args,
                is_output_audio=True)
        else:
            clips = self.tasr.single_speaker_asr(audio_data, more_args=more_args,
                                                 is_output_audio=True)
        if not clips:
            return None
        if len(clips) > 1:
            clips.sort(key=lambda x: len(remove_punc(x["text"])), reverse=True)
        text = clips[0]["text"].strip()
        if not text:
            return None
        timerange = [segment_start + vad_result[0][0], segment_start + vad_result[-1][-1]]
        segment_audio = clips[0]["audio"] if is_overlap else audio_data
        seg_emb = self.tasr.spk.get_speaker_embedding(segment_audio, 16000)
        is_target = self.tasr.is_same_person(seg_emb, state.target_embedding,
                                             threshold=self.similarity_threshold)
        return {"speaker": "1" if is_target else "0", "timerange": timerange, "text": text,
                "type": "overlap" if is_overlap else "single",
                "audio": segment_audio if is_output_audio else None}
