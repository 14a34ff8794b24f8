"""REST and WebSocket server (aiohttp) over the port's streaming pipeline.

Counterpart of targetdiarization_tpu/serve/server.py, wire-compatible
with it:

  GET  /                     service banner
  GET  /health               {"status", "model_loaded", "timestamp"}
  POST /diarization/infer    multipart audio_file [+ target_file] ->
                             {"success", "data": {"target_speaker_id",
                             "total_speakers", "results", "statistics",
                             ["target_audio_base64"]}, "error",
                             "processing_time"}
  WS   /diarization/stream   config JSON -> [target_audio] -> config_ack ->
                             audio_chunk (base64 int16) stream ->
                             segment_result per segment -> status completed
  GET  /target-diarization   the browser page (`webui.py`)

`build_model` makes the `TargetDiarizationStream` from the environment's
configuration (`runtime/config.py`) and the shipped checkpoints, on the
card unless the configuration or the caller asks for the CPU. A WS
session's synchronous pipeline runs on a thread of its own, with its
state in its own `StreamState`, so sessions run concurrently. The server
needs aiohttp (`create_app` raises without it); `build_model` and the
pipeline do not.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import queue
import tempfile
import threading
import time
import traceback

import numpy as np

try:
    from aiohttp import WSMsgType, web

    HAS_AIOHTTP = True
except Exception:  # pragma: no cover
    HAS_AIOHTTP = False

logger = logging.getLogger("targetdiarization_tpu_torch.serve")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def format_speaker_info(speaker_id: str, target_speaker_id: str) -> str:
    if speaker_id == target_speaker_id:
        return "target"
    if speaker_id == "-1":
        return "uncertain"
    return "other"


def audio_to_base64(audio_data) -> str:
    if audio_data is None:
        return ""
    audio_data = np.asarray(audio_data)
    if audio_data.dtype == np.float32:
        audio_data = (audio_data * 32767).astype(np.int16)
    return base64.b64encode(audio_data.tobytes()).decode("utf-8")


def base64_to_audio(data: str) -> np.ndarray:
    raw = base64.b64decode(data)
    return np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32767.0


def _asr_checkpoint_name(repo: str, asr_engine: str) -> str:
    """The default checkpoint directory of an ASR engine, as the JAX
    server names it: whisper_v2 / whisper_v3 (also bare "whisper") /
    whisper_finetune each their own, else whisper-bootstrap;
    sv-bootstrap for SenseVoice; asr-bootstrap for Paraformer and for the
    cloud engines (their local engine, for forced alignment)."""
    eng = str(asr_engine)
    if eng.startswith("whisper"):
        variant = {"whisper_v2": "whisper-v2", "whisper_v3": "whisper-v3",
                   "whisper_finetune": "whisper-finetune",
                   "whisper": "whisper-v3"}.get(eng, "whisper-v3")
        if os.path.exists(os.path.join(repo, "checkpoints", variant)):
            return variant
        return "whisper-bootstrap"
    if eng == "sensevoice":
        return "sv-bootstrap"
    return "asr-bootstrap"


def _separator_checkpoint_name(repo: str, device: str) -> str:
    """TD_SEP_CHECKPOINT, else the 512/24 `sep-bootstrap-512` on the card
    (where it exists) and the 256/12 `sep-bootstrap` elsewhere."""
    name = os.environ.get("TD_SEP_CHECKPOINT", "")
    if name:
        return name
    if str(device).startswith("cuda") and os.path.exists(
            os.path.join(repo, "checkpoints", "sep-bootstrap-512")):
        return "sep-bootstrap-512"
    return "sep-bootstrap"


def build_model(config=None, device: str | None = None):
    """The `TargetDiarizationStream` of the configuration (`env_config()`
    when none is given) on `device` (the configuration's, "cuda" by
    default). A stage without a configured checkpoint takes the shipped
    one: the 512/24 separator `sep-bootstrap-512` on the card and the
    256/12 `sep-bootstrap` on the CPU (TD_SEP_CHECKPOINT names another),
    and `vad-`, `asr-`, `punc-`, `spk-`, `seg-`, `den-`, `rest-`, `enh-`
    and `emo-bootstrap`, the JAX `build_model`'s engine set (ASR_ENGINE
    picks the ASR checkpoint, `_asr_checkpoint_name`; EMBEDDING_MODEL may
    name a CAM++ one). The engines
    compute in the card's types (bf16 on the card, float32 on the CPU;
    TD_COMPUTE_DTYPE overrides), the enhancer in float32 as the JAX one
    does; one card needs no mesh."""
    from ..models.diarization import SegmentationEngine
    from ..pipeline.streaming import TargetDiarizationStream
    from ..pipeline.target_asr import TargetASR
    from ..processors.asr import ASRProcessor
    from ..processors.audio import AudioProcessor
    from ..runtime.config import env_config

    cfg = config or env_config()
    device = device or cfg.device or "cuda"
    defaults = {
        "vad_model": "vad-bootstrap", "separation_model": _separator_checkpoint_name(REPO, device),
        "embedding_model": "spk-bootstrap", "segmentation_model": "seg-bootstrap",
        "denoise_model": "den-bootstrap", "restoration_model": "rest-bootstrap",
        "enhancement_model": "enh-bootstrap",
        "asr_model": _asr_checkpoint_name(REPO, cfg.asr_engine), "punc_model": "punc-bootstrap",
        "emotion_model": "emo-bootstrap",
    }
    for name, ckpt in defaults.items():
        path = os.path.join(REPO, "checkpoints", ckpt)
        if not getattr(cfg, name) and os.path.exists(path):
            setattr(cfg, name, path)
            logger.info(f"using bootstrap checkpoint for {name}: {path}")
    ap = AudioProcessor(separation_model=cfg.separation_model, denoise_model=cfg.denoise_model,
                        restoration_model=cfg.restoration_model,
                        enhancement_model=cfg.enhancement_model, quality=cfg.quality,
                        device=device, verbose_log=cfg.verbose_log)
    asrp = ASRProcessor(vad_model=cfg.vad_model, asr_model=cfg.asr_model,
                        asr_engine=cfg.asr_engine, punc_model=cfg.punc_model,
                        emotion_model=cfg.emotion_model, verbose_log=cfg.verbose_log,
                        device=device)
    tasr = TargetASR(audio_processor=ap, asr_processor=asrp,
                     embedding_model=cfg.embedding_model, device=device,
                     verbose_log=cfg.verbose_log)
    seg = None
    if cfg.segmentation_model and os.path.exists(cfg.segmentation_model):
        seg = SegmentationEngine.from_pretrained(cfg.segmentation_model, device=device)
    return TargetDiarizationStream(
        target_asr=tasr, segmentation_engine=seg, asr_engine=cfg.asr_engine,
        target_similarity_threshold=cfg.target_similarity_threshold,
        pyannote_clustering_threshold=cfg.pyannote_clustering_threshold,
        verbose_log=cfg.verbose_log, is_vad_buffer=cfg.is_vad_buffer,
        use_asr_prompt=cfg.use_asr_prompt, similarity_threshold=cfg.similarity_threshold,
        vad_min_silence=cfg.vad_min_silence, max_buffer_duration=cfg.max_buffer_duration,
        loudness_diff_threshold=cfg.loudness_diff_threshold)


# ---------------- handlers ----------------


async def handle_root(request):
    return web.json_response({
        "message": "Target Diarization API",
        "version": "1.0.0",
        "endpoints": {
            "inference": "/diarization/infer",
            "streaming": "/diarization/stream",
            "health": "/health",
        },
    })


async def handle_health(request):
    return web.json_response({
        "status": "healthy",
        "model_loaded": request.app.get("model") is not None,
        "timestamp": int(time.time()),
    })


async def handle_infer(request):
    start_time = time.time()
    model = request.app.get("model")
    tmp_files = []
    try:
        if model is None:
            return web.json_response(
                {"success": False, "error": "Model not loaded"}, status=500)
        audio_path = None
        target_path = None
        params = {"sampling_rate": 16000, "is_single": False,
                  "output_target_audio": True}
        try:
            reader = await request.multipart()
        except Exception:
            return web.json_response(
                {"success": False, "error": "multipart form data required"},
                status=422)
        async for part in reader:
            if part.name in ("audio_file", "target_file"):
                suffix = os.path.splitext(part.filename or "a.wav")[1] or ".wav"
                fd, path = tempfile.mkstemp(suffix=suffix)
                with os.fdopen(fd, "wb") as f:
                    f.write(await part.read(decode=False))
                tmp_files.append(path)
                if part.name == "audio_file":
                    audio_path = path
                else:
                    target_path = path
            elif part.name in params:
                raw = (await part.read(decode=False)).decode()
                if part.name == "sampling_rate":
                    params[part.name] = int(raw)
                else:
                    params[part.name] = raw.lower() in ("1", "true", "yes")
        # query-string overrides
        for key in params:
            if key in request.query:
                raw = request.query[key]
                params[key] = int(raw) if key == "sampling_rate" else raw.lower() in ("1", "true", "yes")
        if audio_path is None:
            return web.json_response(
                {"success": False, "error": "audio_file is required"}, status=422)

        loop = asyncio.get_event_loop()
        target_spk, final_result, target_audio = await loop.run_in_executor(
            None,
            lambda: model.infer(
                wav_file=audio_path, target_file=target_path,
                sampling_rate=params["sampling_rate"],
                is_single=params["is_single"],
                output_target_audio=params["output_target_audio"]),
        )
        results = [
            {
                "speaker": r["speaker"],
                "speaker_type": format_speaker_info(r["speaker"], target_spk),
                "timerange": list(r["timerange"]),
                "text": r["text"],
                "type": r["type"],
                "score": r.get("score", -1.0),
            }
            for r in final_result
        ]
        data = {
            "target_speaker_id": target_spk,
            "total_speakers": len({r["speaker"] for r in final_result
                                   if r["speaker"] != "-1"}),
            "results": results,
            "statistics": {
                "total_duration": round(
                    max((r["timerange"][1] for r in final_result), default=0.0), 3),
                "target_speaker_duration": round(sum(
                    r["timerange"][1] - r["timerange"][0]
                    for r in final_result if r["speaker"] == target_spk), 3),
                "other_speakers_duration": round(sum(
                    r["timerange"][1] - r["timerange"][0]
                    for r in final_result
                    if r["speaker"] != target_spk and r["speaker"] != "-1"), 3),
            },
        }
        if params["output_target_audio"] and target_audio is not None:
            data["target_audio_base64"] = audio_to_base64(target_audio)
        return web.json_response({
            "success": True,
            "data": data,
            "error": None,
            "processing_time": round(time.time() - start_time, 3),
        })
    except Exception as e:
        traceback.print_exc()
        return web.json_response({
            "success": False,
            "data": None,
            "error": f"Inference failed: {e}",
            "processing_time": round(time.time() - start_time, 3),
        })
    finally:
        for path in tmp_files:
            try:
                os.unlink(path)
            except OSError:
                pass


async def handle_stream(request):
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    model = request.app.get("model")
    try:
        if model is None:
            await ws.send_json({"type": "error", "message": "Model not loaded"})
            return ws
        config_message = await _receive_json(ws)
        if config_message is None:
            return ws
        config = config_message.get("data", {})
        target_audio = None
        if config.get("has_target_file", False):
            target_message = await _receive_json(ws)
            if target_message and target_message.get("type") == "target_audio":
                target_audio = base64_to_audio(target_message.get("data", ""))
        await ws.send_json({
            "type": "config_ack",
            "data": {"config": config,
                     "target_file_loaded": target_audio is not None},
        })

        async def audio_generator():
            while True:
                message = await _receive_json(ws)
                if message is None:
                    break
                if message.get("type") == "audio_chunk":
                    yield base64_to_audio(message.get("data", ""))
                elif message.get("type") == "audio_end":
                    break

        session_metrics: dict = {}
        async for target_spk, asr_result, _ in _async_infer_stream(
                model, audio_generator(), target_audio, config,
                metrics=session_metrics):
            for segment in asr_result:
                await ws.send_json({
                    "type": "segment_result",
                    "data": {
                        "target_speaker_id": target_spk,
                        "segment": {
                            "speaker": segment["speaker"],
                            "speaker_type": format_speaker_info(
                                segment["speaker"], target_spk),
                            "timerange": segment["timerange"],
                            "text": segment["text"],
                            "type": segment["type"],
                        },
                    },
                })
        status = {"type": "status", "message": "completed"}
        summary = _latency_summary(session_metrics)
        if summary:  # the session's intake and emission percentiles
            status["metrics"] = summary
        await ws.send_json(status)
    except Exception as e:
        try:
            await ws.send_json({"type": "error",
                                "message": f"Processing error: {e}"})
        except Exception:
            pass
    return ws


async def _receive_json(ws):
    msg = await ws.receive()
    if msg.type != WSMsgType.TEXT:
        return None
    return json.loads(msg.data)


def _latency_summary(metrics: dict) -> dict:
    """p50/p90 (ms) per latency family collected during a session."""

    def pct(vals, q):
        s = sorted(vals)
        return round(s[min(int(len(s) * q), len(s) - 1)] * 1000.0, 1)

    out = {}
    for fam, key in (("intake", "intake_s"), ("emission", "emission_s")):
        vals = metrics.get(key) or []
        if vals:
            out[f"{fam}_p50_ms"] = pct(vals, 0.50)
            out[f"{fam}_p90_ms"] = pct(vals, 0.90)
            out[f"{fam}_n"] = len(vals)
    return out


async def _async_infer_stream(model, audio_generator, target_file, config,
                              metrics=None):
    """The WS loop's chunks into the pipeline's generator on a worker
    thread (a queue each way), its results back as an async generator.

    `metrics`: optional dict collecting per-chunk intake latency
    ("intake_s": how long the pipeline holds each chunk before it pulls
    the next) and, through the pipeline, per-segment emission latency
    ("emission_s")."""
    audio_queue: queue.Queue = queue.Queue()
    finished = threading.Event()
    loop = asyncio.get_event_loop()
    result_queue: asyncio.Queue = asyncio.Queue()
    inference_done = asyncio.Event()

    async def collector():
        try:
            async for chunk in audio_generator:
                audio_queue.put(chunk)
        except Exception as e:
            logger.error(f"Audio collection error: {e}")
        finally:
            audio_queue.put(None)
            finished.set()

    def sync_generator():
        while True:
            try:
                chunk = audio_queue.get(timeout=0.1)
            except queue.Empty:
                if finished.is_set() and audio_queue.empty():
                    return
                continue
            if chunk is None:
                return
            t0 = time.perf_counter()
            yield chunk
            if metrics is not None:
                metrics.setdefault("intake_s", []).append(
                    time.perf_counter() - t0)

    def run_inference():
        try:
            for result in model.infer_stream(
                    audio_stream_generator=sync_generator(),
                    target_file=target_file,
                    sampling_rate=config.get("sampling_rate", 16000),
                    is_single=config.get("is_single", False),
                    output_target_audio=config.get("output_target_audio", False),
                    metrics=metrics):
                asyncio.run_coroutine_threadsafe(
                    result_queue.put(result), loop).result()
        except Exception as e:
            traceback.print_exc()
            logger.error(f"Inference thread error: {e}")
        finally:
            loop.call_soon_threadsafe(inference_done.set)

    collector_task = asyncio.create_task(collector())
    worker = threading.Thread(target=run_inference, daemon=True)
    worker.start()
    try:
        while True:
            try:
                result = await asyncio.wait_for(result_queue.get(), timeout=0.1)
                yield result
            except asyncio.TimeoutError:
                if inference_done.is_set() and result_queue.empty():
                    break
    finally:
        if not collector_task.done():
            collector_task.cancel()
            try:
                await collector_task
            except asyncio.CancelledError:
                pass


# ---------------- app factory ----------------


def create_app(model=None, serve_ui: bool = True):
    if not HAS_AIOHTTP:
        raise RuntimeError("aiohttp is required for the server")
    app = web.Application(client_max_size=512 * 1024 * 1024)
    app["model"] = model
    app.router.add_get("/", handle_root)
    app.router.add_get("/health", handle_health)
    app.router.add_post("/diarization/infer", handle_infer)
    app.router.add_get("/diarization/stream", handle_stream)
    if serve_ui:
        from .webui import handle_ui

        app.router.add_get("/target-diarization", handle_ui)
    return app


def run_server(host: str = "0.0.0.0", port: int = 8000, config=None,
               device: str | None = None):
    """Builds the model, warms it (TD_WARMUP=0 skips: `prewarm` for a 2 s
    request and `prewarm_streaming`) and serves until stopped."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    model = build_model(config, device=device)
    if os.environ.get("TD_WARMUP", "1") == "1":
        logger.info("warming the device programs (TD_WARMUP=0 to skip)...")
        model.prewarm(2 * 16000)
        model.prewarm_streaming()
    app = create_app(model)
    logger.info(f"Target Diarization API on {host}:{port}")
    web.run_app(app, host=host, port=port)


if __name__ == "__main__":
    run_server()
