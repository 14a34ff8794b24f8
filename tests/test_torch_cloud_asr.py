"""The port's cloud ASR clients and `ASRProcessor.asr_detection_api`
against the JAX package's, on the CPU, over stub transports.

Each client of both packages builds its request from the same audio with
the same clock and nonce (injected, or `time.time` and `random.randint`
patched where the processor makes the client): URL, headers and body
byte-identical; each parser gives the same result on the same response
(and the same error on an error code); the processor gives the same
results for every API engine, prompt and language, and the same
soft failures. Nothing touches the network: the default HTTP transport
is patched to a stub in both packages.
"""

import json
import random
import time
from unittest import mock

import numpy as np
import pytest

from targetdiarization_tpu.processors import cloud_asr as jcloud
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu_torch.processors import cloud_asr as tcloud
from targetdiarization_tpu_torch.processors.asr import ASRProcessor

SR = 16000
CREDS = {"tencent": {"appid": "1300000000", "secret_id": "AKIDtest", "secret_key": "sk-test"},
         "gemini": {"api_key": "gk", "base_url": "https://example.invalid/", "model_id": "g-1"},
         "jzx": {"endpoint": "https://jzx.invalid/asr"},
         "xunfei": {"appid": "app1", "api_key": "xk", "api_secret": "xs"}}
RESPONSES = {
    "tencent": {"code": 0, "flash_result": [{"text": "测试文本", "sentence_list": [
        {"text": "测试", "start_time": 0, "end_time": 640},
        {"text": "文本", "start_time": 700, "end_time": 1500}]}]},
    "gemini": {"candidates": [{"content": {"parts": [{"text": "  hello world \n"}]}}]},
    "jzx": {"code": 0, "data": {"text": "天地人", "word_list": [
        {"word": "天地", "start": 0.1, "end": 0.5}, {"word": "人", "start": 0.6, "end": 0.9}]}},
    "xunfei": [{"code": 0, "data": {"result": {"sn": 1, "ws": [{"cw": [{"w": "你号"}]}]}}},
               {"code": 0, "data": {"result": {"sn": 2, "pgs": "rpl", "rg": [1, 1],
                                               "ws": [{"cw": [{"w": "你好"}]}]}}},
               {"code": 0, "data": {"result": {"sn": 3, "ws": [{"cw": [{"w": "世界"}]}]}}}],
}


def _audio(seconds: float = 0.3, seed: int = 3) -> np.ndarray:
    return (0.2 * np.random.default_rng(seed).standard_normal(int(seconds * SR))).astype(
        np.float32)


def _recorder(engine: str, seen: list, body=None):
    """A stub transport of `engine` that records what it is sent."""
    if engine == "xunfei":
        def ws(url, frames):
            seen.append((url, list(frames)))
            return [json.dumps(m) for m in RESPONSES["xunfei"]]
        return ws

    def http(method, url, headers, data):
        seen.append((method, url, dict(headers), data))
        return 200, body if body is not None else json.dumps(RESPONSES[engine]).encode()
    return http


def test_tencent_requests_are_identical():
    audio = tcloud.wav_bytes(_audio(), SR)
    assert audio == jcloud.wav_bytes(_audio(), SR)
    for kw in ({}, {"engine_type": "16k_en", "hotword_list": "a|11,b|11"}):
        reqs = [m.TencentFlashASR(**CREDS["tencent"], clock=lambda: 1_700_000_000,
                                  rng=lambda: 424242).build_request(audio, **kw)
                for m in (tcloud, jcloud)]
        assert reqs[0] == reqs[1]


def test_gemini_jzx_and_xunfei_requests_are_identical():
    wav = tcloud.wav_bytes(_audio(), SR)
    for lang in (("unknown", "zh-CN"), ("en-US", "en-US")):
        a, b = (m.GeminiASR(**CREDS["gemini"]).build_request(wav, "audio/wav", *lang)
                for m in (tcloud, jcloud))
        assert a == b
    assert tcloud.JzxASR(**CREDS["jzx"]).build_request(wav, "ctx") == \
        jcloud.JzxASR(**CREDS["jzx"]).build_request(wav, "ctx")
    pcm = (np.arange(3000) % 200).astype(np.int16).tobytes()
    for m_args in (("zh_cn", ""), ("en_us", "hw1")):
        a, b = (m.XunfeiIatASR(**CREDS["xunfei"], clock=lambda: 1_700_000_000.0)
                for m in (tcloud, jcloud))
        assert a.build_url() == b.build_url()
        assert a.build_frames(pcm, *m_args) == b.build_frames(pcm, *m_args)
        assert a.build_frames(b"x", *m_args) == b.build_frames(b"x", *m_args)


@pytest.mark.parametrize("engine", ["tencent", "gemini", "jzx", "xunfei"])
def test_parsers_agree(engine):
    ok = RESPONSES[engine]
    err = ({"error": {"code": 403, "message": "denied"}} if engine == "gemini"
           else {"code": 4002, "message": "bad"})
    parse = {"tencent": lambda m, r: m.TencentFlashASR.parse_response(json.dumps(r).encode()),
             "gemini": lambda m, r: m.GeminiASR.parse_response(json.dumps(r).encode()),
             "jzx": lambda m, r: m.JzxASR.parse_response(json.dumps(r).encode()),
             "xunfei": lambda m, r: m.XunfeiIatASR.parse_messages(
                 [json.dumps(x) for x in (r if isinstance(r, list) else [r])])}[engine]
    assert parse(tcloud, ok) == parse(jcloud, ok)
    errors = []
    for m in (tcloud, jcloud):
        with pytest.raises(RuntimeError) as e:
            parse(m, err)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_helpers_agree():
    for prompt in ("", "a, b ,c", "x|5,y|7", "天地"):
        assert tcloud.format_hotwords(prompt) == jcloud.format_hotwords(prompt)
    ints = (np.arange(500) * 37 % 65536 - 32768).astype(np.int16)
    assert tcloud.wav_bytes(ints, 8000) == jcloud.wav_bytes(ints, 8000)


@pytest.fixture
def processors(tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(CREDS))
    return ASRProcessor(config_file=str(cfg), device="cpu"), \
        JaxASRProcessor(config_file=str(cfg))


def _patched_clock():
    return mock.patch.multiple(time, time=lambda: 1_700_000_123.5), \
        mock.patch.object(random, "randint", lambda a, b: 777)


@pytest.mark.parametrize("engine", ["tencent_api", "gemini_api", "jzx_api", "xunfei_api"])
@pytest.mark.parametrize("language,prompt", [("auto", ""), ("en", "alpha, beta")])
def test_processor_api_results_and_requests_match_jax(processors, engine, language, prompt):
    audio = _audio(0.4, seed=len(engine))
    out = []
    for proc in processors:
        seen = []
        clock, nonce = _patched_clock()
        with clock, nonce:
            res = proc.asr_detection_api(audio, SR, engine, prompt=prompt, language=language,
                                         transport=_recorder(engine[:-4], seen))
        out.append((res, seen))
    (got, got_req), (want, want_req) = out
    assert got == want and "error" not in got[0] and got[0]["text"]
    assert got_req == want_req and len(got_req) == 1


def test_processor_asr_detection_dispatches_to_the_cloud(processors):
    """asr_detection with a per-call cloud engine (or the processor's own)
    goes to the client over the default transport, here a stub; the
    result is not punctuated, as in the JAX package."""
    audio = _audio(0.5, seed=9)
    out = []
    for proc, module in zip(processors, (tcloud, jcloud)):
        seen = []
        clock, nonce = _patched_clock()
        with clock, nonce, mock.patch.object(module, "urllib_transport",
                                             _recorder("tencent", seen)):
            out.append((proc.asr_detection(audio, SR, asr_engine="tencent_api", prompt="a, b"),
                        seen))
    assert out[0] == out[1]
    assert out[0][0][0]["timestamp"] == [[0, 640], [700, 1500]]
    assert out[0][0][0]["language"] == "zh"


def test_processor_fails_soft_like_jax(processors, tmp_path):
    """Missing credentials, a service error, an HTTP error and the Xunfei
    client without a WebSocket transport: the same empty results with the
    same "error" in both packages; an unknown service likewise."""
    ours, theirs = processors
    audio = _audio(0.2)
    bad = json.dumps({"code": 4002, "message": "bad"}).encode()
    cases = [("tencent_api", _recorder("tencent", [], body=bad)),
             ("jzx_api", lambda *a: (503, b"")), ("xunfei_api", None)]
    for engine, transport in cases:
        got = ours.asr_detection_api(audio, SR, engine, transport=transport)
        assert got == theirs.asr_detection_api(audio, SR, engine, transport=transport)
        assert got[0]["text"] == "" and got[0]["error"]
    empty = [ASRProcessor(config_file=str(tmp_path / "none.json"), device="cpu"),
             JaxASRProcessor(config_file=str(tmp_path / "none.json"))]
    assert empty[0].asr_detection_api(audio, SR, "gemini_api") == \
        empty[1].asr_detection_api(audio, SR, "gemini_api") == \
        [{"text": "", "timestamp": [], "error": "missing credentials"}]
    cfg = tmp_path / "other.json"
    cfg.write_text(json.dumps({"acme": {"key": "k"}}))
    pair = [ASRProcessor(config_file=str(cfg), device="cpu"), JaxASRProcessor(config_file=str(cfg))]
    assert pair[0].asr_detection_api(audio, SR, "acme_api") == \
        pair[1].asr_detection_api(audio, SR, "acme_api")
