"""Cloud ASR clients with injectable transports.

Copy of targetdiarization_tpu/processors/cloud_asr.py (standard library
only; the port keeps its own copy, as it does of every module it needs).
The four hosted services the reference drives through vendor SDKs speak
their wire protocols here: URL construction, parameter canonicalization,
request signing and response parsing, with the HTTP or WebSocket
transport an injectable callable. The default HTTP transport is urllib;
the Xunfei client needs a WebSocket transport given to it. Clock and
nonce sources are injectable too, so a request is reproducible.

Protocols:
- Tencent "flash" one-shot ASR:
    POST https://asr.cloud.tencent.com/asr/flash/v1/<appid>?<sorted qs>
    Authorization: base64(HMAC-SHA1(secret_key,
        "POST" + host + path + "?" + sorted_qs))
    body: raw audio bytes
    response: {"code": 0, "flash_result": [{"text": ...}], ...}
- Gemini generateContent with inline audio:
    POST {base}/v1beta/models/<model>:generateContent  x-goog-api-key
    body: contents=[text prompt, inline_data audio], temperature 0,
    thinkingBudget 0; response candidates[0].content.parts[0].text
- Xunfei (iFlytek) IAT v2 over WebSocket: HMAC-SHA256 signature over
  "host: h\ndate: d\nGET /v2/iat HTTP/1.1" -> authorization query param;
  audio framed as base64 chunks with status 0/1/2; result text
  assembled from data.result.ws[].cw[].w.
- JZX private REST endpoint:
    POST <endpoint> json={source_type: 2, data: b64 wav, voice_format,
    context, enable_word_timestamps}; response
    {code: 0, data: {text, word_list: [{word, start, end}]}}
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import random
import time
from urllib.parse import quote


def urllib_transport(method: str, url: str, headers: dict, body: bytes):
    """Default live transport: (status_code, response_bytes)."""
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


class TencentFlashASR:
    """Native client for Tencent Cloud Flash Recognition (the engine
    behind the reference's `tencent` path, ASRProcessor.py:540-590)."""

    HOST = "asr.cloud.tencent.com"

    def __init__(self, appid: str, secret_id: str, secret_key: str,
                 transport=None, clock=None, rng=None):
        self.appid = str(appid)
        self.secret_id = secret_id
        self.secret_key = secret_key
        self.transport = transport or urllib_transport
        self._clock = clock or (lambda: int(time.time()))
        self._rng = rng or (lambda: random.randint(0, 10**10))

    # -------- request construction (pure, tested) --------

    def build_params(self, engine_type: str = "16k_zh",
                     voice_format: str = "wav", hotword_list: str = "",
                     word_info: int = 0) -> dict:
        now = self._clock()
        params = {
            "secretid": self.secret_id,
            "engine_type": engine_type,
            "voice_format": voice_format,
            "timestamp": str(now),
            "expired": str(now + 24 * 3600),
            "nonce": str(self._rng()),
            "word_info": str(word_info),
        }
        if hotword_list:
            params["hotword_list"] = hotword_list
        return params

    def canonical_query(self, params: dict) -> str:
        """Key-sorted query string — the exact string that gets signed
        (values are NOT url-encoded in the signature source, per the
        flash-recognizer signing scheme; encoding happens only in the
        request URL)."""
        return "&".join(f"{k}={params[k]}" for k in sorted(params))

    def sign(self, params: dict) -> str:
        source = ("POST" + self.HOST + f"/asr/flash/v1/{self.appid}?"
                  + self.canonical_query(params))
        digest = hmac.new(self.secret_key.encode("utf-8"),
                          source.encode("utf-8"), hashlib.sha1).digest()
        return base64.b64encode(digest).decode("ascii")

    def build_request(self, audio_bytes: bytes, engine_type: str = "16k_zh",
                      voice_format: str = "wav", hotword_list: str = ""):
        """→ (url, headers, body). Deterministic given clock/rng."""
        params = self.build_params(engine_type, voice_format, hotword_list)
        signature = self.sign(params)
        encoded = "&".join(
            f"{k}={quote(str(params[k]), safe='')}" for k in sorted(params))
        url = f"https://{self.HOST}/asr/flash/v1/{self.appid}?{encoded}"
        headers = {
            "Authorization": signature,
            "Content-Type": "application/octet-stream",
            "Host": self.HOST,
        }
        return url, headers, audio_bytes

    # -------- response parsing (pure, tested) --------

    @staticmethod
    def parse_response(body: bytes) -> dict:
        """→ {'text', 'sentences': [{'text', 'start_ms', 'end_ms'}...]}.
        Raises RuntimeError on a service-side error code."""
        res = json.loads(body.decode("utf-8"))
        if res.get("code", 0) != 0:
            raise RuntimeError(
                f"tencent asr error {res.get('code')}: {res.get('message')}")
        flash = res.get("flash_result") or []
        if not flash:
            return {"text": "", "sentences": []}
        first = flash[0]
        sentences = [
            {
                "text": s.get("text", ""),
                "start_ms": int(s.get("start_time", 0)),
                "end_ms": int(s.get("end_time", 0)),
            }
            for s in first.get("sentence_list") or []
        ]
        return {"text": first.get("text", ""), "sentences": sentences}

    # -------- end-to-end --------

    def recognize(self, audio_bytes: bytes, engine_type: str = "16k_zh",
                  voice_format: str = "wav", hotword_list: str = "") -> dict:
        url, headers, body = self.build_request(
            audio_bytes, engine_type, voice_format, hotword_list)
        status, resp = self.transport("POST", url, headers, body)
        if status != 200:
            raise RuntimeError(f"tencent asr HTTP {status}")
        return self.parse_response(resp)


class GeminiASR:
    """Native REST client for the reference's Gemini transcription path
    (ASRProcessor.py:298-371): generateContent with the audio inlined,
    deterministic decoding (temperature 0, thinking budget 0), and the
    exact prompt contract (pure transcript, empty string if
    unintelligible)."""

    DEFAULT_BASE = "https://generativelanguage.googleapis.com"

    def __init__(self, api_key: str, base_url: str = "",
                 model_id: str = "gemini-2.5-flash", transport=None):
        self.api_key = api_key
        self.base_url = (base_url or self.DEFAULT_BASE).rstrip("/")
        self.model_id = model_id
        self.transport = transport or urllib_transport

    # -------- request construction (pure, tested) --------

    @staticmethod
    def build_prompt(audio_language: str = "unknown",
                     asr_language: str = "zh-CN") -> str:
        """The reference's transcription prompt (ASRProcessor.py:333-348)
        — kept byte-identical so cloud results match across frameworks."""
        if audio_language == "unknown":
            language_instruction = ("You MUST automatically detect the "
                                    "language from the audio.")
        else:
            language_instruction = (f"The language spoken in the audio is "
                                    f"`{audio_language}`.")
        return f"""
**Task**: Transcribe the attached audio file.

**Instructions**:
1.  **Audio Language**: {language_instruction}
2.  **Output Language**: The final transcription text must be in `{asr_language}`.
3.  **Output Format**:
    - Provide only the pure, transcribed text.
    - Do NOT include any headers, introductory phrases (e.g., "Here is the transcription:"), or any other extraneous information.
4.  **Handling Uncertainty**:
    - If the audio is inaudible or the content is unintelligible, you MUST output an empty string: `""`.
""".strip()

    def build_request(self, audio_bytes: bytes, mime_type: str = "audio/wav",
                      audio_language: str = "unknown",
                      asr_language: str = "zh-CN"):
        """→ (url, headers, body). Deterministic."""
        url = (f"{self.base_url}/v1beta/models/"
               f"{self.model_id}:generateContent")
        headers = {
            "Content-Type": "application/json",
            "x-goog-api-key": self.api_key,
        }
        payload = {
            "contents": [{
                "role": "user",
                "parts": [
                    {"text": self.build_prompt(audio_language, asr_language)},
                    {"inline_data": {
                        "mime_type": mime_type,
                        "data": base64.b64encode(audio_bytes).decode("ascii"),
                    }},
                ],
            }],
            "generationConfig": {
                "temperature": 0.0,
                "thinkingConfig": {"thinkingBudget": 0},
            },
        }
        return url, headers, json.dumps(payload).encode("utf-8")

    # -------- response parsing (pure, tested) --------

    @staticmethod
    def parse_response(body: bytes) -> str:
        res = json.loads(body.decode("utf-8"))
        if "error" in res:
            err = res["error"]
            raise RuntimeError(
                f"gemini error {err.get('code')}: {err.get('message')}")
        cands = res.get("candidates") or []
        if not cands:
            return ""
        content = cands[0].get("content") or {}
        parts = content.get("parts") or []
        if not parts:
            return ""
        return (parts[0].get("text") or "").strip()

    # -------- end-to-end --------

    def get_result(self, audio_bytes: bytes, mime_type: str = "audio/wav",
                   audio_language: str = "unknown",
                   asr_language: str = "zh-CN") -> str:
        url, headers, body = self.build_request(
            audio_bytes, mime_type, audio_language, asr_language)
        status, resp = self.transport("POST", url, headers, body)
        if status != 200:
            raise RuntimeError(f"gemini HTTP {status}")
        return self.parse_response(resp)


class JzxASR:
    """Native client for the reference's private JZX REST endpoint
    (ASRProcessor.py:672-739): base64 WAV in a JSON POST, word-level
    timestamps back."""

    def __init__(self, endpoint: str, transport=None):
        self.endpoint = endpoint
        self.transport = transport or urllib_transport

    def build_request(self, wav_pcm_bytes: bytes, context: str = ""):
        headers = {"Content-Type": "application/json; charset=utf-8"}
        payload = {
            "source_type": 2,
            "data": base64.b64encode(wav_pcm_bytes).decode("utf-8"),
            "voice_format": "wav",
            "context": context,
            "enable_word_timestamps": True,
        }
        return self.endpoint, headers, json.dumps(payload).encode("utf-8")

    @staticmethod
    def parse_response(body: bytes) -> dict:
        """→ {'text', 'words': [(word, [start, end]), ...]}
        (the reference's timestamp tuple shape, ASRProcessor.py:726-728)."""
        res = json.loads(body.decode("utf-8"))
        if res.get("code", 0) != 0:
            raise RuntimeError(
                f"jzx error {res.get('code')}: {res.get('message')}")
        data = res.get("data") or {}
        words = [(str(w["word"]), [float(w["start"]), float(w["end"])])
                 for w in data.get("word_list") or []]
        return {"text": data.get("text", ""), "words": words}

    def recognize(self, wav_pcm_bytes: bytes, context: str = "") -> dict:
        url, headers, body = self.build_request(wav_pcm_bytes, context)
        status, resp = self.transport("POST", url, headers, body)
        if status != 200:
            raise RuntimeError(f"jzx HTTP {status}")
        return self.parse_response(resp)


class XunfeiIatASR:
    """Native client for iFlytek's IAT v2 WebSocket protocol — the
    service the reference's appid/api_key/api_secret credentials drive
    (ASRProcessor.py:167-172; its XunfeiASR module is external to the
    tree, so this implements the documented open protocol).

    The WS transport is injectable: a callable (url, frames) -> list of
    response message strings, where frames is the ordered list of JSON
    text frames this client would send."""

    HOST = "iat-api.xfyun.cn"
    PATH = "/v2/iat"
    FRAME_SIZE = 1280  # 40 ms of 16 kHz PCM16 per frame (spec default)

    def __init__(self, appid: str, api_key: str, api_secret: str,
                 transport=None, clock=None):
        self.appid = appid
        self.api_key = api_key
        self.api_secret = api_secret
        self.transport = transport
        self._clock = clock or time.time

    # -------- auth URL (pure, tested) --------

    def _rfc1123(self) -> str:
        from email.utils import formatdate

        return formatdate(self._clock(), usegmt=True)

    def signature_origin(self, date: str) -> str:
        return (f"host: {self.HOST}\ndate: {date}\n"
                f"GET {self.PATH} HTTP/1.1")

    def build_url(self) -> str:
        date = self._rfc1123()
        digest = hmac.new(self.api_secret.encode("utf-8"),
                          self.signature_origin(date).encode("utf-8"),
                          hashlib.sha256).digest()
        signature = base64.b64encode(digest).decode("ascii")
        origin = (f'api_key="{self.api_key}", algorithm="hmac-sha256", '
                  f'headers="host date request-line", '
                  f'signature="{signature}"')
        authorization = base64.b64encode(
            origin.encode("utf-8")).decode("ascii")
        qs = "&".join([
            f"authorization={quote(authorization, safe='')}",
            f"date={quote(date, safe='')}",
            f"host={self.HOST}",
        ])
        return f"wss://{self.HOST}{self.PATH}?{qs}"

    # -------- frame construction (pure, tested) --------

    def build_frames(self, pcm16_bytes: bytes, language: str = "zh_cn",
                     hotword: str = "") -> list:
        """Audio → ordered JSON text frames (status 0 first / 1 middle /
        2 last; business+common config only on the first frame)."""
        chunks = [pcm16_bytes[i:i + self.FRAME_SIZE]
                  for i in range(0, max(len(pcm16_bytes), 1),
                                 self.FRAME_SIZE)]
        business = {"domain": "iat", "language": language,
                    "accent": "mandarin", "vad_eos": 10000, "ptt": 1}
        if hotword:
            business["hotword_id"] = hotword
        frames = []
        for i, chunk in enumerate(chunks):
            status = 0 if i == 0 else (2 if i == len(chunks) - 1 else 1)
            if len(chunks) == 1:
                status = 2
            frame = {
                "data": {
                    "status": status,
                    "format": "audio/L16;rate=16000",
                    "encoding": "raw",
                    "audio": base64.b64encode(chunk).decode("ascii"),
                },
            }
            if i == 0:
                frame["common"] = {"app_id": self.appid}
                frame["business"] = business
                if len(chunks) > 1:
                    frame["data"]["status"] = 0
            frames.append(json.dumps(frame))
        return frames

    # -------- response parsing (pure, tested) --------

    @staticmethod
    def parse_messages(messages: list) -> str:
        """Assemble the transcript from IAT result messages, honoring
        dynamic-correction replacement (pgs == 'rpl' replaces the
        sentence range [rg0, rg1])."""
        segments = {}
        for msg in messages:
            res = json.loads(msg) if isinstance(msg, str) else msg
            if res.get("code", 0) != 0:
                raise RuntimeError(
                    f"xunfei error {res.get('code')}: {res.get('message')}")
            data = res.get("data") or {}
            result = data.get("result") or {}
            sn = int(result.get("sn", len(segments)))
            text = "".join(
                cw.get("w", "")
                for ws in result.get("ws") or []
                for cw in ws.get("cw") or [])
            if result.get("pgs") == "rpl":
                lo, hi = result.get("rg", [sn, sn])[:2]
                for k in list(segments):
                    if lo <= k <= hi:
                        del segments[k]
            segments[sn] = text
        return "".join(segments[k] for k in sorted(segments))

    # -------- end-to-end --------

    def get_result(self, pcm16_bytes: bytes, language: str = "zh_cn",
                   hotword: str = "") -> str:
        if self.transport is None:
            raise RuntimeError(
                "xunfei: no WebSocket transport available in this "
                "environment (inject one)")
        url = self.build_url()
        frames = self.build_frames(pcm16_bytes, language, hotword)
        messages = self.transport(url, frames)
        return self.parse_messages(messages)


def format_hotwords(prompt: str) -> str:
    """Reference hotword formatting: 'a, b' → 'a|11,b|11'
    (ASRProcessor.py:564-566)."""
    if not prompt or "|" in prompt:
        return prompt
    return ",".join(f"{w.strip()}|11" for w in prompt.split(","))


def wav_bytes(audio, sr: int) -> bytes:
    """PCM16 WAV container for an ndarray (the upload format)."""
    import io
    import wave

    import numpy as np

    a = np.asarray(audio)
    if a.dtype.kind == "f":
        a = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(a.tobytes())
    return buf.getvalue()
