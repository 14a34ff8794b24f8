"""Compressed-audio reading in the port against the JAX package: a path that
is not a PCM WAV is decoded by ffmpeg.

A stub `ffmpeg` (a shell script on a temporary PATH) logs its arguments,
prints a seeded float32 stream on stdout and an "Audio: ..." line on
stderr. Both packages' `read_audio` must give the same command line, equal
arrays (bit for bit) and equal rates, for mono, stereo, "N channels" and a
stderr without an Audio line (16000 Hz mono); with no ffmpeg both raise
the same RuntimeError. The JAX module reads its ffmpeg path once at import,
so the tests set its `_FFMPEG`; the port looks ffmpeg up at each call. The
same holds through each entry point that reads: `AudioProcessor.read_audio`
on a path and on a URL (the fetch stubbed), both servers' `POST
/diarization/infer` (an upload with its extension), and both CLIs'
`stream`. A buffer that is not a PCM WAV raises in the port without
calling ffmpeg.
"""

import asyncio
import io
import os
import stat
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

import targetdiarization_tpu.__main__ as jax_cli
import targetdiarization_tpu.utils.audio_io as jax_audio_io
import targetdiarization_tpu_torch.__main__ as port_cli
import targetdiarization_tpu_torch.utils.audio_io as port_audio_io
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu.serve import server as jserver
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.serve import server as tserver

SEED = 1906
NOT_WAV = b"ID3\x04\x00\x00\x00\x00\x00\x00" + bytes(range(256)) * 4  # an mp3's tag, no RIFF


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class StubFFmpeg:
    """An `ffmpeg` script in `root/bin` that appends its command line (the
    path it was run by, then its arguments) to `root/args.log`, one per
    line and "---" after each call, and writes `root/stream.f32` to stdout
    and `root/stderr.txt` to stderr."""

    def __init__(self, root, monkeypatch):
        self.root = str(root)
        os.makedirs(os.path.join(self.root, "bin"))
        self.path = os.path.join(self.root, "bin", "ffmpeg")
        with open(self.path, "w") as f:
            f.write(f"#!/bin/sh\n{{ for a in \"$0\" \"$@\"; do printf '%s\\n' \"$a\"; done; "
                    f"echo ---; }} >> '{self.root}/args.log'\n"
                    f"cat '{self.root}/stream.f32'\ncat '{self.root}/stderr.txt' >&2\n")
        os.chmod(self.path, os.stat(self.path).st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", os.path.dirname(self.path) + os.pathsep + os.environ["PATH"])
        monkeypatch.setattr(jax_audio_io, "_FFMPEG", self.path)

    def serve(self, layout: str | None, sr: int, frames: int, seed: int = SEED) -> np.ndarray:
        """Sets the stream (seeded, interleaved float32 of `frames` frames)
        and the stderr line; returns the stream as ffmpeg would print it."""
        nch = {"mono": 1, "stereo": 2, None: 1}.get(layout) or int(layout.split()[0])
        data = np.random.default_rng(seed).uniform(-1, 1, frames * nch).astype("<f4")
        with open(os.path.join(self.root, "stream.f32"), "wb") as f:
            f.write(data.tobytes())
        with open(os.path.join(self.root, "stderr.txt"), "w") as f:
            f.write("ffmpeg version n6.1 Copyright (c) 2000-2023 the FFmpeg developers\n")
            f.write("Input #0, mp3, from 'in.mp3':\n  Duration: 00:00:01.00, bitrate: 128 kb/s\n")
            if layout is not None:
                f.write(f"  Stream #0:0: Audio: mp3, {sr} Hz, {layout}, fltp, 128 kb/s\n")
        return data

    def calls(self) -> list:
        log = os.path.join(self.root, "args.log")
        if not os.path.exists(log):
            return []
        with open(log) as f:
            return [c.strip("\n").split("\n") for c in f.read().split("---\n") if c.strip()]


@pytest.fixture
def ffmpeg(tmp_path, monkeypatch):
    return StubFFmpeg(tmp_path / "ffmpeg", monkeypatch)


def not_wav(path) -> str:
    with open(path, "wb") as f:
        f.write(NOT_WAV)
    return str(path)


def command(stub: StubFFmpeg, path: str) -> list:
    return [stub.path, "-i", path, "-f", "f32le", "-acodec", "pcm_f32le", "-"]


@pytest.mark.parametrize("layout,sr", [("mono", 22050), ("stereo", 22050), ("6 channels", 8000),
                                       (None, 44100)])
def test_read_audio_decodes_like_jax(ffmpeg, tmp_path, layout, sr):
    stream = ffmpeg.serve(layout, sr, frames=4410)
    path = not_wav(tmp_path / "in.mp3")
    got, got_sr = port_audio_io.read_audio(path)
    want, want_sr = jax_audio_io.read_audio(path)
    assert ffmpeg.calls() == [command(ffmpeg, path)] * 2
    nch = stream.size // 4410
    assert got_sr == want_sr == (16000 if layout is None else sr)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((4410,) if nch == 1 else (nch, 4410))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stream if nch == 1 else stream.reshape(-1, nch).T)


def test_read_audio_resamples_decoded_audio_like_jax(ffmpeg, tmp_path):
    ffmpeg.serve("stereo", 22050, frames=22050)
    path = not_wav(tmp_path / "in.m4a")
    got, got_sr = port_audio_io.read_audio(path, sample_rate=16000)
    want, want_sr = jax_audio_io.read_audio(path, sample_rate=16000)
    assert got_sr == want_sr == 16000 and got.shape == want.shape == (2, 16000)
    np.testing.assert_array_equal(got, want)


def test_no_ffmpeg_raises_as_jax(tmp_path, monkeypatch):
    empty = tmp_path / "empty-bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(jax_audio_io, "_FFMPEG", None)
    path = not_wav(tmp_path / "in.flac")
    with pytest.raises(RuntimeError) as got:
        port_audio_io.read_audio(path)
    with pytest.raises(RuntimeError) as want:
        jax_audio_io.read_audio(path)
    assert str(got.value) == str(want.value)
    assert "ffmpeg is unavailable" in str(got.value)


@pytest.mark.parametrize("wrap", [bytes, bytearray, io.BytesIO])
def test_non_wav_buffer_raises_without_ffmpeg(ffmpeg, wrap):
    ffmpeg.serve("mono", 16000, frames=100)
    with pytest.raises(ValueError, match="not a PCM WAV buffer"):
        port_audio_io.read_audio(wrap(NOT_WAV))
    assert ffmpeg.calls() == []


def test_wav_is_read_without_ffmpeg(ffmpeg, tmp_path):
    audio = np.random.default_rng(SEED + 1).uniform(-0.5, 0.5, 1600).astype(np.float32)
    path = str(tmp_path / "in.wav")
    port_audio_io.write_wav(path, audio, 16000)
    got, sr = port_audio_io.read_audio(path)
    want, _ = jax_audio_io.read_audio(path)
    assert sr == 16000 and ffmpeg.calls() == []
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("url", [None, "https://example.com/a/clip.mp3?sig=1"])
def test_audio_processor_reads_path_and_url_like_jax(ffmpeg, tmp_path, monkeypatch, url):
    stream = ffmpeg.serve("mono", 22050, frames=2205)
    fetched = []

    def fake(u, path):
        fetched.append(path)
        return not_wav(path), None

    monkeypatch.setattr(urllib.request, "urlretrieve", fake)
    source = url or not_wav(tmp_path / "in.ogg")
    got, got_sr = AudioProcessor(device="cpu").read_audio(source)
    want, want_sr = JaxAudioProcessor().read_audio(source)
    paths = fetched if url else [source, source]
    assert len(paths) == 2 and ffmpeg.calls() == [command(ffmpeg, p) for p in paths]
    if url:  # each fetched to a temporary file named after the URL's, then deleted
        assert all(p.endswith("_clip.mp3") and not os.path.exists(p) for p in paths)
    assert got_sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stream)


class _ReadingModel:
    """A served model whose `infer` reads its inputs as
    `TargetDiarization.infer` does (`self.ap.read_audio`) and returns the
    decoded mixture as the target audio."""

    def __init__(self, ap):
        self.ap = ap

    def infer(self, wav_file, target_file=None, sampling_rate=16000, is_single=False,
              output_target_audio=True):
        audio, sr = self.ap.read_audio(wav_file)
        target, target_sr = self.ap.read_audio(target_file)
        seg = {"speaker": "1", "timerange": [0.0, round(audio.shape[-1] / sr, 3)],
               "text": f"{sr} {target_sr} {target.shape[-1]}", "type": "single"}
        return "1", [seg], audio


def test_rest_upload_is_decoded_like_jax(ffmpeg):
    ffmpeg.serve("mono", 22050, frames=4410)

    async def post(module, model):
        async with TestClient(TestServer(module.create_app(model))) as client:
            form = FormData()
            form.add_field("audio_file", NOT_WAV, filename="mix.mp3")
            form.add_field("target_file", NOT_WAV, filename="enroll.m4a")
            return await (await client.post("/diarization/infer", data=form)).json()

    got = asyncio.run(post(tserver, _ReadingModel(AudioProcessor(device="cpu"))))
    want = asyncio.run(post(jserver, _ReadingModel(JaxAudioProcessor())))
    assert got["success"] and want["success"], (got, want)
    assert got["data"] == want["data"]
    assert got["data"]["results"][0]["text"] == "22050 22050 4410"
    calls = ffmpeg.calls()
    assert [os.path.splitext(c[2])[1] for c in calls] == [".mp3", ".m4a"] * 2
    assert all(c == command(ffmpeg, c[2]) and not os.path.exists(c[2]) for c in calls)


def test_cli_stream_decodes_like_jax(ffmpeg, tmp_path, monkeypatch):
    stream = ffmpeg.serve("mono", 16000, frames=40000)
    path = not_wav(tmp_path / "talk.mp3")

    class Recorder:
        def infer_stream(self, chunks, **kw):
            self.chunks, self.kw = [np.asarray(c) for c in chunks], kw
            return iter(())

    ours, theirs = Recorder(), Recorder()
    monkeypatch.setattr(port_cli, "_build", lambda args: ours)
    monkeypatch.setattr(jax_cli, "_build_stream_model", lambda: theirs)
    port_cli.main(["--device", "cpu", "stream", path])
    jax_cli.main(["stream", path])
    assert ffmpeg.calls() == [command(ffmpeg, path)] * 2
    assert ours.kw == theirs.kw and ours.kw["sampling_rate"] == 16000
    assert [c.shape for c in ours.chunks] == [c.shape for c in theirs.chunks] \
        == [(16000,), (16000,), (8000,)]
    np.testing.assert_array_equal(np.concatenate(ours.chunks), np.concatenate(theirs.chunks))
    np.testing.assert_array_equal(np.concatenate(ours.chunks), stream)
