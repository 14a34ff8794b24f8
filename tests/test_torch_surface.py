"""The rest of the port's public surface against the JAX package, on the CPU:
`AudioProcessor`'s DSP toolbox, converters, writing and URL input,
`ASRProcessor.f0_compute`, the host `Tracer` of `runtime/trace.py`, the
package root's names, and `utils/audio_io.py`'s writers.

Inputs are seeded numpy arrays and synthesized speech. URL fetches are
stubbed (`urllib.request.urlretrieve`); nothing touches the network.

Limits, and why:
- host code copied from the JAX package (silence splitting, noise, the
  frequency mix, F0, the writers): equal results;
- work on the device (compression, mixing, EQ matching): 1e-5 of the
  peak, float32 rounding;
- the phase vocoder (`audio_stretch`, and `audio_pitch_shift` on it):
  given the JAX package's STFT, the port's host part gives the same
  samples. The packages' float32 STFTs differ by about 1.2e-7 of their
  peak, and the vocoder adds up each frame's phase advance over the
  whole clip, so the end to end results part by 3.3e-5-1.0e-4 of the
  peak on 1.5 s and by up to 3.5e-4 on 4 s; they are held to 1e-3.
"""

import io
import os
import threading
import time
import urllib.request
import wave

import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, synth_utterance
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu.utils import audio_io as jio
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.runtime import trace as ttrace
from targetdiarization_tpu_torch.utils import audio_io as tio

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def aps():
    return AudioProcessor(device="cpu"), JaxAudioProcessor()


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _speech(seconds: float, seed: int, gaps: bool = False) -> np.ndarray:
    """Utterances of the synthetic voice, 0.8 s of silence between them when
    `gaps`, and a little noise."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * SR), np.float32)
    pos = 0
    while pos < len(out):
        utt = synth_utterance("".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))]
                                      for _ in range(6)), rng)[0]
        n = min(len(utt), len(out) - pos)
        out[pos: pos + n] = utt[:n]
        pos += n + (int(0.8 * SR) if gaps else 0)
    return out + (1e-3 * rng.standard_normal(len(out))).astype(np.float32)


# ---------------- converters and channels ----------------


def test_float32_to_int16_and_mono_to_stereo_match_jax(aps):
    ours, theirs = aps
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 1000).astype(np.float32)
    np.testing.assert_array_equal(ours.float32_to_int16(x), theirs.float32_to_int16(x))
    assert ours.float32_to_int16(np.float32([1.0, -1.0, 0.99999])).tolist() == [32767, -32768, 32767]
    for a in (x, np.stack([x, -x], axis=1)):
        got, want = ours.mono_to_stereo(a), theirs.mono_to_stereo(a)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------- level and silence ----------------


@pytest.mark.parametrize("threshold_db,ratio", [(-20.0, 4.0), (-35.0, 2.0)])
def test_audio_compress_matches_jax(aps, threshold_db, ratio):
    ours, theirs = aps
    x = _speech(1.0, 1)
    got, want = ours.audio_compress(x, threshold_db, ratio), theirs.audio_compress(x, threshold_db, ratio)
    assert _rel(got, want) <= 1e-5
    assert np.abs(got).max() < np.abs(x).max()


@pytest.mark.parametrize("min_chunk_sec", [0.5, 5.0])
def test_split_and_remove_silence_match_jax(aps, min_chunk_sec):
    ours, theirs = aps
    x = _speech(6.0, 2, gaps=True)
    got = ours.split_audio_by_silence(x, SR, min_chunk_sec=min_chunk_sec)
    want = theirs.split_audio_by_silence(x, SR, min_chunk_sec=min_chunk_sec)
    assert len(got) == len(want) and (len(got) > 1) is (min_chunk_sec < 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ours.remove_silence(x, SR, min_chunk_sec=min_chunk_sec),
                                  theirs.remove_silence(x, SR, min_chunk_sec=min_chunk_sec))
    assert ours.split_audio_by_silence(x[:0], SR) == theirs.split_audio_by_silence(x[:0], SR) == []
    short = ours.split_audio_by_silence(x[:100], SR)  # under one 20 ms window
    assert len(short) == 1 and np.array_equal(short[0], x[:100])


# ---------------- synthesis and mixing ----------------


@pytest.mark.parametrize("kind", ["white", "pink", "brown"])
def test_generate_noise_matches_jax(aps, kind):
    ours, theirs = aps
    got = ours.generate_noise(1.5, SR, kind, amplitude=0.2, seed=4)
    np.testing.assert_array_equal(got, theirs.generate_noise(1.5, SR, kind, amplitude=0.2, seed=4))
    assert len(got) == 24000 and abs(np.abs(got).max() - 0.2) < 1e-6
    with pytest.raises(ValueError, match="unknown noise"):
        ours.generate_noise(1.0, SR, "blue")


@pytest.mark.parametrize("snr_db", [None, 10.0])
def test_mix_audio_matches_jax(aps, snr_db):
    ours, theirs = aps
    a, b = _speech(1.0, 3), _speech(0.7, 4)
    assert _rel(ours.mix_audio(a, b, snr_db), theirs.mix_audio(a, b, snr_db)) <= 1e-5


def test_mix_audio_by_freq_matches_jax(aps):
    ours, theirs = aps
    a, b = _speech(1.0, 5), _speech(1.2, 6)
    np.testing.assert_array_equal(ours.mix_audio_by_freq(a, b, SR, 800.0),
                                  theirs.mix_audio_by_freq(a, b, SR, 800.0))


@pytest.mark.parametrize("smooth", [1, 9])
def test_eq_match_matches_jax(aps, smooth):
    ours, theirs = aps
    src = _speech(1.5, 7)
    tgt = np.convolve(_speech(2.0, 8), [0.5, 0.3, 0.2], mode="same").astype(np.float32)
    got = ours.eq_match(src, tgt, SR, smooth=smooth)
    assert len(got) == len(src)
    assert _rel(got, theirs.eq_match(src, tgt, SR, smooth=smooth)) <= 1e-5


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.25])
def test_audio_stretch_matches_jax(aps, rate):
    ours, theirs = aps
    x = _speech(1.5, 9)
    got, want = ours.audio_stretch(x, SR, rate), theirs.audio_stretch(x, SR, rate)
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("rate", [0.8, 1.25])
def test_audio_stretch_host_part_is_the_jax_packages(aps, monkeypatch, rate):
    """Handed the JAX package's STFT, the port's phase advance, inverse FFTs
    and overlap-add give the JAX package's samples exactly."""
    import jax.numpy as jnp

    from targetdiarization_tpu.ops.stft import stft as jax_stft
    from targetdiarization_tpu_torch.processors import audio as port_audio

    ours, theirs = aps
    x = _speech(1.5, 9)

    def stft_of_jax(t, n_fft, hop):
        s = jax_stft(jnp.asarray(t.numpy()), n_fft, hop)
        return torch.complex(torch.from_numpy(np.array(s.real)), torch.from_numpy(np.array(s.imag)))

    monkeypatch.setattr(port_audio, "stft", stft_of_jax)
    np.testing.assert_array_equal(ours.audio_stretch(x, SR, rate), theirs.audio_stretch(x, SR, rate))


@pytest.mark.parametrize("n_semitones", [-3.0, 0, 2.5])
def test_audio_pitch_shift_matches_jax(aps, n_semitones):
    ours, theirs = aps
    x = _speech(1.0, 10)
    got = ours.audio_pitch_shift(x, SR, n_semitones)
    assert len(got) == len(x)
    assert _rel(got, theirs.audio_pitch_shift(x, SR, n_semitones)) <= 1e-3


# ---------------- writing and URLs ----------------


def test_write_to_file_matches_jax(aps, tmp_path):
    ours, theirs = aps
    x = _speech(0.5, 11)
    paths = [str(tmp_path / f"{n}.wav") for n in ("ours", "theirs")]
    assert ours.write_to_file(x, SR, paths[0]) == paths[0]
    theirs.write_to_file(x, SR, paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()


def _serve_wav(audio):
    """A urlretrieve stand-in that writes `audio` as a WAV and records the
    (url, path) it was given."""
    calls = []

    def fake(url, path):
        calls.append((url, path))
        tio.write_wav(path, audio, SR)
        return path, None

    return fake, calls


@pytest.mark.parametrize("url,suffix", [
    ("https://example.com/a/clip.mp3?sig=1#x", "_clip.mp3"),
    ("http://example.com/audio/", "_audio.wav"),
    ("HTTPS://example.com/", "_example.com"),
])
def test_download_audio_names_like_jax(aps, monkeypatch, tmp_path, url, suffix):
    ours, theirs = aps
    fake, calls = _serve_wav(np.zeros(160, np.float32))
    monkeypatch.setattr(urllib.request, "urlretrieve", fake)
    got = ours.download_audio(url, output_dir=str(tmp_path))
    want = theirs.download_audio(url, output_dir=str(tmp_path))
    assert ours.is_url(url) and theirs.is_url(url)
    assert os.path.dirname(got) == str(tmp_path) and os.path.exists(got)
    assert os.path.basename(got).startswith("td_") and got.endswith(suffix)
    assert os.path.basename(got)[12:] == os.path.basename(want)[12:]  # past "td_<8 hex>"
    assert [u for u, _ in calls] == [url, url]


def test_download_failure_removes_the_partial_file(aps, monkeypatch, tmp_path):
    ours, _ = aps
    seen = []

    def failing(url, path):
        seen.append(path)
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("connection reset")

    monkeypatch.setattr(urllib.request, "urlretrieve", failing)
    with pytest.raises(RuntimeError, match="download failed"):
        ours.download_audio("https://example.com/x.wav", output_dir=str(tmp_path))
    assert seen and not os.path.exists(seen[0]) and not os.listdir(tmp_path)
    assert not ours.is_url("/tmp/x.wav") and not ours.is_url(b"http://")


def test_read_audio_from_a_url(aps, monkeypatch, tmp_path):
    """A URL is fetched to the temporary directory, read, resampled when a
    rate is asked for, and the fetched file deleted."""
    ours, theirs = aps
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    x = _speech(0.5, 12)
    fake, calls = _serve_wav(x)
    monkeypatch.setattr(urllib.request, "urlretrieve", fake)
    audio, sr = ours.read_audio("https://example.com/voice.wav")
    assert sr == SR and np.abs(audio - x).max() <= 1 / 32768
    assert calls[0][1].startswith(str(tmp_path)) and not os.path.exists(calls[0][1])
    got = ours.read_audio("https://example.com/voice.wav", sampling_rate=8000)
    want = theirs.read_audio(_local_copy(tmp_path, x), sampling_rate=8000)
    assert got[1] == want[1] == 8000 and _rel(got[0], want[0]) <= 1e-6
    assert os.listdir(tmp_path) == ["local.wav"]


def _local_copy(tmp_path, x) -> str:
    path = str(tmp_path / "local.wav")
    tio.write_wav(path, x, SR)
    return path


# ---------------- F0 ----------------


@pytest.mark.parametrize("case", ["speech", "tone", "short", "silence"])
def test_f0_compute_matches_jax(case):
    t = np.arange(SR) / SR
    x = {"speech": _speech(1.0, 13), "tone": (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32),
         "short": np.ones(500, np.float32), "silence": np.zeros(SR, np.float32)}[case]
    got = ASRProcessor(device="cpu").f0_compute(x, SR)
    want = JaxASRProcessor.f0_compute(None, x, SR)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case == "tone":
        assert abs(np.median(got) - 180.0) < 3.0


# ---------------- the host tracer ----------------


def test_tracer_totals_nested_spans_in_two_threads(monkeypatch):
    """Joined names, one call a span, host seconds at least the span's
    sleep, both threads' calls counted; the profiler hooks still run."""
    tracer = ttrace.Tracer()
    seen = []
    monkeypatch.setattr(ttrace, "HOOKS", [lambda name, entering: seen.append((name, entering))])
    barrier = threading.Barrier(2)

    def work():
        barrier.wait()
        with ttrace.trace("outer", tracer):
            time.sleep(0.02)
            for _ in range(2):
                with ttrace.trace("inner", tracer):
                    time.sleep(0.01)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    d = tracer.as_dict()
    assert set(d) == {"outer", "outer/inner"}
    assert d["outer"]["calls"] == 2 and d["outer/inner"]["calls"] == 4
    assert d["outer"]["total_s"] >= 2 * 0.04 and d["outer/inner"]["total_s"] >= 4 * 0.01
    assert d["outer"]["total_s"] > d["outer/inner"]["total_s"]
    assert seen.count(("outer/inner", True)) == seen.count(("outer/inner", False)) == 4
    lines = tracer.report().splitlines()
    assert lines[0].split() == ["stage", "total_s", "calls", "mean_ms"]
    assert lines[1].split()[0] == "outer" and lines[2].split()[:3][2] == "4"
    tracer.reset()
    assert tracer.as_dict() == {} and len(tracer.report().splitlines()) == 1


def test_global_tracer_and_enabled(monkeypatch):
    ttrace.reset()
    with ttrace.trace("stage_x"):
        pass
    assert ttrace.GLOBAL_TRACER.as_dict()["stage_x"]["calls"] == 1
    assert "stage_x" in ttrace.report()
    ttrace.reset()
    assert ttrace.GLOBAL_TRACER.as_dict() == {}
    monkeypatch.setenv("TD_TRACE", "1")
    assert ttrace.enabled()
    monkeypatch.setenv("TD_TRACE", "0")
    assert not ttrace.enabled()


def test_processor_spans_reach_the_global_tracer():
    ttrace.reset()
    AudioProcessor(device="cpu").restore_audio(np.zeros(100, np.float32))
    assert ttrace.GLOBAL_TRACER.as_dict()["audio/restore_audio"]["calls"] == 1
    ttrace.reset()


# ---------------- the package root ----------------


def test_package_root_exports_the_entry_points():
    import targetdiarization_tpu_torch as pkg
    from targetdiarization_tpu_torch.pipeline.offline import TargetDiarization
    from targetdiarization_tpu_torch.pipeline.streaming import TargetDiarizationStream
    from targetdiarization_tpu_torch.pipeline.target_asr import TargetASR

    import targetdiarization_tpu as jpkg

    assert set(pkg._API) == set(jpkg._API)
    assert (pkg.TargetDiarization, pkg.TargetDiarizationStream, pkg.TargetASR,
            pkg.AudioProcessor, pkg.ASRProcessor) == (
        TargetDiarization, TargetDiarizationStream, TargetASR, AudioProcessor, ASRProcessor)
    with pytest.raises(AttributeError, match="no attribute"):
        pkg.NoSuchName  # noqa: B018


# ---------------- audio_io ----------------


def _all_int16_wav() -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.arange(-32768, 32768, dtype="<i2").tobytes())
    return buf.getvalue()


def test_write_wav_round_trips_every_int16(tmp_path):
    """Read (÷32768) and written again (×32768, truncated), each of the
    65536 values comes back unchanged."""
    audio, sr = tio.read_wav(_all_int16_wav())
    path = str(tmp_path / "all.wav")
    tio.write_wav(path, audio, sr)
    with wave.open(path, "rb") as w:
        back = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_array_equal(back, np.arange(-32768, 32768))


@pytest.mark.parametrize("shape", [(1500,), (2, 1500)])
def test_write_wav_writes_the_jax_writers_bytes(tmp_path, shape):
    x = np.random.default_rng(1).uniform(-1.1, 1.1, shape).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    tio.write_wav(ours, x, 22050)
    jio.write_wav(theirs, x, 22050)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back, sr = tio.read_wav(ours)
    assert sr == 22050 and back.shape == shape


def test_write_audio_and_byte_converters_match_jax(tmp_path):
    x = np.random.default_rng(2).uniform(-1.0, 1.0, (2, 400)).astype(np.float32)
    tio.write_audio(tmp_path / "a.wav", x, SR)
    jio.write_audio(tmp_path / "b.wav", x, SR)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    raw = tio.float32_to_int16_bytes(x)
    assert raw == jio.float32_to_int16_bytes(x)
    np.testing.assert_array_equal(tio.int16_bytes_to_float32(raw), jio.int16_bytes_to_float32(raw))
