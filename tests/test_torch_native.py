"""The port's host library (`utils/native.py`, `csrc/host/tdaudio.cpp`)
against the JAX package's (`utils/native.py`, `native/tdaudio.cpp`) and
against its own numpy versions.

The port's library is built here with g++ into the package's `_build/`.
Inputs are seeded numpy arrays. Limits, and why:
- PCM marshalling and `resample_linear`: bit-equal; the same float32 and
  float64 operations in the same order, with no fused multiply-add;
- the ring buffer: equal counts, sizes, spaces and popped samples over a
  seeded sequence of pushes and pops;
- integrated loudness: within 1e-9 LU. The two libraries share the code,
  and the numpy meter filters in scipy's direct form II transposed, whose
  float64 rounding moves the result by about 1e-14 LU; the -inf cases
  (silence, everything under the absolute gate) agree exactly.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import two_voice_mix
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu.utils import native as jax_native
from targetdiarization_tpu_torch.ops.kernels import _build
from targetdiarization_tpu_torch.ops.loudness import integrated_loudness
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.utils import native

SEED = 1907
LU_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both packages' libraries, built and loaded (the JAX package builds
    its own from native/build.sh where it is missing)."""
    assert native.has_native() and os.path.exists(native.library_path())
    assert jax_native.has_native()


def rng(k: int = 0) -> np.random.Generator:
    return np.random.default_rng(SEED + k)


def test_pcm16_to_f32_bit_equal():
    pcm = np.concatenate([np.arange(-32768, 32768, dtype=np.int16),
                          rng().integers(-32768, 32768, 5000).astype(np.int16)])
    got = native.pcm16_to_f32(pcm)
    assert got.dtype == np.float32 and got.shape == pcm.shape
    np.testing.assert_array_equal(got, jax_native.pcm16_to_f32(pcm))
    np.testing.assert_array_equal(got, native.pcm16_to_f32_plain(pcm))
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm.reshape(-1, 2)), got.reshape(-1, 2))


def test_f32_to_pcm16_bit_equal():
    ties = (np.arange(-40, 40) + 0.5) / 32768.0  # rounded to even, as lrintf does
    audio = np.concatenate([rng(1).uniform(-1.5, 1.5, 20000), ties,
                            [1.0, -1.0, 32767.5 / 32768, -32768.5 / 32768, 0.0]]).astype(np.float32)
    got = native.f32_to_pcm16(audio)
    assert got.dtype == np.int16 and got.shape == audio.shape
    np.testing.assert_array_equal(got, jax_native.f32_to_pcm16(audio))
    np.testing.assert_array_equal(got, native.f32_to_pcm16_plain(audio))
    assert got[-5:].tolist() == [32767, -32768, 32767, -32768, 0]


@pytest.mark.parametrize("n_in,n_out", [(16000, 8000), (16000, 44100), (22050, 16000),
                                        (5, 1), (1, 7), (2, 2), (3, 1000)])
def test_resample_linear_bit_equal(n_in, n_out):
    audio = rng(2).standard_normal(n_in).astype(np.float32)
    got = native.resample_linear(audio, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got, jax_native.resample_linear(audio, n_out))
    np.testing.assert_array_equal(got, native.resample_linear_plain(audio, n_out))


def test_resample_linear_of_nothing_is_zeros():
    np.testing.assert_array_equal(native.resample_linear(np.zeros(0, np.float32), 4), np.zeros(4))
    np.testing.assert_array_equal(native.resample_linear_plain(np.zeros(0), 4), np.zeros(4))
    assert native.resample_linear(np.ones(3, np.float32), 0).shape == (0,)


@pytest.mark.parametrize("capacity", [1, 8, 100])
def test_ring_buffer_sequences_equal(capacity):
    r = rng(3 + capacity)
    rings = [native.RingBuffer(capacity), native.RingBufferPlain(capacity),
             jax_native.RingBuffer(capacity)]
    assert rings[0]._lib is not None  # the library's ring
    fed = 0
    for _ in range(300):
        if r.random() < 0.55:
            n = int(r.integers(0, 2 * capacity + 2))
            x = np.arange(fed, fed + n, dtype=np.float32)
            wrote = [ring.push(x) for ring in rings]
            assert wrote[0] == wrote[1] == wrote[2] <= n
            fed += wrote[0]
        else:
            n = int(r.integers(0, 2 * capacity + 2))
            out = [ring.pop(n) for ring in rings]
            assert out[0].dtype == out[1].dtype == np.float32
            np.testing.assert_array_equal(out[0], out[1])
            np.testing.assert_array_equal(out[0], out[2])
        assert len(rings[0]) == len(rings[1]) == len(rings[2])
        assert rings[0].space() == rings[1].space() == rings[2].space() \
            == capacity - len(rings[0])


def _signal(kind: str, sr: int) -> np.ndarray:
    t = np.arange(int(3.0 * sr)) / sr
    if kind == "noise":
        return (0.05 * rng(4).standard_normal(t.size)).astype(np.float32)
    if kind == "speech":  # two harmonic voices (seeded) at 16 kHz, interpolated to sr
        voices = two_voice_mix(3.0, seed=SEED)
        return np.interp(t * 16000, np.arange(voices.size), voices).astype(np.float32)
    if kind == "gated":  # the relative gate drops the quiet tail
        return (np.sin(2 * np.pi * 220 * t) * (t < 1.0) * 0.5
                + np.sin(2 * np.pi * 880 * t) * (t > 2.0) * 0.001).astype(np.float32)
    if kind == "short":  # under one 400 ms block: the whole signal's power
        return (0.2 * rng(5).standard_normal(sr // 4)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("sr", [16000, 8000, 44100])
@pytest.mark.parametrize("kind", ["noise", "speech", "gated", "short"])
def test_integrated_loudness_agrees(kind, sr):
    x = _signal(kind, sr)
    got = native.integrated_loudness_native(x, sr)
    assert np.isfinite(got) and -70.0 < got < 0.0
    assert abs(got - jax_native.integrated_loudness_native(x, sr)) <= LU_TOL
    assert abs(got - integrated_loudness(x, sr)) <= LU_TOL


@pytest.mark.parametrize("kind", ["silence", "under the absolute gate"])
def test_integrated_loudness_minus_inf_cases(kind):
    x = np.zeros(32000, np.float32) if kind == "silence" else \
        (1e-5 * rng(6).standard_normal(32000)).astype(np.float32)
    for meter in (native.integrated_loudness_native, jax_native.integrated_loudness_native,
                  integrated_loudness):
        assert meter(x, 16000) == float("-inf")


def test_loudness_callers_run_the_library_like_jax(monkeypatch):
    """`meter_loudness` and `audio_loudness_control` of both packages'
    AudioProcessor, each on its own library, and the separator's stream
    ordering through the port's library."""
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.processors import audio

    calls = []
    lib = native.load_library()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            return (lambda *a: calls.append(name) or fn(*a)) if name == "integrated_loudness" \
                else fn

    monkeypatch.setattr(native, "_LIBRARY", [Counting()])
    ours, theirs = AudioProcessor(device="cpu"), JaxAudioProcessor()
    x = _signal("speech", 16000)
    assert abs(ours.meter_loudness(x, 16000) - theirs.meter_loudness(x, 16000)) <= LU_TOL
    np.testing.assert_allclose(ours.audio_loudness_control(x, 16000),
                               theirs.audio_loudness_control(x, 16000), rtol=1e-6, atol=0)
    assert ours.meter_loudness(x[:6000], 16000) == float("-inf")  # under one block: no call
    assert calls == ["integrated_loudness"] * 2
    assert audio.integrated_loudness_native is separation.integrated_loudness_native \
        is native.integrated_loudness_native
    quiet, loud = 0.1 * x, x
    eng = separation.SeparationEngine.__new__(separation.SeparationEngine)
    eng.sample_rate = 16000
    out = eng._order_and_fit(np.stack([quiet, loud]), 16000, x.size)
    np.testing.assert_array_equal(out, np.stack([loud, quiet]))
    assert calls == ["integrated_loudness"] * 4


def test_disable_native_takes_the_numpy_versions(monkeypatch):
    monkeypatch.setenv("TD_DISABLE_NATIVE", "1")

    def no_library():
        raise AssertionError("the library was asked for under TD_DISABLE_NATIVE=1")

    monkeypatch.setattr(native, "load_library", no_library)
    assert not native.has_native()
    pcm = rng(7).integers(-32768, 32768, 1000).astype(np.int16)
    audio = rng(8).uniform(-1.2, 1.2, 1000).astype(np.float32)
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm), native.pcm16_to_f32_plain(pcm))
    np.testing.assert_array_equal(native.f32_to_pcm16(audio), native.f32_to_pcm16_plain(audio))
    np.testing.assert_array_equal(native.resample_linear(audio, 333),
                                  native.resample_linear_plain(audio, 333))
    x = _signal("noise", 16000)
    assert native.integrated_loudness_native(x, 16000) == integrated_loudness(x, 16000)
    assert AudioProcessor(device="cpu").meter_loudness(x, 16000) == integrated_loudness(x, 16000)
    ring = native.RingBuffer(4)
    assert ring.push(np.arange(6, dtype=np.float32)) == 4 and ring.space() == 0
    np.testing.assert_array_equal(ring.pop(3), [0, 1, 2])
    assert len(ring) == 1


@pytest.mark.parametrize("fault", ["source", "compiler"])
def test_failing_build_raises(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIBRARY", [])
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "source":
        bad = tmp_path / "tdaudio.cpp"
        bad.write_text('extern "C" double integrated_loudness(const float* x) { return x; }\n')
        monkeypatch.setattr(native, "SOURCE", str(bad))
        match = r"(?s)g\+\+ failed .*error"
    else:
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "no g\\+\\+ on the PATH"
    with pytest.raises(RuntimeError, match=match) as err:
        native.integrated_loudness_native(np.ones(16000, np.float32), 16000)
    if fault == "source":
        assert "tdaudio.cpp" in str(err.value)
    with pytest.raises(RuntimeError):
        native.has_native()
    build_dir = tmp_path / "build"
    assert not build_dir.exists() or not os.listdir(build_dir)  # no partial library left
