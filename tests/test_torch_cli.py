"""The port's CLI `infer --output-audio` against the JAX package's.

Both CLIs run on a stub model (its `infer` returns a fixed result and target
audio), with the ffmpeg lookup pointed at a fake binary and `subprocess.run`
replaced by a recorder: for an extension other than `.wav` both must make
the same ffmpeg call on the same WAV bytes, and for `.wav` both must write
the WAV bytes directly, with no call.
"""

import os
import subprocess

import numpy as np
import pytest

import targetdiarization_tpu.__main__ as jax_cli
import targetdiarization_tpu.utils.audio_io as jax_audio_io
import targetdiarization_tpu_torch.__main__ as port_cli
import targetdiarization_tpu_torch.utils.audio_io as port_audio_io

FFMPEG = os.path.join("fake-bin", "ffmpeg")  # never run: subprocess.run is a recorder


class _StubModel:
    def __init__(self):
        self.audio = (0.3 * np.sin(np.arange(3200) / 7.0)).astype(np.float32)

    def infer(self, audio, target_file=None, is_single=False, output_target_audio=False):
        return "1", [{"speaker": "1", "text": "stub"}], self.audio


def _run_cli(mp, tmp, who: str, out_name: str) -> tuple[list, str]:
    """The CLI `who` ("jax" or "port") through `infer` with `--output-audio
    out_name` under `tmp/who`; returns the recorded ffmpeg calls (each with
    the bytes of the WAV it was given, paths made relative) and the output
    path."""
    calls = []

    def run(cmd, **kwargs):
        cmd = list(cmd)
        with open(cmd[3], "rb") as f:
            wav = f.read()
        calls.append(([os.path.basename(c) for c in cmd], wav, kwargs))
        return subprocess.CompletedProcess(cmd, 0)

    mp.setattr(subprocess, "run", run)
    root = os.path.join(tmp, who)
    os.makedirs(root, exist_ok=True)
    out = os.path.join(root, out_name)
    argv = ["infer", os.path.join(root, "in.wav"), "--output-json", os.path.join(root, "r.json"),
            "--output-audio", out]
    if who == "jax":
        mp.setattr(jax_cli, "_build_stream_model", _StubModel)
        jax_cli.main(argv)
    else:
        mp.setattr(port_cli, "_build", lambda args: _StubModel())
        port_cli.main(["--device", "cpu", *argv])
    return calls, out


@pytest.fixture
def fake_ffmpeg(monkeypatch):
    monkeypatch.setattr(jax_audio_io, "_FFMPEG", FFMPEG)
    monkeypatch.setattr(port_audio_io.shutil, "which",
                        lambda name: FFMPEG if name == "ffmpeg" else None)
    return monkeypatch


@pytest.mark.parametrize("ext", [".mp3", ".flac"])
def test_output_audio_goes_through_ffmpeg_as_in_the_jax_cli(fake_ffmpeg, tmp_path, ext):
    got, got_path = _run_cli(fake_ffmpeg, str(tmp_path), "port", "t" + ext)
    want, want_path = _run_cli(fake_ffmpeg, str(tmp_path), "jax", "t" + ext)
    assert len(want) == 1 and len(got) == 1
    assert got[0][0] == want[0][0] == ["ffmpeg", "-y", "-i", f"t{ext}.tmp.wav", f"t{ext}"]
    assert got[0][1] == want[0][1] and got[0][1][:4] == b"RIFF"
    assert got[0][2] == want[0][2]
    # the temporary WAV is removed and no WAV bytes are left under the name
    for path in (got_path, want_path):
        assert not os.path.exists(path + ".tmp.wav") and not os.path.exists(path)


def test_output_audio_wav_is_written_directly(fake_ffmpeg, tmp_path):
    got, got_path = _run_cli(fake_ffmpeg, str(tmp_path), "port", "t.wav")
    want, want_path = _run_cli(fake_ffmpeg, str(tmp_path), "jax", "t.wav")
    assert got == want == []
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        data = a.read()
        assert data == b.read() and data[:4] == b"RIFF"
