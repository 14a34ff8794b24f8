"""`TargetDiarization.infer` on the cluster diarizer's path, and what the
port's `infer` reads, against the JAX package on the shipped checkpoints
(float32, CPU; the systems of `test_torch_offline.py`).

- (c) The server diarizes by clustering at 30 s and above. Here both
  packages take that path on 4 s (`long_audio_threshold=3.5` in both):
  `ClusterDiarizer.diarize_from_windows` over the front end's window
  embeddings (average-linkage AHC, `models/clustering.py`) and the
  segmentation's overlaps matched onto its speakers; this input leaves the
  target no overlap, so its tracks go through `FusedASR` (the windowed
  separation after the cluster path runs on the card, `chip_smoke.py`
  call c). Limits as in `test_torch_offline.py`.
- A WAV path and an `io.BytesIO` give what their samples give as an
  array (the JAX package reads the path too; it cannot read a
  `BytesIO`), and a second call with the same enrollment takes the
  embedding from the cache.
"""

import io
import wave

import jax
import numpy as np
import pytest
import torch

from test_torch_offline import build_both, dialogue, enrollment, run_both, same_infer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    return build_both(long_audio_threshold=3.5)


def test_infer_cluster_path_matches_jax(systems, monkeypatch):
    clustered = []
    ours = systems[0]
    diarize = ours.sd_pipeline.diarize_from_windows
    monkeypatch.setattr(ours.sd_pipeline, "diarize_from_windows",
                        lambda *a: clustered.append(a) or diarize(*a))
    got, want = run_both(systems, dialogue(4.0, seed=3, overlap=False), enrollment(4.0, seed=9))
    assert len(clustered) == 1 and len(clustered[0][0]) >= 3
    assert len({r["speaker"] for r in want[1]}) >= 2
    same_infer(got, want, separated=False)


def _wav_bytes(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(audio * 32768, -32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_infer_reads_paths_and_buffers(systems, tmp_path, monkeypatch):
    ours, theirs = systems
    audio = dialogue(2.0, seed=6, overlap=False)
    target = enrollment(3.0, seed=9)
    paths = []
    for name, a in (("mix.wav", audio), ("target.wav", target)):
        paths.append(tmp_path / name)
        paths[-1].write_bytes(_wav_bytes(a))
    as_read = [ours.ap.read_audio(str(p))[0] for p in paths]
    want = ours.infer(as_read[0], as_read[1], is_single=True)
    enrolls = []
    enroll = ours.fused.enroll
    monkeypatch.setattr(ours.fused, "enroll", lambda *a, **k: enrolls.append(a) or enroll(*a, **k))
    got = ours.infer(str(paths[0]), str(paths[1]), is_single=True)
    again = ours.infer(io.BytesIO(_wav_bytes(audio)), str(paths[1]), is_single=True)
    assert len(enrolls) == 1  # the second call's enrollment came from the cache
    for out in (got, again):
        assert out[0] == want[0] and out[1] == want[1]
        np.testing.assert_array_equal(out[2], want[2])
    with jax.default_matmul_precision("highest"):
        jax_out = theirs.infer(str(paths[0]), str(paths[1]), is_single=True)
    same_infer(got, jax_out, separated=False)


def test_interval_algebra_is_re_exported(systems):
    ours, theirs = systems
    sd = {"0": [(0.0, 2.0), (3.0, 4.0)], "1": [(1.5, 3.5)]}
    for name in ("get_speaker_overlap", "apply_od_result", "subtract_overlap",
                 "merge_timeranges", "get_speaker_num"):
        args = {"get_speaker_overlap": (sd,), "apply_od_result": (sd, {}),
                "subtract_overlap": (sd, []), "merge_timeranges": (sd["0"] + sd["1"],),
                "get_speaker_num": (sd,)}[name]
        assert getattr(ours, name)(*args) == getattr(theirs, name)(*args), name
