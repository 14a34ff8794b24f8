"""One `infer_stream` session of both packages' `build_model()` with
ASR_ENGINE=sensevoice and EMBEDDING_MODEL=checkpoints/campp-bootstrap
(`test_torch_engines_offline.engine_systems`), on the CPU in float32: a
3 s synthesized dialogue with overlapped turns as 1 s chunks and a 4 s
enrollment, synchronous flushes. The stream self-enrolls and decides by
CAM++ embeddings, and each flush is transcribed by SenseVoice (with
punctuation). Limits: the same segments, speakers, types and texts,
timeranges within 10 ms.
"""

from unittest import mock

import jax
import pytest
import torch

from chip_smoke import dialogue, enrollment
from test_torch_engines_offline import engine_systems

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    return engine_systems()


@pytest.fixture(scope="module")
def target():
    return enrollment(4.0, seed=9)


def test_infer_stream_session_matches_jax(systems, target):
    """One session of 1 s chunks, synchronous flushes in both: the same
    segments (speaker, type, text) with timeranges within 10 ms."""
    ours, theirs = systems
    audio = dialogue(3.0, seed=3, overlap=True)

    def run(model):
        chunks = (audio[i: i + SR] for i in range(0, len(audio), SR))
        return [(spk, [(r["speaker"], r["type"], r["text"], r["timerange"]) for r in res])
                for spk, res, _ in model.infer_stream(chunks, target_file=target)]

    with mock.patch.object(ours, "async_flush", False), \
            mock.patch.object(theirs, "async_flush", False):
        got = run(ours)
        with jax.default_matmul_precision("highest"):
            want = run(theirs)
    assert len(got) == len(want) >= 1, (got, want)
    for (gs, gr), (ws, wr) in zip(got, want):
        assert gs == ws and len(gr) == len(wr)
        for g, w in zip(gr, wr):
            assert g[:3] == w[:3]
            assert max(abs(a - b) for a, b in zip(g[3], w[3])) <= 0.01
