"""The port's cross-session MicroBatcher (`runtime/microbatch.py`) and the
engines' coalescing (`SeparationEngine` and `ASREngine`: ROW_LADDER and
`_run_mb`), on the CPU.

The batcher's unit tests mirror tests/test_microbatch.py without its
wall-clock bound: where that test times a lone caller, this one records
whether the gather window's sleep was taken. The engines' tests hold a
coalesced call against the same call alone (a row's result must not
depend on the rows beside it): the separator's row alone against the same
row in a batch of four within 1e-5, the ASR's texts and timestamps
equal, and coalesced separator forwards only at row rungs.
"""

import threading
import time

import numpy as np
import pytest
import torch

from targetdiarization_tpu_torch.models import asr as tasr
from targetdiarization_tpu_torch.models import separation as tsep
from targetdiarization_tpu_torch.models.tokenizer import CharTokenizer
from targetdiarization_tpu_torch.runtime import microbatch
from targetdiarization_tpu_torch.runtime.microbatch import MicroBatcher

SEP = dict(dim=32, enc_channels=32, num_blocks=1, group_size=64, qk_dim=32, fsmn_inner=16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _threads(n, target):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_single_caller_takes_no_gather_window(monkeypatch):
    """A lone caller runs at once: the gather window's sleep is not taken."""
    sleeps, calls = [], []
    monkeypatch.setattr(microbatch.time, "sleep", sleeps.append)
    mb = MicroBatcher(lambda key, items: calls.append(list(items)) or [x * 2 for x in items],
                      window_ms=50.0)
    assert mb.submit("k", 3) == 6
    assert calls == [[3]] and sleeps == []


def test_concurrent_callers_coalesce():
    """Eight threads submitting one key over four rounds: fewer run_batch
    calls than items, and each gets its own result."""
    n_calls = []

    def run(key, items):
        n_calls.append(len(items))
        time.sleep(0.01)  # a forward
        return [x + 100 for x in items]

    mb = MicroBatcher(run, window_ms=20.0, max_batch=8)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        for r in range(4):
            results[i] = mb.submit("k", i + r * 10)

    _threads(8, worker)
    assert sum(n_calls) == 32
    assert len(n_calls) < 32 and max(n_calls) > 1
    assert results == [i + 30 + 100 for i in range(8)]
    stats = mb.stats()
    assert stats["items"] == 32 and stats["batches"] == len(n_calls)
    assert sum(k * v for k, v in stats["sizes"].items()) == 32


def test_keys_never_mix():
    seen = []

    def run(key, items):
        seen.append((key, tuple(items)))
        return [key] * len(items)

    mb = MicroBatcher(run, window_ms=5.0)
    out = []
    keys = ("a", "b", "a", "b")
    _threads(4, lambda i: out.append(mb.submit(keys[i], i)))
    assert sorted(out) == ["a", "a", "b", "b"]
    for key, items in seen:
        assert all(keys[i] == key for i in items)


def test_exception_propagates_to_all_waiters():
    def run(key, items):
        raise ValueError("boom")

    mb = MicroBatcher(run, window_ms=5.0)
    mb._last_multi = time.monotonic() + 10  # hot: the leader gathers
    errs = []

    def worker(i):
        try:
            mb.submit("k", i)
        except ValueError as e:
            errs.append(str(e))

    _threads(4, worker)
    assert errs == ["boom"] * 4


def test_max_batch_splits():
    sizes = []
    mb = MicroBatcher(lambda key, items: sizes.append(len(items)) or list(items),
                      window_ms=30.0, max_batch=2)
    mb._last_multi = time.monotonic() + 10
    results = [None] * 5
    barrier = threading.Barrier(5)

    def worker(i):
        barrier.wait()
        results[i] = mb.submit("k", i)

    _threads(5, worker)
    assert results == list(range(5))
    assert all(s <= 2 for s in sizes)


def test_leader_abort_releases_followers(monkeypatch):
    """A leader that dies outside run_batch (here in the gather window)
    hands its followers an error instead of leaving them waiting."""

    class Boom(BaseException):
        pass

    mb = MicroBatcher(lambda key, items: list(items), window_ms=40.0)
    mb._last_multi = time.monotonic() + 10
    follower_in = threading.Event()
    real_sleep = time.sleep

    def dying_sleep(s):
        follower_in.wait(5)
        real_sleep(0.02)  # the follower is queued behind the leader
        raise Boom()

    follower_err = []

    def follower():
        while not mb._pending.get("k"):
            real_sleep(0.001)
        follower_in.set()
        try:
            mb.submit("k", 2)
        except RuntimeError as e:
            follower_err.append(str(e))

    t = threading.Thread(target=follower)
    monkeypatch.setattr(microbatch.time, "sleep", dying_sleep)
    t.start()
    with pytest.raises(Boom):
        mb.submit("k", 1)
    monkeypatch.setattr(microbatch.time, "sleep", real_sleep)
    t.join(timeout=5)
    assert not t.is_alive(), "follower hung after leader abort"
    assert follower_err and "leader aborted" in follower_err[0]
    assert mb.submit("k", 7) == 7  # a new leader for the key


def test_result_order_matches_submit_order():
    mb = MicroBatcher(lambda key, items: [np.asarray(x) * 10 for x in items], window_ms=10.0)
    vals = {}
    barrier = threading.Barrier(6)

    def worker(i):
        barrier.wait()
        vals[i] = int(mb.submit("k", i))

    _threads(6, worker)
    assert vals == {i: i * 10 for i in range(6)}


def test_disabled_env(monkeypatch):
    monkeypatch.setenv("TD_MICROBATCH", "0")
    assert not microbatch.enabled()
    eng = tsep.SeparationEngine(tsep.MossFormer2(**SEP).eval(), device="cpu")
    assert eng._mb is None
    assert eng.separate(np.zeros(1600, np.float32)).shape == (2, 1600)


# ---------------- the engines ----------------


@pytest.fixture(scope="module")
def separator():
    torch.manual_seed(0)
    return tsep.SeparationEngine(tsep.MossFormer2(**SEP).eval(), device="cpu",
                                 compute_dtype="float32")


def _rows(n, t, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n, t))).astype(np.float32)


def test_separation_run_mb_stays_on_row_ladder(separator, monkeypatch):
    """Three 7-row items (21 rows, above the top rung of 16) go as forwards
    of rung rows only, and each item's rows come back as its own."""
    shapes = []
    forward = separator._forward
    monkeypatch.setattr(separator, "_forward",
                        lambda b, l: shapes.append(b.shape) or forward(b, l))
    items = [(_rows(7, 1600, s), np.full(7, 1600, np.int64)) for s in range(3)]
    out = separator._run_mb(1600, items)
    assert [o.shape for o in out] == [(7, 2, 1600)] * 3
    assert shapes and all(s[0] in separator.ROW_LADDER for s in shapes), shapes
    for o, (b, l) in zip(out, items):
        np.testing.assert_allclose(o, forward(b, l), atol=1e-5, rtol=0)


def test_separation_row_alone_matches_row_in_batch_of_four(separator):
    """A row's estimate alone (rung 1) and as the second of four coalesced
    items of other lengths (rung 4): within 1e-5."""
    rows = [_rows(1, 3200, s) for s in range(4)]
    lengths = [np.array([n], np.int64) for n in (3200, 2000, 1700, 900)]
    alone = separator._run_mb(3200, [(rows[1], lengths[1])])[0]
    together = separator._run_mb(3200, list(zip(rows, lengths)))
    assert together[1].shape == alone.shape == (1, 2, 3200)
    assert np.abs(together[1] - alone).max() <= 1e-5


def test_separator_coalesces_concurrent_callers(separator):
    """Four threads separating at one rung while the batcher is hot: each
    gets what it gets alone, and some forward took more than one item."""
    clips = [_rows(1, 3000 + 100 * i, i)[0] for i in range(4)]
    alone = [separator.separate(c) for c in clips]
    before = separator._mb.stats()["sizes"]
    separator._mb._last_multi = time.monotonic() + 10
    got = [None] * 4
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait()
        got[i] = separator.separate(clips[i])

    _threads(4, worker)
    for g, a in zip(got, alone):
        assert np.abs(g - a).max() <= 1e-5
    after = separator._mb.stats()["sizes"]
    assert any(after.get(k, 0) > before.get(k, 0) for k in after if k > 1), after


@pytest.fixture(scope="module")
def asr_engine():
    torch.manual_seed(0)
    tok = CharTokenizer(vocab=["<blank>", "<s>", "</s>", "<unk>"] + list("abc一二三"))
    model = tasr.Paraformer(vocab_size=len(tok), dim=32, ffn=64, enc_layers=2, dec_layers=1)
    return tasr.ASREngine(model.eval(), tokenizer=tok, device="cpu", compute_dtype="float32")


def test_asr_concurrent_equals_sequential_mixed_t(asr_engine):
    """Clips of three lengths in one sample rung (different frame counts a
    row) coalesce; each text and timestamp list equals its call alone."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (15500, 12000, 9000, 15500, 12000, 9000)]
    seq = [asr_engine.asr_detection(c)[0] for c in clips]
    before = asr_engine._mb.items
    asr_engine._mb._last_multi = time.monotonic() + 10
    with ThreadPoolExecutor(max_workers=6) as ex:
        conc = [r[0] for r in ex.map(asr_engine.asr_detection, clips)]
    assert conc == seq
    assert asr_engine._mb.items - before == 6


def test_asr_run_mb_pads_to_a_rung(asr_engine):
    """Three items go as one forward of four rows, the fourth of one
    frame; each result equals its item's call alone."""
    rng = np.random.default_rng(1)
    items = [((3000 * rng.standard_normal(16000)).astype(np.int16), t) for t in (27, 20, 9)]
    rows = []
    dispatch = asr_engine._dispatch
    asr_engine._dispatch = lambda b, ts: rows.append((b.shape, list(ts))) or dispatch(b, ts)
    try:
        got = asr_engine._run_mb(16000, items)
        alone = [asr_engine._run_mb(16000, [it])[0] for it in items]
    finally:
        del asr_engine._dispatch
    assert rows[0] == ((4, 16000), [27, 20, 9, 1])
    assert got == alone


def test_asr_disabled_env(monkeypatch):
    monkeypatch.setenv("TD_MICROBATCH", "0")
    tok = CharTokenizer(vocab=["<blank>", "<s>", "</s>", "<unk>", "a"])
    eng = tasr.ASREngine(tasr.Paraformer(vocab_size=len(tok), dim=32, ffn=64, enc_layers=1,
                                         dec_layers=1).eval(), tokenizer=tok, device="cpu")
    assert eng._mb is None
    assert set(eng.asr_detection(np.zeros(8000, np.float32))[0]) >= {"text", "timestamp"}
