"""Cross-session micro-batching: concurrent same-shape device calls from
many serving threads coalesce into one batched forward.

Copy of targetdiarization_tpu/runtime/microbatch.py (pure threading; the
port keeps its own copy). Mechanism (leader/follower):
- `submit(key, item)` appends the item to a per-key pending list.
- The first submitter for a key is the *leader*: it waits a short gather
  window (a few ms, only while other threads have been active, see below),
  takes the whole pending list, runs `run_batch(key, items)` once, and
  hands each waiter its result.
- Later submitters (*followers*) block until the leader fills their slot.

A lone caller pays no window: the gather sleep happens only while more
than one submitter has been active within the last `hot_s` seconds.
Engines opt in per entry point (StreamChunkAnalyzer, SeparationEngine,
ASREngine); TD_MICROBATCH=0 turns it off everywhere.
"""

from __future__ import annotations

import os
import threading
import time


def enabled() -> bool:
    return os.environ.get("TD_MICROBATCH", "1") != "0"


class _Slot:
    __slots__ = ("item", "result", "error", "event")

    def __init__(self, item):
        self.item = item
        self.result = None
        self.error = None
        self.event = threading.Event()

    def set(self, result):
        self.result = result
        self.event.set()

    def set_exception(self, err):
        self.error = err
        self.event.set()

    def get(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Coalesce concurrent `submit` calls with equal `key` into one
    `run_batch(key, items) -> results` call.

    run_batch must return one result per item, in order. Items whose
    key differs are never mixed (keys encode the compiled bucket shape,
    so mixing would be a shape error anyway).
    """

    def __init__(self, run_batch, window_ms: float = 3.0,
                 max_batch: int = 8, hot_s: float = 1.0):
        self.run_batch = run_batch
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.hot_s = hot_s
        self._lock = threading.Lock()
        self._pending: dict = {}
        self._active = 0
        self._last_multi = 0.0
        # stats (observability; runtime/trace reports stages, this
        # reports coalescing efficiency)
        self.batches = 0
        self.items = 0
        self.sizes: dict = {}  # items per run_batch call -> calls

    def submit(self, key, item):
        slot = _Slot(item)
        with self._lock:
            self._active += 1
            if self._active > 1:
                self._last_multi = time.monotonic()
            hot = (time.monotonic() - self._last_multi) < self.hot_s
            q = self._pending.get(key)
            if q is None:
                q = []
                self._pending[key] = q
            q.append(slot)
            leader = len(q) == 1
        popped: list = []
        try:
            if not leader:
                return slot.get()
            try:
                if hot:
                    # gather window: let concurrent sessions' requests land
                    time.sleep(self.window_s)
                with self._lock:
                    popped = self._pending.pop(key, [])
                if not popped:  # raced away (shouldn't happen: only the
                    return slot.get()  # leader pops its key)
                batch = list(popped)
                while batch:
                    part, batch = batch[: self.max_batch], batch[self.max_batch:]
                    with self._lock:
                        self.batches += 1
                        self.items += len(part)
                        self.sizes[len(part)] = self.sizes.get(len(part), 0) + 1
                    try:
                        results = self.run_batch(key, [s.item for s in part])
                        if len(results) != len(part):
                            raise RuntimeError(
                                f"run_batch returned {len(results)} results "
                                f"for {len(part)} items")
                        for s, r in zip(part, results):
                            s.set(r)
                    except Exception as e:  # propagate to every waiter
                        for s in part:
                            s.set_exception(e)
                return slot.get()
            except BaseException as e:
                # The leader died outside run_batch (e.g. KeyboardInterrupt
                # during the gather sleep): without this, follower slots
                # never get set and their Event.wait() blocks those serving
                # threads forever, while later submitters keep appending to
                # an orphaned pending list that has no leader.
                if not popped:
                    with self._lock:
                        q = self._pending.get(key)
                        if q and slot in q:  # still our generation
                            popped = self._pending.pop(key)
                err = RuntimeError(f"micro-batch leader aborted: {e!r}")
                for s in popped:
                    if not s.event.is_set():
                        s.set_exception(err)
                raise
        finally:
            with self._lock:
                self._active -= 1

    def stats(self) -> dict:
        with self._lock:
            return {"batches": self.batches, "items": self.items,
                    "mean_batch": self.items / max(self.batches, 1),
                    "sizes": dict(sorted(self.sizes.items()))}
