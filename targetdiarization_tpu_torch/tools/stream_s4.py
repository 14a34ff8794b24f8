"""Four paced streaming sessions on one card, with and without
`prewarm_streaming`, to see what sets whether they keep up with real time.

chip_smoke.py's s4 feeds four `infer_stream` sessions (its dialogues of
seeds 13-16, 20 s each, 1 s int16 chunks at real time, the 8 s enrollment)
from four threads into one `build_model()` system in the card's types with
async flushes. This runs that s4 in fresh processes, in the order none,
prewarm, prewarm, none: each process builds the system, runs
`prewarm_streaming(max_sessions=4)` or not, then s4 `--repeats` times.
Per s4 run it prints one JSON line: wall seconds; the MicroBatchers'
dispatches and how many coalesced rows; intake and emission p50/p99;
`flush_done`, the latency from the arrival of the chunk that caused a flush
to the end of the flush, and `handover_wait`, from the end of a flush with
results to their hand-over (`infer_stream` hands a finished flush over
when the session's next chunk comes in); the process's CPU seconds over
wall; and the card's utilization as `nvidia-smi` samples it every 200 ms.
Run from the repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.stream_s4 [--repeats 2]

It prints the card's name and power limit first and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ORDER = ("none", "prewarm", "prewarm", "none")


def _pct(values: list, q: float) -> float | None:
    import numpy as np

    return float(np.percentile(np.asarray(values) * 1e3, q)) if values else None


def _record_flushes(done: list, waits: list) -> None:
    """Wraps `_FlushQueue` so that each flush's end (from the arrival of its
    chunk) and each hand-over's wait after that end are recorded."""
    from ..pipeline import streaming

    submit, emit = streaming._FlushQueue.submit, streaming._FlushQueue._emit
    ended = {}

    def recording_submit(self, audio, t_arrival=None):
        forced = submit(self, audio, t_arrival)
        fut, t = self._pending[-1]

        def finished(f, t=t):
            ended[f] = time.perf_counter()
            if t is not None:
                done.append(ended[f] - t)

        fut.add_done_callback(finished)
        return forced

    def recording_emit(self, fut, t_arrival):
        results = emit(self, fut, t_arrival)
        if results and fut in ended:
            waits.append(time.perf_counter() - ended.pop(fut))
        return results

    streaming._FlushQueue.submit = recording_submit
    streaming._FlushQueue._emit = recording_emit


def _utilization_sampler():
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _stop(proc) -> list:
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return [float(x) for x in out.split() if x.strip().replace(".", "", 1).isdigit()]


def child(mode: str, repeats: int) -> None:
    import chip_smoke
    import numpy as np

    torch = chip_smoke.require_cuda()
    from ..ops.kernels import _build

    _build.load_library()
    t = time.perf_counter()
    model = chip_smoke.load_stream()
    setup = {"build_model_s": time.perf_counter() - t}
    if mode == "prewarm":
        t = time.perf_counter()
        setup["passes"] = model.prewarm_streaming(max_sessions=4)
        torch.cuda.synchronize()
        setup["prewarm_s"] = time.perf_counter() - t
    print(json.dumps({"process": mode, **setup}), flush=True)
    enroll = chip_smoke.enrollment(8.0, seed=9)
    inputs = [chip_smoke.dialogue(20.0, seed=s, overlap=True) for s in chip_smoke.STREAM_SEEDS]
    done, waits = [], []
    _record_flushes(done, waits)
    for k in range(repeats):
        done.clear()
        waits.clear()
        before = chip_smoke.mb_stats(model)
        sampler = _utilization_sampler()
        cpu = time.process_time()
        runs, _, wall = chip_smoke.concurrent_sessions(model, inputs, enroll)
        cpu = time.process_time() - cpu
        util = _stop(sampler)
        mb = chip_smoke.mb_delta(chip_smoke.mb_stats(model), before)
        intake = [x for r in runs for x in r["intake_s"]]
        emission = [x for r in runs for x in r["emission_s"]]
        print(json.dumps({
            "process": mode, "run": k + 1, "wall_s": wall, "audio_s": 20.0,
            "coalesced": {n: [v["coalesced_dispatches"], v["dispatches"]] for n, v in mb.items()},
            "intake_ms_p50": _pct(intake, 50), "intake_ms_p99": _pct(intake, 99),
            "emission_ms_p50": _pct(emission, 50), "emission_ms_p99": _pct(emission, 99),
            "flush_done_ms_p50": _pct(done, 50), "flush_done_ms_p99": _pct(done, 99),
            "handover_wait_ms_p50": _pct(waits, 50), "handover_wait_ms_p99": _pct(waits, 99),
            "flushes": len(done), "cpu_s_per_wall_s": cpu / wall,
            "gpu_util_pct_mean": float(np.mean(util)) if util else None,
            "segments": [len(r["results"]) for r in runs]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--child", choices=("none", "prewarm"))
    args = ap.parse_args()
    if args.child:
        child(args.child, args.repeats)
        return
    import chip_smoke

    chip_smoke.require_cuda()
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    rows = []
    for mode in ORDER:
        proc = subprocess.run([sys.executable, "-m", "targetdiarization_tpu_torch.tools.stream_s4",
                               "--child", mode, "--repeats", str(args.repeats)],
                              capture_output=True, text=True, timeout=900, cwd=os.getcwd())
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"stream_s4: the {mode} process exited {proc.returncode}")
        rows += [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{") and '"run"' in line]
    summary = {mode: [round(r["wall_s"], 3) for r in rows if r["process"] == mode]
               for mode in ("none", "prewarm")}
    print(json.dumps({"wall_s_by_process": summary}), flush=True)


if __name__ == "__main__":
    main()
