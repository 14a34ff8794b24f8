"""Command-line interface of the port.

    python -m targetdiarization_tpu_torch infer AUDIO [--target T] [--single]
                                                 [--output-json R] [--output-audio W]
    python -m targetdiarization_tpu_torch stream AUDIO [--chunk 1.0] [--pace 0.0]
                                                  [--target T] [--single]
    python -m targetdiarization_tpu_torch serve [--host H] [--port 8000]

Each builds the server's model (`serve/server.py::build_model`) on the card,
or on the CPU with `--device cpu`. `infer` prints the offline result as
JSON; `stream` feeds an audio file in chunks of `--chunk` seconds (sleeping
chunk x pace between them) and prints one JSON line per segment; `serve`
runs the REST and WebSocket API (it needs aiohttp; the others do not). The
JAX package's `bench` subcommand has no counterpart here. AUDIO and
--target are PCM WAV or, where ffmpeg is on the PATH, any format it decodes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build(args):
    from .serve.server import build_model

    return build_model(device=args.device)


def cmd_infer(args):
    import numpy as np

    model = _build(args)
    t0 = time.time()
    target_spk, results, target_audio = model.infer(
        args.audio, target_file=args.target, is_single=args.single,
        output_target_audio=args.output_audio is not None)
    print(f"Used time: {time.time() - t0:.2f}s", file=sys.stderr)
    text = json.dumps({"target_speaker_id": target_spk, "results": results},
                      ensure_ascii=False, indent=2)
    if args.output_json:
        with open(args.output_json, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        print(text)
    if args.output_audio and target_audio is not None:
        from .utils.audio_io import write_audio

        write_audio(args.output_audio, np.asarray(target_audio), 16000)
        print(f"target audio -> {args.output_audio}", file=sys.stderr)


def cmd_stream(args):
    from .utils.audio_io import read_audio

    model = _build(args)
    audio, sr = read_audio(args.audio)

    def generator():
        n = int(args.chunk * sr)
        for i in range(0, audio.shape[-1], n):
            yield audio[..., i: i + n]
            time.sleep(args.chunk * args.pace)

    for target_spk, results, _ in model.infer_stream(generator(), target_file=args.target,
                                                     sampling_rate=sr, is_single=args.single):
        for seg in results:
            print(json.dumps({"target_speaker_id": target_spk, **seg}, ensure_ascii=False),
                  flush=True)


def cmd_serve(args):
    from .serve.server import run_server

    run_server(host=args.host, port=args.port, device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="targetdiarization_tpu_torch")
    parser.add_argument("--device", default=None,
                        help='"cuda" (the default) or "cpu"')
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("infer", help="offline target diarization + ASR")
    p.add_argument("audio")
    p.add_argument("--target", default=None)
    p.add_argument("--single", action="store_true")
    p.add_argument("--output-json", default=None)
    p.add_argument("--output-audio", default=None)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("stream", help="simulated real-time streaming of a file")
    p.add_argument("audio")
    p.add_argument("--target", default=None)
    p.add_argument("--single", action="store_true")
    p.add_argument("--chunk", type=float, default=1.0)
    p.add_argument("--pace", type=float, default=0.0,
                   help="sleep chunk x pace between chunks (1.0 = real time)")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("serve", help="REST + WebSocket API server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
