"""The port runs where JAX does not exist.

The machine with the card has PyTorch and no jax, flax, scikit-learn or
aiohttp, so the port and chip_smoke.py must import and run with jax, flax,
sklearn and the JAX package unimportable: the separator, the ASR stage, the
fused front end, `TargetDiarization.infer`, the streaming and serving
entry points (`build_model`, `infer_stream`, the server app, the CLI) and
the rest of the public surface (the enhancer, emotion, forced alignment,
the VAD helpers, the DSP toolbox), and the alternate engines (SenseVoice,
the whisper engines, CAM++ and the cloud clients) on the shipped
checkpoints, and the separator zoo (chip_smoke.py's zoo phase at small
sizes, `build_model` with a zoo checkpoint); without aiohttp too, all but
the server app; and training (chip_smoke.py's train phase at a small
size, and the bootstrap recipes, all fourteen), with optax blocked too, and
`train/mos.py`'s estimators, and the readers of reference checkpoints
(`runtime/port_rules.py`, `runtime/onnx_io.py`, chip_smoke.py's port_rules
phase at small sizes), and data parallelism (`parallel/`, the trainer on a
mesh, `tools/dryrun_multichip.py` through chip_smoke.py's mesh phase at a
small size), with optax blocked too, and the host library
(`utils/native.py`), the ffmpeg decoder and `device_profile`.
A checkpoint path that does not exist must raise, and the ported loudness
must agree with the JAX package's host meter.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import tempfile
    import numpy as np
    import torch
    torch.set_num_threads(2)  # beside the other test workers' threads
    import targetdiarization_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(targetdiarization_tpu_torch.__path__,
                                                 "targetdiarization_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    import chip_smoke
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor
    # what is imported, not what is computed: a small seeded separator
    # checkpoint, written and loaded as the shipped ones are
    ap = AudioProcessor(SMALL_SEPARATOR(tempfile.mkdtemp()), device="cpu")
    assert ap.is_separate_speaker
    t = np.arange(16000) / 16000.0
    mix = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.1 * np.sin(2 * np.pi * 410 * t)).astype(np.float32)
    out = ap.separate_speaker(mix)
    assert len(out) == 2 and all(o.shape == mix.shape and np.isfinite(o).all() for o in out)
    from targetdiarization_tpu_torch.models.denoise import DenoiseEngine
    from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
    from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
    from targetdiarization_tpu_torch.models.vad import VADEngine
    from targetdiarization_tpu_torch.pipeline.fused import FusedFrontend
    fe = FusedFrontend(*(cls.from_pretrained(f"checkpoints/{name}-bootstrap", device="cpu")
                         for cls, name in ((DenoiseEngine, "den"), (VADEngine, "vad"),
                                           (SegmentationEngine, "seg"), (SpeakerEngine, "spk"))))
    res = fe.analyze(mix)
    assert res["audio"].shape == mix.shape and np.isfinite(res["audio"]).all()
    assert res["vad_probs"].shape == (98,) and res["seg_act"].shape == (24, 3)
    assert res["win_embs"] is None  # 98 frames: no whole 150-frame window
    emb = fe.enroll(mix)["emb"]
    assert emb.shape == (192,) and np.isfinite(emb).all()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"))
    assert not leaked, leaked
    print("ISOLATED_OK", len(mods))
""")


# a small seeded MossFormer2 checkpoint written under a directory (the
# subprocess's separator where the test shows what is imported: the CPU
# runs the shipped 256/12 one slowly)
_SMALL_SEPARATOR = textwrap.dedent("""
    def SMALL_SEPARATOR(root):
        from targetdiarization_tpu_torch.models.separation import MossFormer2
        from targetdiarization_tpu_torch.runtime.registry import save_checkpoint
        from targetdiarization_tpu_torch.train.trainer import init_params
        args = dict(dim=64, enc_channels=64, num_blocks=2, group_size=32, qk_dim=32,
                    fsmn_inner=64)
        model = MossFormer2(**args)
        model.load_state_dict(init_params(model, seed=2))
        save_checkpoint(root, model, "MossFormer2", args)
        return root
""")
_BLOCKED_RUN = _BLOCKED_RUN.replace("sys.meta_path.insert(0, Block())",
                                    "sys.meta_path.insert(0, Block())" + _SMALL_SEPARATOR, 1)


def test_port_and_chip_smoke_run_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED_OK" in proc.stdout


_BLOCKED_ASR = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    torch.set_num_threads(2)  # beside the other test workers' threads
    from chip_smoke import synth_utterance
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor
    ap = ASRProcessor(vad_model="checkpoints/vad-bootstrap", asr_model="checkpoints/asr-bootstrap",
                      punc_model="checkpoints/punc-bootstrap", device="cpu")
    audio, _ = synth_utterance("天地人日月", np.random.default_rng(0))
    res = ap.asr_detection(audio)[0]
    assert res["text"] and len(res["timestamp"]) >= 1, res
    assert ap.vad_detection(audio) and ap.punctuation_restore("天地人")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"))
    assert not leaked, leaked
    print("ASR_ISOLATED_OK", res["text"])
""")


_BLOCKED_INFER = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    torch.set_num_threads(2)  # beside the other test workers' threads
    from chip_smoke import dialogue, enrollment, load_system
    td = load_system(device="cpu", separation="checkpoints/sep-bootstrap")
    spk, results, target_audio = td.infer(dialogue(2.5, seed=1, overlap=True),
                                          enrollment(3.0, seed=9))
    assert spk and results and target_audio is not None and np.isfinite(target_audio).all()
    assert any(r["type"] == "overlap" for r in results), results
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu"))
    assert not leaked, leaked
    print("INFER_ISOLATED_OK", len(results))
""")


def test_target_diarization_infer_runs_without_jax_or_sklearn():
    """The whole offline pipeline on the CPU: 2.5 s of overlapped dialogue
    with a target, so the re-clustering (AHC) and the separator run."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_INFER], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "INFER_ISOLATED_OK" in proc.stdout


_BLOCK = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "sklearn", "targetdiarization_tpu") + EXTRA

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    torch.set_num_threads(2)  # beside the other test workers' threads
""")

_LEAKS = textwrap.dedent("""
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
""")

_BLOCKED_SERVE = textwrap.dedent("""
    import asyncio, base64
    from aiohttp.test_utils import TestClient, TestServer
    from chip_smoke import dialogue
    from targetdiarization_tpu_torch.runtime.config import env_config
    from targetdiarization_tpu_torch.runtime.microbatch import MicroBatcher, enabled
    from targetdiarization_tpu_torch.serve.server import build_model, create_app
    assert env_config().device == "cuda" and enabled()
    assert MicroBatcher(lambda key, items: [2 * x for x in items]).submit("k", 4) == 8
    model = build_model(device="cpu")
    pcm = np.round(dialogue(2.0, seed=3, overlap=False) * 32767).astype(np.int16)

    async def run():
        async with TestClient(TestServer(create_app(model))) as client:
            health = await (await client.get("/health")).json()
            page = await (await client.get("/target-diarization")).text()
            ws = await client.ws_connect("/diarization/stream")
            await ws.send_json({"type": "config", "data": {}})
            ack = await ws.receive_json()
            for i in range(0, len(pcm), 16000):
                await ws.send_json({"type": "audio_chunk",
                                    "data": base64.b64encode(pcm[i: i + 16000].tobytes()).decode()})
            await ws.send_json({"type": "audio_end"})
            msgs = []
            while not msgs or msgs[-1]["type"] not in ("status", "error"):
                msgs.append(await ws.receive_json())
            await ws.close()
            return health, page, ack, msgs

    health, page, ack, msgs = asyncio.run(run())
    assert health["model_loaded"] is True and "diarization/stream" in page
    assert ack["type"] == "config_ack" and msgs[-1]["message"] == "completed", msgs
""")


def _run_blocked(body: str, extra: tuple = ()) -> subprocess.CompletedProcess:
    script = _BLOCK.replace("EXTRA", repr(tuple(extra))) + body + _LEAKS + "print('BLOCKED_OK')\n"
    return subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=900, env={**os.environ, "PYTHONPATH": REPO})


def test_server_and_stream_run_without_jax():
    """`build_model` on the CPU, the config and the batcher, and the app
    through aiohttp's test client: /health, the page, one WS session."""
    proc = _run_blocked(_BLOCKED_SERVE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_CLI = textwrap.dedent("""
    import contextlib, io, json, os, tempfile
    from chip_smoke import dialogue, enrollment
    from targetdiarization_tpu_torch import __main__ as cli
    from targetdiarization_tpu_torch.models.separation import MossFormer2, SeparationEngine
    from targetdiarization_tpu_torch.serve import server
    from targetdiarization_tpu_torch.utils.audio_io import read_wav, write_wav
    assert not server.HAS_AIOHTTP
    try:
        server.create_app(None)
        raise AssertionError("create_app ran without aiohttp")
    except RuntimeError as e:
        assert "aiohttp" in str(e)
    model = server.build_model(device="cpu")
    assert len(model.ap.separator.model.mask_net.layers) == 12
    # a small separator: the CPU runs the 256/12 one too slowly for a test
    model.ap.separator = SeparationEngine(MossFormer2(dim=64, enc_channels=64, num_blocks=2,
                                                      group_size=32, qk_dim=32, fsmn_inner=64
                                                      ).eval(), device="cpu")
    audio = dialogue(3.0, seed=13, overlap=True)
    out = list(model.infer_stream((audio[i: i + 16000] for i in range(0, len(audio), 16000)),
                                  target_file=enrollment(2.0, seed=9)))
    assert all(spk == "1" for spk, res, _ in out), out
    cli._build = lambda args: model  # the CLI's own plumbing on the model just built
    tmp = tempfile.mkdtemp()
    wav, res, tgt = (os.path.join(tmp, n) for n in ("in.wav", "out.json", "target.wav"))
    write_wav(wav, dialogue(2.0, seed=5, overlap=False), 16000)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "stream", wav])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    assert all({"target_speaker_id", "speaker", "text"} <= set(x) for x in lines), lines
    cli.main(["--device", "cpu", "infer", wav, "--single", "--output-json", res,
              "--output-audio", tgt])
    with open(res, encoding="utf-8") as f:
        assert set(json.load(f)) == {"target_speaker_id", "results"}
    assert read_wav(tgt)[1] == 16000
""")


def test_cli_and_stream_run_without_jax_or_aiohttp():
    """Without aiohttp `create_app` raises, and `build_model`,
    `infer_stream` and the CLI's `stream` and `infer` run."""
    proc = _run_blocked(_BLOCKED_CLI, extra=("aiohttp",))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_SURFACE = textwrap.dedent("""
    import targetdiarization_tpu_torch as pkg
    from chip_smoke import BOOT_CHARS, synth_utterance
    from targetdiarization_tpu_torch.models.emotion import EmotionEngine
    from targetdiarization_tpu_torch.models.enhancement import EnhancerEngine
    from targetdiarization_tpu_torch.runtime import trace
    from targetdiarization_tpu_torch.serve.server import build_model
    model = build_model(device="cpu")
    ap, asrp = model.ap, model.tasr.asrp
    assert isinstance(ap.enhancer, EnhancerEngine) and isinstance(asrp.emotion, EmotionEngine)
    assert pkg.AudioProcessor is type(ap) and pkg.ASRProcessor is type(asrp)
    assert pkg.TargetDiarizationStream is type(model) and pkg.TargetASR is type(model.tasr)
    assert pkg.TargetDiarization.__name__ == "TargetDiarization"
    rng = np.random.default_rng(3)
    text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(6))
    utt = np.concatenate([np.zeros(4000, np.float32), synth_utterance(text, rng)[0],
                          np.zeros(4000, np.float32)])
    trace.reset()
    out = ap.run_modules(utt[:4000], 16000, [{"enhance_audio": {"sampling_rate": 16000,
                                                                "nfe": 1}}])
    assert out.shape == (4000,) and np.isfinite(out).all()
    assert trace.GLOBAL_TRACER.as_dict()["audio/enhance_audio"]["calls"] == 1
    emo = asrp.emotion_detection(utt)
    assert len(emo["labels"]) == len(emo["scores"]) == 9
    ts = asrp.timestamp_prediction(utt, text)
    assert len(ts) == len(text), ts
    assert asrp.vad.get_speech_timestamps(utt) and asrp.vad.is_speech(utt)
    assert len(asrp.f0_compute(utt)) > 0
    stretched = ap.audio_stretch(utt, 16000, 1.25)
    assert 0.7 * len(utt) < len(stretched) < 0.9 * len(utt)
""")


def test_surface_runs_without_jax():
    """`build_model` with its enhancer and emotion engine, the package
    root's names, `run_modules` with enhancement, emotion, forced
    alignment, the VAD helpers, F0 and the phase vocoder."""
    proc = _run_blocked(_BLOCKED_SURFACE, extra=("aiohttp",))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_ENGINES = textwrap.dedent("""
    import json, os
    from chip_smoke import dialogue, enrollment, synth_utterance
    from targetdiarization_tpu_torch.models.separation import MossFormer2, SeparationEngine
    from targetdiarization_tpu_torch.models.speaker import CAMPlusPlus
    from targetdiarization_tpu_torch.processors import cloud_asr
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor
    from targetdiarization_tpu_torch.serve.server import build_model
    os.environ.update(ASR_ENGINE="sensevoice", EMBEDDING_MODEL="checkpoints/campp-bootstrap")
    model = build_model(device="cpu")
    assert model.tasr.asrp.asr.engine == "sensevoice" and model.fused_asr is None
    assert isinstance(model.tasr.spk.model, CAMPlusPlus)
    model.ap.separator = SeparationEngine(MossFormer2(dim=64, enc_channels=64, num_blocks=2,
                                                      group_size=32, qk_dim=32, fsmn_inner=64
                                                      ).eval(), device="cpu")
    spk, results, _ = model.infer(dialogue(2.5, seed=1, overlap=True), enrollment(3.0, seed=9))
    assert spk and results and all(r["type"] == "single" for r in results), results
    audio, _ = synth_utterance("天地人", np.random.default_rng(0))
    sv = model.tasr.asrp.asr.asr_detection(audio)[0]
    assert {"language", "emotion", "event"} <= set(sv), sv
    wh = ASRProcessor(asr_model="checkpoints/whisper-v2", asr_engine="whisper_v2", device="cpu")
    assert wh.asr_detection(audio)[0]["timestamp"] == []
    reply = json.dumps({"code": 0, "data": {"text": "ok", "word_list": []}}).encode()
    cloud = ASRProcessor(asr_engine="jzx_api", device="cpu")
    cloud.api_config = {"jzx": {"endpoint": "https://jzx.invalid/asr"}}
    cloud_asr.urllib_transport = lambda *a: (200, reply)
    assert cloud.asr_detection(audio)[0]["text"] == "ok"
""")


def test_engines_run_without_jax():
    """`build_model` with ASR_ENGINE=sensevoice and CAM++ through `infer`
    (a small separator), a whisper engine, and a cloud engine over a stub
    transport."""
    proc = _run_blocked(_BLOCKED_ENGINES, extra=("aiohttp",))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_ZOO = textwrap.dedent("""
    import os, tempfile
    from unittest import mock
    import torch
    import chip_smoke
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwop
    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwk, ffconvm as ffk, flash as flk
    from targetdiarization_tpu_torch.runtime.registry import save_checkpoint
    from targetdiarization_tpu_torch.serve.server import build_model
    torch.set_num_threads(2)
    torch.cuda.synchronize = lambda *a, **k: None
    # the CPU's plain versions, counted as the card's wrappers count launches
    for mod, attr, wrapper in ((separation, "ffconvm", ffk.ffconvm),
                               (separation, "flash_gated", flk.flash_gated),
                               (dwop, "dwconv", dwk.dwconv)):
        def counted(*a, _f=getattr(mod, attr), _w=wrapper, **k):
            _w.launches += 1
            return _f(*a, **k)
        setattr(mod, attr, counted)
    args = ZOO_ARGS
    totals = chip_smoke.check_zoo(device="cpu", args=args, infer=(), seconds=(1.0, 0.5, 0.75, 0.5))
    assert totals["ffconvm"] and totals["flash_gated"] and totals["dwconv"], totals
    root = tempfile.mkdtemp()
    path = os.path.join(root, "ConvTasNet")
    save_checkpoint(path, chip_smoke.seeded_zoo_model("ConvTasNet", args["ConvTasNet"]),
                    "ConvTasNet", args["ConvTasNet"])
    with mock.patch.dict(os.environ, {"TD_SEP_CHECKPOINT": path}):
        model = build_model(device="cpu")
    assert type(model.ap.separator.model).__name__ == "ConvTasNet"
    spk, results, _ = model.infer(chip_smoke.dialogue(2.5, seed=1, overlap=True),
                                  chip_smoke.enrollment(3.0, seed=9))
    assert spk and results, results
""")


def test_zoo_runs_without_jax():
    """chip_smoke.py's zoo phase at small sizes on the CPU (every class
    written through its inverse converter, loaded by the engine, run in
    float32 and bf16 against the CPU), and `build_model()` with
    TD_SEP_CHECKPOINT naming a ConvTasNet checkpoint through `infer`."""
    from torch_zoo_cases import TINY

    zoo_args = dict(TINY, BSRNN=dict(TINY["BSRNN"], sample_rate=44100, num_output=4,
                                     num_spks=4))
    proc = _run_blocked(_BLOCKED_ZOO.replace("ZOO_ARGS", repr(zoo_args)), extra=("aiohttp",))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_TRAIN = textwrap.dedent("""
    import os, tempfile
    import chip_smoke
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwop
    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwk, ffconvm as ffk, flash as flk
    from targetdiarization_tpu_torch.runtime.registry import save_checkpoint
    from targetdiarization_tpu_torch.train import SeparationTrainer, TrainConfig
    # the CPU's plain versions, counted as the card's wrappers count launches
    for mod, attr, wrapper in ((separation, "ffconvm", ffk.ffconvm),
                               (separation, "flash_gated", flk.flash_gated),
                               (dwop, "dwconv", dwk.dwconv)):
        def counted(*a, _f=getattr(mod, attr), _w=wrapper, **k):
            _w.launches += 1
            return _f(*a, **k)
        setattr(mod, attr, counted)
    dx = dwk._dx
    def dx_counted(g, w, *a):
        dwk.dwconv.backward_launches += w.shape[1] == 1  # the card's dx launches at m = 1
        return dx(g, w, *a)
    dwk._dx = dx_counted
    args = dict(dim=64, enc_channels=64, num_blocks=2, group_size=32, qk_dim=32, fsmn_inner=64)
    root = tempfile.mkdtemp()
    model = separation.MossFormer2(**args)
    save_checkpoint(root, SeparationTrainer(model, device="cpu").model, "MossFormer2", args)
    launches, _ = chip_smoke.check_train(
        device="cpu", checkpoint=root, batch=2, seconds=0.25, steps=2,
        convtasnet_args=dict(enc_channels=32, bottleneck=16, hidden=32, n_blocks=3, n_repeats=1))
    assert launches == {"ffconvm": 20, "flash_gated": 4, "flash_group": 0, "dwconv": 8,
                        "dwconv_dx": 4}, launches
    # the recipes phase at small sizes: each recipe with the kernels' wrappers
    # and under plain_kernels(), launches a step as predicted, served back
    sep = dict(dim=32, enc_channels=32, num_blocks=2, group_size=64, qk_dim=32, fsmn_inner=32)
    runs = (("vad", "bootstrap_vad", dict(steps=2, batch=2, seconds=1.0), "vad"),
            ("sep", "bootstrap_separator", dict(steps=2, batch=2, seconds=0.25, model=sep), None),
            ("rest", "bootstrap_restorer", dict(steps=2, batch=2, seconds=0.5, feature_dim=16,
                                                layer=1), None),
            ("asr", "bootstrap_asr", dict(steps=2, batch=2, seconds=1.0, eval_utts=1, dim=32,
                                          enc_layers=1, dec_layers=1, ffn=64, device_synth=True,
                                          aug_frac=0.5), None),
            ("sv", "bootstrap_sensevoice", dict(steps=2, batch=2, seconds=1.0, eval_utts=1,
                                                dim=32, enc_layers=1, ffn=64), None))
    totals = chip_smoke.check_recipes(device="cpu", runs=runs)
    assert totals["ffconvm"] and totals["flash_gated"] and totals["dwconv_dx"], totals
""")


def test_training_runs_without_jax_or_optax():
    """chip_smoke.py's train phase at a small size on the CPU: gradients
    against plain, 2 fit steps with their launches counted, save and
    restore, the inference export through the engine, and ConvTasNet's
    steps; then its recipes phase at small sizes (the five recipes of
    `train/recipes.py`, the ASR one on its device data path through the
    preprocess chain), with optax blocked too."""
    proc = _run_blocked(_BLOCKED_TRAIN, extra=("aiohttp", "optax"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_RECIPES_PLAIN = textwrap.dedent("""
    import numpy as np
    import chip_smoke
    from targetdiarization_tpu_torch.models import denoise
    from targetdiarization_tpu_torch.train import metrics, mos
    # train/mos.py alone: the shipped estimators through the metrics tracker
    est = mos.MOSEstimator.from_pretrained("checkpoints/mos-bootstrap", device="cpu")
    sig = mos.SigMOSEstimator.from_pretrained("checkpoints/sigmos-bootstrap", device="cpu")
    x = chip_smoke.conversation(3.0, seed=46)
    row = metrics.MetricsTracker(mos_estimator=est, sigmos_estimator=sig).update("a", x, x, x)
    assert {"dnsmos_ovrl", "dnsmos_p808", "mos_ovrl"} <= set(row), row
    assert all(np.isfinite(v) for k, v in row.items() if k != "key"), row
    # the plain recipes phase at tiny sizes on the CPU (the MDX frames cut to
    # 32): every recipe, no kernel launched, its checkpoints reloaded
    denoise.DIM_T = 32
    tiny = dict(steps=2, batch=2)
    runs = (("spk", "bootstrap_speaker", dict(tiny, seconds=1.0), "spk"),
            ("seg", "bootstrap_segmentation", dict(tiny, seconds=1.0), "seg"),
            ("enh", "bootstrap_enhancer", dict(tiny, seconds=0.25, ch=8), "enh"),
            ("mos", "bootstrap_mos", dict(tiny, pool=2), "mos"),
            ("sigmos", "bootstrap_sigmos", dict(tiny, pool=2), "sigmos"),
            ("den", "bootstrap_denoiser", dict(tiny, batch=1), "den"),
            ("punc", "bootstrap_punc", dict(tiny, eval_utts=1), "punc"),
            ("emo", "bootstrap_emotion", dict(tiny, seconds=0.5, eval_utts=1), "emo"),
            ("whisper", "bootstrap_whisper",
             dict(tiny, seconds=1.0, eval_utts=1, n_corpus=2, dim=32, enc_layers=1,
                  dec_layers=1, ffn=64, device_synth=True, fresh_source="device",
                  phase1_steps=0, aug_frac=0.5), "whisper"))
    totals = chip_smoke.check_recipes_plain(device="cpu", runs=runs)
    assert totals and not any(totals.values()), totals
""")


def test_plain_recipes_and_mos_run_without_jax_or_optax():
    """`train/mos.py`'s estimators on the shipped checkpoints through the
    metrics tracker, and chip_smoke.py's plain recipes phase at tiny sizes
    (the nine recipes of `train/recipes_plain.py`, the whisper one on
    device batches through the preprocess chain), with optax blocked too."""
    proc = _run_blocked(_BLOCKED_RECIPES_PLAIN, extra=("aiohttp", "optax"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_PORT_RULES = textwrap.dedent("""
    import chip_smoke
    import targetdiarization_tpu_torch.runtime as runtime
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwop
    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwk, ffconvm as ffk, flash as flk
    from targetdiarization_tpu_torch.runtime import onnx_io, port_rules
    from targetdiarization_tpu_torch.tools import reference_layout
    # the runtime layer's names
    x, n = runtime.pad_to_bucket(np.ones((2, 300), np.float32),
                                 runtime.BucketLadder.from_seconds(sr=100))
    assert x.shape == (2, 400) and n == 300
    mask = runtime.length_mask(torch.tensor([2, 5]), 5)
    assert runtime.masked_mean(torch.ones(2, 5), mask, axis=1).tolist() == [1.0, 1.0]
    assert runtime.param_count({"w": np.zeros((3, 4))}) == 12
    # one conversion by each reader: a reference dict, a graph's bytes
    args = dict(out_channels=8, in_channels=16, num_blocks=2, upsampling_depth=2,
                enc_kernel_size=2)
    sd = port_rules.convert_tdanet(reference_layout.reference_state_dict("TDANet", args))
    runtime.get_model_cls("TDANet")(**args).load_state_dict(sd, strict=True)
    graph = onnx_io.load_onnx(onnx_io.save_onnx(
        reference_layout.sigmos_graph(np.random.default_rng(0), ch=8)))
    from targetdiarization_tpu_torch.train.mos import SigMOSNet
    net = SigMOSNet(ch=8)
    assert set(onnx_io.onnx_to_state_dict(graph, net)) == set(net.state_dict())
    # chip_smoke.py's port_rules phase at small sizes, the CPU's plain
    # versions counted as the card's wrappers count launches
    for mod, attr, wrapper in ((separation, "ffconvm", ffk.ffconvm),
                               (separation, "flash_gated", flk.flash_gated),
                               (dwop, "dwconv", dwk.dwconv)):
        def counted(*a, _f=getattr(mod, attr), _w=wrapper, **k):
            _w.launches += 1
            return _f(*a, **k)
        setattr(mod, attr, counted)
    models = [("MossFormer2", dict(dim=64, enc_channels=64, num_blocks=2, group_size=64,
                                   qk_dim=32, fsmn_inner=64)),
              ("Apollo", dict(sr=16000, win_ms=20, feature_dim=16, layer=1)),
              ("ConvTasNet", dict(enc_channels=32, bottleneck=16, hidden=32, n_blocks=3,
                                  n_repeats=1))]
    totals = chip_smoke.check_port_rules(
        device="cpu", models=models, seconds=0.5,
        mos_nets=(("DNSMOSNet", 3, 8, (1, 100, 120)), ("DNSMOSNet", 1, 8, (1, 100, 120)),
                  ("SigMOSNet", 7, 8, (1, 3, 40, 481))))
    assert totals == {"ffconvm": 10, "flash_gated": 2, "flash_group": 0, "dwconv": 10}, totals
""")


def test_reference_checkpoint_readers_run_without_jax_or_optax():
    """The runtime package, `runtime/port_rules.py`, `runtime/onnx_io.py`
    and `tools/reference_layout.py` import and convert (a TDANet reference
    dict, a SigMOS graph), and chip_smoke.py's port_rules phase runs at
    small sizes, with jax, flax, optax, sklearn and the JAX package
    blocked."""
    proc = _run_blocked(_BLOCKED_PORT_RULES, extra=("aiohttp", "optax"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_MESH = textwrap.dedent("""
    import tempfile
    import chip_smoke
    from targetdiarization_tpu_torch import parallel
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwop
    from targetdiarization_tpu_torch.ops.kernels import count_launch
    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwk, ffconvm as ffk, flash as flk
    from targetdiarization_tpu_torch.runtime.registry import save_checkpoint
    from targetdiarization_tpu_torch.train import SeparationTrainer, TrainConfig
    from targetdiarization_tpu_torch.train.trainer import init_params
    torch.cuda.synchronize = lambda *a, **k: None
    # the CPU's plain versions, counted as the card's wrappers count
    # launches (from the slots' threads at once)
    for mod, attr, wrapper in ((separation, "ffconvm", ffk.ffconvm),
                               (separation, "flash_gated", flk.flash_gated),
                               (dwop, "dwconv", dwk.dwconv)):
        def counted(*a, _f=getattr(mod, attr), _w=wrapper, **k):
            count_launch(_w)
            return _f(*a, **k)
        setattr(mod, attr, counted)
    dx = dwk._dx
    def dx_counted(g, w, *a):
        if w.shape[1] == 1:  # the card's dx launches at m = 1
            count_launch(dwk.dwconv, "backward_launches")
        return dx(g, w, *a)
    dwk._dx = dx_counted
    args = dict(dim=32, enc_channels=32, num_blocks=2, group_size=32, qk_dim=16, fsmn_inner=16)
    model = separation.MossFormer2(**args)
    model.load_state_dict(init_params(model, 0))
    root = tempfile.mkdtemp()
    save_checkpoint(root, model, "MossFormer2", args)
    # the mesh phase on two CPU slots: the four checks of
    # tools/dryrun_multichip.py with the small separator and the shipped
    # den-, vad-, seg-, spk-, asr- and punc-bootstrap
    totals = chip_smoke.check_mesh(mesh=parallel.Mesh(["cpu", "cpu"]), separator=root)
    assert totals == {"ffconvm": 60, "flash_gated": 12, "flash_group": 0, "dwconv": 64,
                      "dwconv_dx": 8}, totals
    trainer = SeparationTrainer(separation.MossFormer2(**args), cfg=TrainConfig(
        save_every=0, n_devices=2), device="cpu")
    assert trainer.n_devices == 2
""")


def test_mesh_runs_without_jax_or_optax():
    """`parallel/` and chip_smoke.py's mesh phase on two CPU slots at a
    small size (`tools/dryrun_multichip.py`: the trainer on the mesh
    against one slot, the separation engine, the sharded analyze and ASR,
    each sharded run's launches as predicted), with optax blocked too."""
    proc = _run_blocked(_BLOCKED_MESH, extra=("aiohttp", "optax"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


_BLOCKED_HOST = textwrap.dedent("""
    import glob, json, os, tempfile
    import chip_smoke
    from targetdiarization_tpu_torch.ops.loudness import integrated_loudness
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor
    from targetdiarization_tpu_torch.runtime.trace import device_profile, trace
    from targetdiarization_tpu_torch.utils import native
    # the host library, built here from the port's own source
    assert native.has_native()
    assert native.SOURCE.endswith(os.path.join("csrc", "host", "tdaudio.cpp"))
    x = (0.1 * np.random.default_rng(0).standard_normal(32000)).astype(np.float32)
    assert abs(native.integrated_loudness_native(x, 16000) - integrated_loudness(x, 16000)) <= 1e-9
    ap = AudioProcessor(device="cpu")
    assert ap.meter_loudness(x, 16000) == native.integrated_loudness_native(x, 16000)
    pcm = native.f32_to_pcm16(x)
    assert np.array_equal(native.pcm16_to_f32(pcm), native.pcm16_to_f32_plain(pcm))
    assert np.array_equal(native.resample_linear(x, 7), native.resample_linear_plain(x, 7))
    ring = native.RingBuffer(8)
    assert ring.push(x) == 8 and ring.space() == 0 and np.array_equal(ring.pop(8), x[:8])
    chip_smoke.check_host()  # the card's host_library phase
    # a compressed file through a stub ffmpeg on the PATH
    root = tempfile.mkdtemp()
    with open(os.path.join(root, "s.f32"), "wb") as f:
        f.write(x[:1000].astype("<f4").tobytes())
    with open(os.path.join(root, "ffmpeg"), "w") as f:
        f.write(f"#!/bin/sh\\ncat '{root}/s.f32'\\n"
                "echo '  Stream #0:0: Audio: mp3, 22050 Hz, mono, fltp' >&2\\n")
    os.chmod(os.path.join(root, "ffmpeg"), 0o755)
    os.environ["PATH"] = root + os.pathsep + os.environ["PATH"]
    path = os.path.join(root, "in.mp3")
    with open(path, "wb") as f:
        f.write(b"ID3" + bytes(100))
    audio, sr = ap.read_audio(path)
    assert sr == 22050 and np.array_equal(audio, x[:1000])
    # torch.profiler imports torch._inductor, whose trace rules look up
    # optional libraries (sklearn among them) by find_spec without importing
    # them: where one is absent that returns None, here the blocker raises.
    # So torch._inductor is imported unblocked; the leak check below still
    # holds that nothing blocked was imported
    blocker = next(f for f in sys.meta_path if type(f).__name__ == "Block")
    sys.meta_path.remove(blocker)
    import torch._inductor
    sys.meta_path.insert(0, blocker)
    # device_profile, and chip_smoke.py's profile line read back from it
    conv = torch.nn.Conv1d(4, 4, 3)
    with device_profile(os.path.join(root, "trace")) as log_dir:
        with trace("fused/separate"):
            conv(torch.ones(1, 4, 16))
    (p,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(p) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names == ["fused/separate"], names
    torch.cuda.synchronize = lambda *a, **k: None
    def forward():
        with trace("fused/separate"):
            conv(torch.ones(1, 4, 16))
    got = chip_smoke.profile_call(forward, "CPU dry run", spans=True)
    assert got["ranges"]["fused/separate"] == 1
    assert chip_smoke.trace_launches(got["device"]) == dict.fromkeys(
        ("ffconvm", "flash_gated", "flash_group", "dwconv"), 0)
""")


def test_host_library_decoder_and_profile_run_without_jax():
    """`utils/native.py` (built here with g++ from the port's source, and
    chip_smoke.py's host_library phase), a compressed file through
    `AudioProcessor.read_audio` and a stub ffmpeg, and `device_profile`
    with chip_smoke.py's reading of its trace, with jax, flax, sklearn,
    aiohttp and the JAX package blocked."""
    proc = _run_blocked(_BLOCKED_HOST, extra=("aiohttp",))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


@pytest.mark.parametrize("first,then", [("recipes_plain", "recipes"),
                                         ("recipes", "recipes_plain")])
def test_recipe_modules_import_in_either_order(first, then):
    """`train/recipes_plain.py` reads `train/recipes.py`'s pieces and
    `train/recipes.py` serves its recipes: a fresh interpreter imports
    either module first and sees the same nine recipes through both."""
    proc = _run_blocked(textwrap.dedent(f"""
        from targetdiarization_tpu_torch.train import {first}
        from targetdiarization_tpu_torch.train import {then}
        from targetdiarization_tpu_torch.train import recipes, recipes_plain
        from targetdiarization_tpu_torch.train.recipes import bootstrap_speaker
        assert bootstrap_speaker is recipes_plain.bootstrap_speaker
        for name in recipes._PLAIN:
            assert getattr(recipes, name) is getattr(recipes_plain, name), name
    """), extra=("aiohttp", "optax"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout


def test_asr_processor_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_ASR], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ASR_ISOLATED_OK" in proc.stdout


@pytest.mark.parametrize("kind", ["vad_model", "asr_model", "punc_model"])
def test_missing_asr_checkpoint_raises(kind, tmp_path):
    from targetdiarization_tpu_torch.processors.asr import ASRProcessor

    with pytest.raises(FileNotFoundError, match="not found"):
        ASRProcessor(**{kind: str(tmp_path / "no-such-checkpoint")}, device="cpu")


def test_chip_smoke_without_cuda_fails_on_cuda_not_import():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "ImportError" not in proc.stderr and "ModuleNotFoundError" not in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_missing_separator_checkpoint_raises(tmp_path):
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    with pytest.raises(FileNotFoundError):
        AudioProcessor(str(tmp_path / "no-such-checkpoint"), device="cpu")


def test_unconfigured_separator_returns_input_twice():
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    ap = AudioProcessor(device="cpu")
    assert not ap.is_separate_speaker
    x = np.linspace(-0.5, 0.5, 1000).astype(np.float32)
    a, b = ap.separate_speaker(x)
    np.testing.assert_array_equal(a, x)
    np.testing.assert_array_equal(b, x)


def test_unported_model_name_raises():
    from targetdiarization_tpu_torch.runtime.registry import get_model_cls

    # every name of the JAX registry is ported since the zoo (ConvTasNet
    # was this test's name until then)
    with pytest.raises(KeyError, match="not ported"):
        get_model_cls("NoSuchSeparator")


def _signals():
    rng = np.random.default_rng(3)
    sr = 16000
    t = np.arange(3 * sr) / sr
    noise = (0.05 * rng.standard_normal(t.size)).astype(np.float32)
    gated = np.sin(2 * np.pi * 220 * t) * (t < 1.0) * 0.5 \
        + np.sin(2 * np.pi * 880 * t) * (t > 2.0) * 0.001  # relative gate drops the quiet tail
    short = (0.2 * rng.standard_normal(sr // 4)).astype(np.float32)  # under one 400 ms block
    return [noise, gated.astype(np.float32), short]


@pytest.mark.parametrize("which", range(3))
def test_loudness_matches_jax_package_meter(which):
    from targetdiarization_tpu.utils.native import integrated_loudness_native
    from targetdiarization_tpu_torch.ops.loudness import integrated_loudness

    x = _signals()[which]
    assert abs(integrated_loudness(x, 16000) - integrated_loudness_native(x, 16000)) <= 0.05
