"""Data parallelism over a mesh (`parallel/mesh.py`) against the JAX
package's, on the CPU: the port on n CPU slots against the JAX package on
n of the 8 virtual CPU devices that tests/conftest.py makes, n = 2 and 4.
The JAX side runs at full float32 matmul precision.

- `data_parallel_step` on tests/test_runtime.py's toy step, `pjit_forward`
  and `shard_batch` on a small dense layer;
- `SeparationEngine(mesh=)` on tests/test_parallel_extras.py's small
  MossFormer2: 5 clips (`separate_batch`: the batcher's rung of 8 rows,
  padded to a mesh multiple) and a clip of 3 windows (`separate`), within
  1e-4 of the JAX engine on its mesh and 1e-6 of the port's single slot;
- `FusedFrontend.build_analyze_sharded` on 4 rows at the 32000 rung with
  the shipped den-, vad-, seg- and spk-bootstrap against the JAX
  package's: at tests/test_torch_fused.py's limits (the analysed int16
  within 1 LSB, `vad_probs` 1e-2, `seg_act` 2e-3, embeddings at cosine
  0.9999; the two packages' float32 fbanks part by up to 4e-3 in
  low-energy bins), and within 1e-6 of the port's per-row analyze;
- `FusedASR.build_sharded` on 4 tracks with the shipped asr- and
  punc-bootstrap: token counts, ids and punctuation classes equal to the
  JAX package's and to the port's unsharded pass;
- the kernel wrappers' launch counters under concurrent threads.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import denoise as jden
from targetdiarization_tpu.models import diarization as jdia
from targetdiarization_tpu.models import speaker as jspk
from targetdiarization_tpu.models.asr import ASREngine as JaxASREngine
from targetdiarization_tpu.models.punctuation import PunctuationEngine as JaxPuncEngine
from targetdiarization_tpu.models.separation import MossFormer2 as JaxMossFormer2
from targetdiarization_tpu.models.separation import SeparationEngine as JaxSeparationEngine
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.parallel import mesh as jmesh
from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu.runtime.params import upgrade_scan_layout
from targetdiarization_tpu.train import synth
from targetdiarization_tpu_torch.models.asr import ASREngine
from targetdiarization_tpu_torch.models.denoise import DenoiseEngine
from targetdiarization_tpu_torch.models.diarization import SegmentationEngine
from targetdiarization_tpu_torch.models.punctuation import PunctuationEngine
from targetdiarization_tpu_torch.models.separation import MossFormer2, SeparationEngine
from targetdiarization_tpu_torch.models.speaker import SpeakerEngine
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.ops.kernels import count_launch
from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm
from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_group_attention
from targetdiarization_tpu_torch.parallel import (Mesh, data_parallel_step, make_mesh,
                                                  pjit_forward, replicated, shard_batch)
from targetdiarization_tpu_torch.pipeline import fused as tfused
from targetdiarization_tpu_torch.runtime.convert import INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)  # beside the other test workers' threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(REPO, "checkpoints", f"{k}-bootstrap")
        for k in ("den", "vad", "seg", "spk", "asr", "punc")}
F32 = {"device": "cpu", "compute_dtype": "float32"}
SMALL = dict(dim=16, enc_channels=16, num_blocks=1, group_size=32, qk_dim=16, kernel_size=8,
             fsmn_inner=8)  # tests/test_parallel_extras.py's MossFormer2
NS = (2, 4)
BUCKET = 32000


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _speech(rows: int, n: int, seed: int) -> np.ndarray:
    """(rows, n) int16 rows of synthesized utterances."""
    rng = np.random.default_rng(seed)
    out = np.zeros((rows, n), np.float32)
    for r in range(rows):
        utt = synth.synth_utterance(synth.random_text(rng, 6, 10), rng)[0][:n]
        out[r, : len(utt)] = 0.5 * utt
    return np.clip(np.round(out * 32768.0), -32768, 32767).astype(np.int16)


# ---------------- the mesh's own pieces ----------------


@pytest.mark.parametrize("n", NS)
def test_data_parallel_step_matches_jax(n):
    """tests/test_runtime.py's toy step (the gradient of mean((x w)^2),
    then SGD) on 16 rows: the new state and the loss equal the JAX
    package's and the single-device step's."""
    x = np.arange(16, dtype=np.float32).reshape(16, 1)

    def step(state, batch):
        def loss(w):
            return jnp.mean((batch["x"] * w["w"]) ** 2)

        g = jax.grad(loss)(state)
        return {"w": state["w"] - 0.1 * g["w"]}, {"loss": loss(state)}

    mesh = jmesh.make_mesh(n)
    want, want_metrics = jmesh.data_parallel_step(step, mesh, donate_state=False)(
        {"w": jnp.full((4,), 2.0)}, jmesh.shard_batch(mesh, {"x": jnp.asarray(x)}))
    run = data_parallel_step(lambda s, b: ((b["x"] * s["w"]) ** 2).mean(),
                             lambda s, g: {"w": s["w"] - 0.1 * g["w"]}, make_mesh(n, "cpu"))
    state, metrics = run({"w": torch.full((4,), 2.0)}, {"x": x})
    assert _rel(state["w"], np.asarray(want["w"])) <= 1e-6
    assert _rel(metrics["loss"], float(want_metrics["loss"])) <= 1e-6
    single, _ = step({"w": jnp.full((4,), 2.0)}, {"x": jnp.asarray(x)})
    assert _rel(state["w"], np.asarray(single["w"])) <= 1e-6


@pytest.mark.parametrize("n", NS)
def test_pjit_forward_and_shard_batch(n):
    """tests/test_parallel_extras.py's sharded dense forward: the rows
    joined in order equal the JAX package's and the unsharded forward;
    `shard_batch` cuts equal contiguous shards in slot order and raises
    on a batch the mesh size does not divide, as `batch_sharding` does."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(jmesh.pjit_forward(lambda p, b: jnp.tanh(b @ p), jmesh.make_mesh(n))(
        jnp.asarray(w), jnp.asarray(x)))
    mesh = make_mesh(n, "cpu")
    layer = torch.nn.Linear(8, 4, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
    replicas = replicated(mesh, layer)
    assert replicas[0] is layer and all(r is not layer for r in replicas[1:])
    with torch.inference_mode():
        got = pjit_forward(lambda m, b: torch.tanh(m(b)), mesh)(replicas, x)
    assert _rel(got, want) <= 1e-6
    shards = shard_batch(mesh, {"x": x})
    assert [s["x"].shape[0] for s in shards] == [16 // n] * n
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, x[:16 - 1])
    mesh.close()


def test_make_mesh_counts_cards_and_cpu_slots():
    """`make_mesh` on the CPU gives the slots asked for (one by default);
    on the cards it raises, naming the counts, when too few are visible;
    a mesh lists its slots, repeated only when the caller lists them."""
    assert tuple(make_mesh(device="cpu")) == (torch.device("cpu"),)
    assert make_mesh(3, "cpu").size == 3
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{visible + 1} cards .* {visible} are visible"):
        make_mesh(visible + 1)
    assert tuple(Mesh(["cpu", "cpu"])) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="one device type"):
        Mesh(["cpu", "meta"])


def test_mesh_map_runs_each_slot_in_its_worker_and_raises():
    """Each slot's call runs in that slot's worker thread under the
    caller's grad mode; an error in one slot reaches the caller after
    every slot has run; a call from inside a slot raises."""
    mesh = make_mesh(3, "cpu")
    with torch.no_grad():
        out = mesh.map(lambda i, a: (i, a, threading.current_thread().name,
                                     torch.is_grad_enabled()), ["a", "b", "c"])
    assert [o[:2] for o in out] == [(0, "a"), (1, "b"), (2, "c")]
    assert [o[2].startswith(f"mesh-slot{i}") for i, o in enumerate(out)] == [True] * 3
    assert not any(o[3] for o in out)
    ran = []

    def fails(i):
        ran.append(i)
        if i == 1:
            raise KeyError("slot 1")

    with pytest.raises(KeyError, match="slot 1"):
        mesh.map(fails)
    assert sorted(ran) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="its own worker"):
        mesh.map(lambda i: mesh.map(lambda j: j))
    mesh.close()


def test_launch_counters_are_exact_under_threads():
    """`count_launch` from 16 threads at once, with the interpreter
    switching threads every microsecond: no count is lost."""
    wrappers = ((ffconvm, "launches"), (flash_gated, "launches"),
                (flash_group_attention, "launches"), (dwconv, "launches"),
                (dwconv, "backward_launches"))
    before = {(w, c): getattr(w, c) for w, c in wrappers}
    threads, per = 16, 500

    def bump():
        for _ in range(per):
            for w, c in wrappers:
                count_launch(w, c)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=bump) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
        for w, c in wrappers:
            assert getattr(w, c) - before[(w, c)] == threads * per, (w.__name__, c)
    finally:
        sys.setswitchinterval(interval)
        for (w, c), v in before.items():
            setattr(w, c, v)


# ---------------- SeparationEngine(mesh=) ----------------


@pytest.fixture(scope="module")
def separator_params():
    """The small MossFormer2's parameters: a seeded draw as the port's state
    dict, and the same as the JAX package's tree (its loader's layout)."""
    state_dict = init_params(MossFormer2(**SMALL), seed=0)
    flat = INVERSE_CONVERTERS["MossFormer2"](state_dict)
    tree = upgrade_scan_layout("MossFormer2", unflatten({k: jnp.asarray(v)
                                                         for k, v in flat.items()}))
    return tree, state_dict


def _port_engine(state_dict, mesh=None):
    model = MossFormer2(**SMALL)
    model.load_state_dict(state_dict, strict=True)
    return SeparationEngine(model, window=4000, mesh=mesh, **F32)


@pytest.mark.parametrize("n", NS)
def test_separation_engine_mesh_matches_jax(separator_params, n):
    jparams, state_dict = separator_params
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(2000 + 300 * i).astype(np.float32) * 0.1 for i in range(5)]
    audio = rng.standard_normal(11000).astype(np.float32) * 0.1  # 3 windows
    theirs = JaxSeparationEngine(params=jparams, model=JaxMossFormer2(**SMALL), window=4000,
                                 compute_dtype="float32", mesh=jmesh.make_mesh(n))
    with jax.default_matmul_precision("highest"):
        want, want_win = theirs.separate_batch(clips), theirs.separate(audio)
    mesh = make_mesh(n, "cpu")
    ours, single = _port_engine(state_dict, mesh), _port_engine(state_dict)
    assert len(ours.replicas) == n and ours.replicas[0] is ours.model
    got, got_win = ours.separate_batch(clips), ours.separate(audio)
    alone, alone_win = single.separate_batch(clips), single.separate(audio)
    assert got_win.shape == (2, 11000)
    for g, w, a in zip(got + [got_win], want + [want_win], alone + [alone_win]):
        assert g.shape == w.shape == a.shape
        assert _rel(g, w) <= 1e-4
        assert _rel(g, a) <= 1e-6
    mesh.close()


def test_separation_engine_pads_rows_to_the_mesh(separator_params):
    """5 rows on 2 slots: `_pad_rows` adds a row of length 1, each slot
    runs 3, and the 5 rows come back as the single slot gives them."""
    _, state_dict = separator_params
    mesh = make_mesh(2, "cpu")
    engine = _port_engine(state_dict, mesh)
    batch = np.random.default_rng(3).standard_normal((5, 4000)).astype(np.float32) * 0.1
    lengths = np.array([4000, 3900, 3000, 2500, 2000])
    padded, padded_lengths = engine._pad_rows(batch, lengths, 5)
    assert padded.shape == (6, 4000) and list(padded_lengths) == [*lengths, 1]
    seen = []
    for replica in engine.replicas:
        replica.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape[0]))
    got = engine._forward(batch, lengths)
    assert seen == [3, 3] and got.shape == (5, 2, 4000)
    assert _rel(got, _port_engine(state_dict)._forward(batch, lengths)) <= 1e-6
    mesh.close()


# ---------------- the sharded analyze and ASR ----------------


@pytest.fixture(scope="module")
def frontends():
    ours = tfused.FusedFrontend(
        DenoiseEngine.from_pretrained(CKPT["den"], **F32),
        VADEngine.from_pretrained(CKPT["vad"], **F32),
        SegmentationEngine.from_pretrained(CKPT["seg"], **F32),
        SpeakerEngine.from_pretrained(CKPT["spk"], **F32))
    theirs = jfused.FusedFrontend(
        jden.DenoiseEngine.from_pretrained(CKPT["den"]),
        JaxVADEngine.from_pretrained(CKPT["vad"]),
        jdia.SegmentationEngine.from_pretrained(CKPT["seg"]),
        jspk.SpeakerEngine.from_pretrained(CKPT["spk"]))
    return ours, theirs


@pytest.fixture(scope="module")
def analyze_rows(frontends):
    """4 rows of speech at the rung, their valid lengths, and the port's
    per-row `_analyze_device` of each."""
    a_i16 = _speech(4, BUCKET, seed=2)
    n_valid = np.array([BUCKET, 29000, 26000, 23000])
    with torch.inference_mode():
        rows = [frontends[0]._analyze_device(torch.from_numpy(a_i16[i]), int(n_valid[i]), BUCKET)
                for i in range(4)]
    return a_i16, n_valid, {k: np.stack([r[k].numpy() for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("n", NS)
def test_analyze_sharded_matches_jax(frontends, analyze_rows, n):
    ours, theirs = frontends
    a_i16, n_valid, per_row = analyze_rows
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(theirs.build_analyze_sharded(BUCKET, jmesh.make_mesh(n))(
            theirs.denoiser._params_c, theirs.vad._params_c, theirs.seg._params_c,
            theirs.spk._params_c, a_i16, n_valid))
    mesh = make_mesh(n, "cpu")
    got = {k: v.numpy() for k, v in ours.build_analyze_sharded(BUCKET, mesh)(
        a_i16, n_valid).items()}
    assert set(got) == set(want) == {"audio_i16", "vad_probs", "seg_act", "win_embs"}
    for k in got:
        assert got[k].shape == want[k].shape, k
    lsb = np.abs(got["audio_i16"].astype(np.int64) - want["audio_i16"])
    assert lsb.max() <= 1 and (lsb > 0).mean() < 0.01
    assert np.abs(got["vad_probs"] - want["vad_probs"]).max() <= 1e-2
    assert np.abs(got["seg_act"] - want["seg_act"]).max() <= 2e-3
    assert _cos(got["win_embs"], want["win_embs"]).min() >= 0.9999
    for k in got:
        assert _rel(got[k], per_row[k]) <= 1e-6, k
    mesh.close()


@pytest.fixture(scope="module")
def asr_engines():
    return ((ASREngine.from_pretrained(CKPT["asr"], **F32),
             PunctuationEngine.from_pretrained(CKPT["punc"], **F32)),
            (JaxASREngine.from_pretrained(CKPT["asr"]),
             JaxPuncEngine.from_pretrained(CKPT["punc"])))


@pytest.mark.parametrize("n", NS)
def test_fused_asr_sharded_matches_jax(asr_engines, n):
    (asr, punc), (jasr, jpunc) = asr_engines
    ours, theirs = tfused.FusedASR(asr, punc), jfused.FusedASR(jasr, jpunc)
    assert ours.punc is not None and theirs.punc is not None
    audio = _speech(1, BUCKET, seed=7)[0]
    ranges = np.zeros((4, 2, 2), np.float32)
    for i in range(4):
        ranges[i, 0] = (i * 1000.0, BUCKET - i * 1000.0)
    n_lfr = np.full(4, 34, np.int64)  # ceil(num_frames(32000) / LFR_N)
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(theirs.build_sharded(BUCKET, 4, 2, jmesh.make_mesh(n))(
            jasr._params_c, jpunc._params_c, jnp.asarray(audio), jnp.asarray(ranges),
            jnp.asarray(n_lfr.astype(np.int32))))
    mesh = make_mesh(n, "cpu")
    got = {k: v.numpy() for k, v in ours.build_sharded(BUCKET, 4, 2, mesh)(
        audio, ranges, n_lfr).items()}
    with torch.inference_mode():
        alone = {k: v.numpy() for k, v in ours._device(
            torch.from_numpy(audio), torch.from_numpy(ranges), torch.from_numpy(n_lfr)).items()}
    np.testing.assert_array_equal(got["n_tokens"], want["n_tokens"])
    assert got["n_tokens"].min() > 0
    for i, k in enumerate(got["n_tokens"]):
        for key in ("ids", "punc_cls"):
            np.testing.assert_array_equal(got[key][i, :k], want[key][i, :k])
    for key in got:
        np.testing.assert_array_equal(got[key], alone[key])
    mesh.close()
