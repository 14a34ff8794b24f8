"""The port's ASR stage against the JAX package on the CPU.

Both packages load the shipped `checkpoints/{asr,punc,vad}-bootstrap`
(the port through `runtime/convert.py`) and take the same numpy inputs:
synthetic speech from the JAX package's `train/synth.py`, made from a
seed. JAX runs at full float32 matmul precision, the port with
`device="cpu"` in float32. Module by module: fbank and LFR, the VAD, the
Paraformer's encoder, CIF and decoder, punctuation; then `ASRProcessor`
of both packages end to end.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import asr as jasr
from targetdiarization_tpu.models import features as jfeat
from targetdiarization_tpu.models.punctuation import PunctuationEngine as JaxPunctuationEngine
from targetdiarization_tpu.models.tokenizer import CharTokenizer as JaxCharTokenizer
from targetdiarization_tpu.models.vad import VADEngine as JaxVADEngine
from targetdiarization_tpu.processors.asr import ASRProcessor as JaxASRProcessor
from targetdiarization_tpu.runtime.params import load_checkpoint, upgrade_scan_layout
from targetdiarization_tpu.runtime.precision import quantize_i16 as jax_quantize_i16
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import synth
from targetdiarization_tpu_torch.models import asr as tasr
from targetdiarization_tpu_torch.models import features as tfeat
from targetdiarization_tpu_torch.models.punctuation import PunctuationEngine
from targetdiarization_tpu_torch.models.tokenizer import CharTokenizer
from targetdiarization_tpu_torch.models.vad import VADEngine
from targetdiarization_tpu_torch.processors.asr import ASRProcessor
from targetdiarization_tpu_torch.runtime.convert import paraformer_state_dict
from targetdiarization_tpu_torch.runtime.precision import quantize_i16
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

torch.set_num_threads(2)  # beside the other test workers' threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {name: os.path.join(REPO, "checkpoints", f"{name}-bootstrap")
        for name in ("vad", "asr", "punc")}
SR = 16000


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def speech():
    """Three utterances (2 s, 4 s and 16 s rungs; the last over 8 s) and a
    clip of utterances and silences, from one seed."""
    rng = np.random.default_rng(11)
    texts = ["三王口手", "天地人日月水火山石田", synth.BOOT_CHARS + "一二三四"]
    utts = [synth.synth_utterance(t, rng)[0] for t in texts]
    gap = np.zeros(SR // 2, np.float32)
    clip = np.concatenate([utts[0], gap, gap, utts[1], gap])
    return {"texts": texts, "utts": utts, "clip": clip}


def _jax_highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


# ---------------- front end ----------------


def test_tokenizer_matches_jax():
    vocab_file = os.path.join(CKPT["asr"], "vocab.txt")
    for kw in ({}, {"vocab_file": vocab_file}):
        ours, theirs = CharTokenizer(**kw), JaxCharTokenizer(**kw)
        assert ours.vocab == theirs.vocab
        assert (ours.blank_id, ours.sos_id, ours.eos_id, ours.unk_id) == (0, 1, 2, 3)
        text = "天地 人éx<"
        assert ours.encode(text) == theirs.encode(text)
        ids = [1, 5, 0, 3, 2, 40, 99999, -1, 3000]
        assert ours.decode(ids) == theirs.decode(ids)


def test_fbank_lfr_cmvn_match_jax(rng):
    audio = (0.3 * rng.standard_normal((2, 2 * SR + 123))).astype(np.float32)
    audio[1, SR:] = 0.0  # silence reaches the log floor
    audio = jax_quantize_i16(audio).astype(np.float32) / 32768.0
    want = np.asarray(_jax_highest(jfeat.fbank, jnp.asarray(audio)))
    got = tfeat.fbank(torch.from_numpy(audio))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape[1] == tfeat.num_frames(audio.shape[1]) == jfeat.num_frames(audio.shape[1])
    assert _rel(got.numpy(), want) <= 1e-4
    lfr_want = np.array(jfeat.lfr(jnp.asarray(want), 7, 6))
    lfr_got = tfeat.lfr(torch.from_numpy(want.copy()), 7, 6).numpy()
    np.testing.assert_array_equal(lfr_got, lfr_want)
    mean, istd = (rng.standard_normal(560).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tfeat.apply_cmvn(torch.from_numpy(lfr_want), torch.from_numpy(mean),
                         torch.from_numpy(istd)).numpy(),
        np.asarray(jfeat.apply_cmvn(jnp.asarray(lfr_want), mean, istd)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frames", [1, 6, 7, 13, 24])
def test_lfr_edge_replication_matches_jax(frames, rng):
    x = rng.standard_normal((2, frames, 3)).astype(np.float32)
    np.testing.assert_array_equal(tfeat.lfr(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfeat.lfr(jnp.asarray(x))))


def test_quantize_i16_matches_jax(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 1000), [1.0, -1.0, 0.5 / 32768]]).astype(
        np.float32)
    np.testing.assert_array_equal(quantize_i16(x), jax_quantize_i16(x))
    np.testing.assert_array_equal(quantize_i16(np.arange(5)), jax_quantize_i16(np.arange(5)))


# ---------------- VAD ----------------


@pytest.fixture(scope="module")
def vad_pair():
    return VADEngine.from_pretrained(CKPT["vad"], device="cpu"), \
        JaxVADEngine.from_pretrained(CKPT["vad"])


def test_vad_model_matches_jax(vad_pair, speech):
    """The FSMN-VAD on the same fbank features: speech probabilities within
    1e-4. (Each package's own fbank differs at float32 resolution in
    low-energy bins, see test_fbank_float32_error_is_shared.)"""
    ours, theirs = vad_pair
    clip = speech["clip"]
    n = jfeat.num_frames(len(clip))
    audio = jax_quantize_i16(np.pad(clip, (0, 8 * SR - len(clip))))[None] / 32768.0
    with jax.default_matmul_precision("highest"):
        feats = jfeat.fbank(jnp.asarray(audio, jnp.float32))
        logits = theirs.model.apply(theirs.params, feats, jnp.asarray([n]))
        want = np.asarray(jax.nn.softmax(logits, axis=-1)[0, :n, 1])
    with torch.inference_mode():
        got = torch.softmax(ours.model(torch.from_numpy(np.array(feats)), torch.tensor([n])),
                            dim=-1)[0, :n, 1].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_vad_engine_segments_match_jax(vad_pair, speech):
    ours, theirs = vad_pair
    clip = speech["clip"]
    got = ours.frame_probs(clip)
    assert got.shape == _jax_highest(theirs.frame_probs, clip).shape == \
        (tfeat.num_frames(len(clip)),)
    segs, jsegs = ours.vad_detection(clip), _jax_highest(theirs.vad_detection, clip)
    assert len(segs) == len(jsegs) >= 2
    np.testing.assert_allclose(np.asarray(segs), np.asarray(jsegs), rtol=0, atol=0.01)


def test_fbank_float32_error_is_shared(speech):
    """Both packages' float32 fbanks sit within 5e-3 of a float64 fbank; they
    differ from each other by the same order, in low-energy bins of
    int16-scale frames, where float32 cannot resolve the power."""
    from targetdiarization_tpu_torch.ops.mel import _povey_window, mel_filterbank

    audio = jax_quantize_i16(speech["clip"]).astype(np.float32) / 32768.0
    x = audio.astype(np.float64) * 32768.0
    frames = np.lib.stride_tricks.sliding_window_view(x, 400)[::160]
    frames = frames - frames.mean(-1, keepdims=True)
    pre = frames - 0.97 * np.concatenate([frames[:, :1], frames[:, :-1]], -1)
    spec = np.fft.rfft(pre * _povey_window(400), n=512)
    mel = (spec.real ** 2 + spec.imag ** 2) @ mel_filterbank(16000, 512, 80, 20.0).T.astype(
        np.float64)
    ref = np.log(np.maximum(mel, 1.1920928955078125e-07))
    ours = tfeat.fbank(torch.from_numpy(audio)).numpy()
    theirs = np.asarray(_jax_highest(jfeat.fbank, jnp.asarray(audio)))
    assert np.abs(ours - ref).max() <= 5e-3 and np.abs(theirs - ref).max() <= 5e-3


def test_vad_windows_above_30s_match_jax(vad_pair, speech):
    """Audio above the top rung (30 s) is windowed there: the same frame
    track length and segments as the JAX package."""
    ours, theirs = vad_pair
    clip = np.concatenate([speech["utts"][0], np.zeros(30 * SR, np.float32), speech["utts"][1]])
    got, want = ours.frame_probs(clip), _jax_highest(theirs.frame_probs, clip)
    assert got.shape == want.shape and len(got) > 3000
    segs, jsegs = ours.vad_detection(clip), _jax_highest(theirs.vad_detection, clip)
    assert len(segs) == len(jsegs) == 2 and segs[1][0] > 30.0
    np.testing.assert_allclose(np.asarray(segs), np.asarray(jsegs), rtol=0, atol=0.01)


def test_vad_batch_matches_single(vad_pair, speech):
    ours, _ = vad_pair
    clips = [speech["utts"][0], speech["clip"]]
    for got, clip in zip(ours.frame_probs_batch(clips), clips):
        np.testing.assert_allclose(got, ours.frame_probs(clip), rtol=0, atol=1e-5)


# ---------------- Paraformer ----------------


@pytest.fixture(scope="module")
def paraformer_run(speech):
    """The JAX Paraformer and the port's on the same features: two
    utterances in one batch at the 4 s rung."""
    model, params = jax_from_pretrained(CKPT["asr"])
    with np.load(os.path.join(CKPT["asr"], "cmvn.npz")) as z:
        mean, istd = z["mean"], z["istd"]
    utts = speech["utts"][:2]
    batch = np.stack([np.pad(u, (0, 4 * SR - len(u))) for u in utts])
    audio = jax_quantize_i16(batch).astype(np.float32) / 32768.0
    with jax.default_matmul_precision("highest"):
        feats = jfeat.apply_cmvn(jfeat.lfr(jfeat.fbank(jnp.asarray(audio)), 7, 6), mean, istd)
        ts = [-(-jfeat.num_frames(len(u)) // 6) for u in utts]
        mask = (jnp.arange(feats.shape[1])[None, :] < jnp.asarray(ts)[:, None]).astype(
            jnp.float32)
        want = jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(params, feats, mask))
    port = from_pretrained(CKPT["asr"])
    with torch.inference_mode():
        got = port(torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(mask)))
    return {k: v.numpy() for k, v in got.items()}, want, ts


def test_paraformer_encoder_matches_jax(paraformer_run):
    got, want, _ = paraformer_run
    assert _rel(got["encoder_out"], want["encoder_out"]) <= 1e-4


def test_paraformer_cif_fires_match_jax(paraformer_run):
    """Fire frames sit on thresholds of a cumulative sum: compared exactly."""
    got, want, ts = paraformer_run
    np.testing.assert_array_equal(got["n_tokens"], want["n_tokens"])
    np.testing.assert_array_equal(got["fire_frames"], want["fire_frames"])
    assert all(n > 0 for n in got["n_tokens"])
    assert _rel(got["alphas"], want["alphas"]) <= 1e-4


def test_paraformer_logits_match_jax(paraformer_run):
    got, want, _ = paraformer_run
    assert got["logits"].shape == want["logits"].shape
    for row, n in enumerate(want["n_tokens"]):
        assert _rel(got["logits"][row, :n], want["logits"][row, :n]) <= 1e-3
        np.testing.assert_array_equal(got["logits"][row, :n].argmax(-1),
                                      want["logits"][row, :n].argmax(-1))


@pytest.mark.parametrize("tail", [0.0, 0.45])
def test_cif_fire_matches_jax(tail, rng):
    hidden = rng.standard_normal((2, 40, 8)).astype(np.float32)
    alphas = rng.uniform(0.0, 0.6, (2, 40)).astype(np.float32)
    alphas[1, 30:] = 0.0
    alphas[:, -1] += tail
    want = jasr.cif_fire(jnp.asarray(hidden), jnp.asarray(alphas))
    got = tasr.cif_fire(torch.from_numpy(hidden), torch.from_numpy(alphas))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[3]))


def test_paraformer_loads_both_key_layouts():
    """The shipped per-layer keys (encoder/block_i, dec_i) and the stacked
    scan layout (encoder/blocks/block, decoder_blocks/block) give one state dict."""
    legacy, meta = load_checkpoint(CKPT["asr"])
    assert "block_0" in legacy["params"]["encoder"] and "dec_0" in legacy["params"]
    stacked = upgrade_scan_layout("Paraformer", load_checkpoint(CKPT["asr"])[0])
    assert "block" in stacked["params"]["encoder"]["blocks"]
    assert "block" in stacked["params"]["decoder_blocks"]
    sd_legacy = paraformer_state_dict(legacy)
    sd_stacked = paraformer_state_dict(jax.tree_util.tree_map(np.asarray, stacked))
    assert sd_legacy.keys() == sd_stacked.keys()
    for k in sd_legacy:
        torch.testing.assert_close(sd_legacy[k], sd_stacked[k], rtol=0, atol=0)
    model = tasr.Paraformer(**meta["model_args"])
    model.load_state_dict(sd_stacked, strict=True)
    assert len(model.encoder.blocks) == 8 and len(model.decoder_blocks) == 4


def test_fire_frames_to_timestamps_matches_jax():
    frames = np.array([0, 3, 3, 7, 12, -1, -1])
    assert tasr.fire_frames_to_timestamps(frames, 13) == \
        jasr.fire_frames_to_timestamps(frames, 13)


# ---------------- punctuation ----------------


def test_punctuation_classes_match_jax():
    ours = PunctuationEngine.from_pretrained(CKPT["punc"], device="cpu")
    theirs = JaxPunctuationEngine.from_pretrained(CKPT["punc"])
    texts = ["一二三四五六七", "天地人", "", "中大小上下左右心口手一二三四五六七八九十天"]
    got = ours.predict_classes_batch(texts)
    want = _jax_highest(theirs.predict_classes_batch, texts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ours.punctuation_restore_batch(texts) == \
        _jax_highest(theirs.punctuation_restore_batch, texts)


# ---------------- the processor end to end ----------------


@pytest.fixture(scope="module")
def processors():
    kw = {f"{k}_model": v for k, v in CKPT.items()}
    return ASRProcessor(**kw, device="cpu"), JaxASRProcessor(**kw)


@pytest.mark.parametrize("no_punc", [True, False])
def test_asr_processor_matches_jax(processors, speech, no_punc):
    """Identical texts (raw and punctuated) and timestamps, one call per
    utterance and one batch."""
    ours, theirs = processors
    assert len(speech["utts"][2]) > 8 * SR
    for u in speech["utts"]:
        assert ours.asr_detection(u, no_punc=no_punc) == \
            _jax_highest(theirs.asr_detection, u, no_punc=no_punc)
    got = ours.asr_detection_batch(speech["utts"], no_punc=no_punc)
    assert got == _jax_highest(theirs.asr_detection_batch, speech["utts"], no_punc=no_punc)
    assert all(r["text"] for r in got)


def test_asr_detection_windows_above_60s(processors, speech):
    """Audio above the top rung (60 s) is windowed there: texts joined and
    each window's timestamps offset by its start."""
    ours, _ = processors
    first, second = speech["utts"][0], speech["utts"][1]
    clip = np.concatenate([first, np.zeros(60 * SR - len(first), np.float32), second])
    got = ours.asr.asr_detection(clip)[0]
    a, b = ours.asr.asr_detection(clip[:60 * SR])[0], ours.asr.asr_detection(second)[0]
    assert b["text"] and got["text"] == a["text"] + b["text"]
    assert got["timestamp"] == a["timestamp"] + [[s + 60000, e + 60000]
                                                 for s, e in b["timestamp"]]


def test_asr_processor_vad_and_split_match_jax(processors, speech):
    ours, theirs = processors
    clip = speech["clip"]
    segs = ours.vad_detection(clip, max_end_silence_time=0.3)
    want = _jax_highest(theirs.vad_detection, clip, max_end_silence_time=0.3)
    np.testing.assert_allclose(np.asarray(segs), np.asarray(want), rtol=0, atol=0.01)
    split = ours.asr_vad_split(clip)
    assert [[s, e] for s, e, _ in split] == ours.vad_detection(clip)
    assert all(len(c) == int(e * SR) - int(s * SR) for s, e, c in split)
    assert ours.vad_detection_batch([clip, speech["utts"][0]]) == \
        [ours.vad_detection(clip), ours.vad_detection(speech["utts"][0])]


def test_asr_processor_without_engines_passes_through():
    ap = ASRProcessor(device="cpu")
    assert not (ap.is_vad or ap.is_asr or ap.is_punc)
    x = np.zeros(24000, np.float32)
    assert ap.vad_detection(x) == [[0.0, 1.5]]
    assert ap.vad_detection_batch([x, x[:8000]]) == [[[0.0, 1.5]], [[0.0, 0.5]]]
    assert ap.asr_detection(x) == [{"text": "", "timestamp": []}]
    assert ap.asr_detection_batch([x, x]) == [{"text": "", "timestamp": []}] * 2
    assert ap.punctuation_restore("天地人") == "天地人"
    assert ap.punctuation_restore_batch(["天地", ""]) == ["天地", ""]


def test_unported_asr_engine_raises():
    """Every engine of the JAX processor is ported; a name outside its
    LOCAL_ENGINES and API_ENGINES raises (the JAX processor would load the
    checkpoint it is given whatever the name)."""
    assert ASRProcessor.LOCAL_ENGINES == JaxASRProcessor.LOCAL_ENGINES
    assert ASRProcessor.API_ENGINES == JaxASRProcessor.API_ENGINES
    with pytest.raises(ValueError, match="kaldi"):
        ASRProcessor(asr_engine="kaldi", device="cpu")


def test_chip_smoke_synth_copy_renders_train_synth():
    """chip_smoke.py's numpy copy of train/synth.py gives the same samples."""
    import chip_smoke

    assert chip_smoke.BOOT_CHARS == synth.BOOT_CHARS
    for seed, text in ((0, "一二三"), (5, "手口心右左下上小大中王")):
        got = chip_smoke.synth_utterance(text, np.random.default_rng(seed))
        want = synth.synth_utterance(text, np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert chip_smoke.cer("天地人日", "天人日月") == synth.cer("天地人日", "天人日月")


def test_cif_predictor_bf16_counts_frames_like_jax():
    """In bf16 mode the JAX CIF predictor counts valid frames in the mask's
    type: at T = 303 a full row counts 304 frames, past the last slot, so
    its 0.45 tail mass is dropped (jax.nn.one_hot gives zeros) and the
    last token short of the threshold never fires. The port counts the same
    way: same token counts, fire frames and tokens, one row fully valid and
    one not. Both compute the predictor in float32 from bf16-rounded
    weights, as their bf16 engines do after the position add."""
    from targetdiarization_tpu.runtime.precision import cast_params

    rng = np.random.default_rng(0)
    dim, t = 16, 303
    jmod = jasr.CIFPredictor(dim=dim)
    enc = (rng.standard_normal((2, t, dim)) * 0.5).astype(np.float32)
    mask = np.ones((2, t), np.float32)
    mask[1, 290:] = 0.0
    params = _jax_highest(jax.jit(jmod.init), jax.random.PRNGKey(3), jnp.asarray(enc),
                          jnp.asarray(mask))
    params = cast_params(jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.standard_normal(p.shape), p.dtype), params),
        jnp.bfloat16)
    bf = jnp.bfloat16
    tokens, _, alphas, fire_frames, n_tokens, _ = _jax_highest(
        jax.jit(jmod.apply), params, jnp.asarray(enc), jnp.asarray(mask, bf))
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                               params["params"])
    port = tasr.CIFPredictor(dim)
    port.load_state_dict({"conv.weight": p["conv"]["kernel"].permute(2, 1, 0),
                          "conv.bias": p["conv"]["bias"], "alpha.weight": p["alpha"]["kernel"].T,
                          "alpha.bias": p["alpha"]["bias"]})
    with torch.inference_mode():
        got = port(torch.from_numpy(enc), torch.from_numpy(mask).bfloat16())
    # the data exercises the quirk: the bf16 count passes T, and the
    # dropped tail would have fired one more token on the full row
    assert int(np.asarray(jnp.sum(jnp.asarray(mask[0], bf)))) == 304
    assert np.asarray(alphas)[0].sum() % 1.0 + 0.45 >= 1.0
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(n_tokens))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(fire_frames))
    assert _rel(got[3].numpy(), np.asarray(alphas)) <= 1e-5
    # the tokens weigh frames by float32 cumulative sums over 303 frames,
    # summed in another order by the two frameworks
    assert _rel(got[0].numpy(), np.asarray(tokens)) <= 1e-4


def test_engines_hold_taps_in_the_activation_type():
    """Each engine makes its memory convs' taps once, in the type the conv's
    input has: float32 in the bf16 Paraformer (its stream is promoted after
    in_proj), bf16 in the bf16 VAD."""
    from targetdiarization_tpu_torch.models.asr import ASREngine, SANMAttention
    from targetdiarization_tpu_torch.models.vad import FsmnBlock

    asr = ASREngine.from_pretrained(CKPT["asr"], device="cpu", compute_dtype="bfloat16")
    sanm = [m for m in asr.model.modules() if isinstance(m, SANMAttention) and m.fsmn is not None]
    assert sanm and all(m.fsmn_taps.dtype == torch.float32 for m in sanm)
    assert all(m.fsmn_taps.weight.data_ptr() == m.fsmn.data_ptr() for m in sanm)
    vad = VADEngine.from_pretrained(CKPT["vad"], device="cpu", compute_dtype="bfloat16")
    blocks = [m for m in vad.model.modules() if isinstance(m, FsmnBlock)]
    assert blocks and all(m.memory_taps.dtype == torch.bfloat16 for m in blocks)
