"""Bootstrap training recipes.

Counterpart of targetdiarization_tpu/train/recipes.py. Here are the five
recipes whose models run the port's kernels, and the pieces every recipe
shares; the other nine (`train/recipes_plain.py`: bootstrap_speaker,
_segmentation, _enhancer, _mos, _sigmos, _denoiser, _punc, _emotion,
_whisper) are importable from here too. The five: `bootstrap_vad` (FsmnVADNet, the
dwconv kernel), `bootstrap_separator` (MossFormer2 through
`SeparationTrainer`: FFConvM, gated FLASH, dwconv), `bootstrap_restorer`
(Apollo, dwconv), `bootstrap_asr` (Paraformer, dwconv; its device data
path in `train/synth_device.py`) and `bootstrap_sensevoice` (SenseVoice,
dwconv). They made the shipped `checkpoints/{vad,sep,rest,asr,sv}-
bootstrap`. Each keeps the JAX recipe's signature, defaults, data
streams (numpy generators from `seed`), losses, optimizer (`train/
optim.py`, optax's rules), log lines, metrics dict and checkpoint layout,
so that a checkpoint written by either package loads in the other's
registry, and takes `device` ("cuda" by default: the recipes run on the
card unless the caller asks for the CPU).

The initial parameters are a seeded draw at flax's initializer scales
(`trainer.init_params`), not jax.random's draws. Autograd goes through the
kernels' Functions (`ops/kernels`), and `prepare_kernels` runs after every
optimizer step, since the step changes the weights in place. A recipe runs
with cuDNN's deterministic algorithms (`_reproducible`): with its default
ones, the gradients of the models' convolutions (the Paraformer's CIF
conv, the separator's encoder and decoder) are summed in an order that
varies from run to run on the card, and the same seed gave runs that
parted in the last bits, enough to move a CIF token count
(`tools/recipe_repeat.py`).

The recipes read two fixture recordings, `chat_mix.wav` and
`female_a.wav` (16 kHz), from the directory `ASSETS` names: set it to where
they are (relative paths are the working directory's).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import prepare_kernels
from . import optim, trainer
from .losses import softmax_cross_entropy_with_integer_labels

ASSETS = "assets"


def _load_fixture(name: str) -> np.ndarray:
    from ..utils.audio_io import read_audio

    audio, sr = read_audio(os.path.join(ASSETS, name))
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    assert sr == 16000
    return audio.astype(np.float32)


def _frame_labels(audio: np.ndarray, sr: int = 16000,
                  thresh_db: float = -45.0) -> np.ndarray:
    """Per-10ms-frame speech labels from energy (for clean speech audio)."""
    from ..models import features

    n = features.num_frames(len(audio), sr)
    frame, hop = 400, 160
    labels = np.zeros(n, np.float32)
    for i in range(n):
        w = audio[i * hop: i * hop + frame]
        rms = np.sqrt(np.mean(w**2) + 1e-12)
        labels[i] = 1.0 if 20 * np.log10(rms + 1e-12) > thresh_db else 0.0
    return labels


# ---------------- the training loop's pieces ----------------


def _reproducible(recipe):
    """`recipe` run with torch.backends.cudnn.deterministic set, restored
    after: the same seed gives the same run on the card."""
    @functools.wraps(recipe)
    def run(*args, **kwargs):
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return recipe(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = was
    return run


def _place(model: torch.nn.Module, seed: int, device) -> list:
    """`model` with its seeded initial parameters, in float32 on `device`,
    its kernels' operands made; its parameters as a list."""
    model.load_state_dict(trainer.init_params(model, seed), strict=True)
    model.to(device=torch.device(device), dtype=torch.float32).eval()  # no dropout
    prepare_kernels(model)
    return list(model.parameters())


def _value_and_grad(loss_fn, params: list):
    """jax.value_and_grad of `loss_fn()` (a loss, or a (loss, aux) tuple)
    for `params`: the detached output and one gradient a parameter (zeros
    for a parameter the loss leaves out)."""
    out = loss_fn()
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    detached = tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()
    return detached, grads


def _apply(opt, opt_state, params: list, grads: list, model) -> object:
    """One optimizer update applied in place; the kernels' operands made
    again from the new weights. Returns the optimizer state."""
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
    prepare_kernels(model)
    return opt_state


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=torch.device(device))


@_reproducible
def bootstrap_vad(steps: int = 300, batch: int = 16, seconds: float = 2.0,
                  checkpoint_dir: str = "checkpoints/vad-bootstrap",
                  seed: int = 0, log_fn=print, device="cuda") -> dict:
    """Train FsmnVADNet speech/noise discrimination from fixtures."""
    from ..models import features
    from ..models.vad import FsmnVADNet, VADEngine
    from ..runtime.registry import save_checkpoint

    rng = np.random.default_rng(seed)
    speech = [_load_fixture("chat_mix.wav"), _load_fixture("female_a.wav")]
    n = int(seconds * 16000)
    t_frames = features.num_frames(n)

    def make_noise(kind: int) -> np.ndarray:
        w = rng.standard_normal(n).astype(np.float32)
        if kind == 0:  # white
            out = w * 10 ** (rng.uniform(-3, -1))
        elif kind == 1:  # pink-ish
            spec = np.fft.rfft(w)
            out = np.fft.irfft(
                spec / np.sqrt(np.maximum(np.arange(len(spec)), 1.0)), n=n
            ).astype(np.float32)
            out *= 10 ** (rng.uniform(-2, -0.5)) / (np.abs(out).max() + 1e-9)
        else:  # near-silence
            out = w * 1e-4
        return out

    def sample_batch():
        xs, ys = [], []
        for _ in range(batch):
            if rng.random() < 0.5:  # speech (possibly with noise added)
                src = speech[int(rng.integers(len(speech)))]
                start = int(rng.integers(0, max(len(src) - n, 1)))
                crop = src[start: start + n]
                crop = np.pad(crop, (0, n - len(crop)))
                lab = _frame_labels(crop)
                if rng.random() < 0.3:  # noisy speech stays speech
                    crop = crop + make_noise(int(rng.integers(2))) * 0.3
                xs.append(crop)
                ys.append(lab)
            else:  # pure noise / silence → label 0
                xs.append(make_noise(int(rng.integers(3))))
                ys.append(np.zeros(t_frames, np.float32))
        return np.stack(xs), np.stack(ys)

    model = FsmnVADNet()
    params = _place(model, seed, device)
    opt = optim.adam(1e-3)
    opt_state = opt.init(params)
    lengths = torch.full((batch,), t_frames, device=torch.device(device))

    for i in range(steps):
        audio, labels = sample_batch()
        audio, labels = _t(audio, device), _t(labels, device)

        def loss_fn():
            logits = model(features.fbank(audio), lengths)
            logp = torch.log_softmax(logits, dim=-1)
            ll = labels * logp[..., 1] + (1 - labels) * logp[..., 0]
            return -ll.mean()

        loss, grads = _value_and_grad(loss_fn, params)
        opt_state = _apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"vad step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "FsmnVADNet", {})

    # quick self-eval: speech detected, noise rejected
    eng = VADEngine(model, device=device)
    speech_probs = eng.frame_probs(speech[1][:n])
    noise_probs = eng.frame_probs(make_noise(0))
    metrics = {
        "final_loss": float(loss),
        "speech_mean_prob": float(speech_probs.mean()),
        "noise_mean_prob": float(noise_probs.mean()),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"vad bootstrap: {metrics}")
    return metrics


@_reproducible
def bootstrap_separator(steps: int = 300, batch: int = 8,
                        seconds: float = 1.0,
                        checkpoint_dir: str = "checkpoints/sep-bootstrap",
                        seed: int = 0, model=None, log_fn=print, device="cuda") -> dict:
    """Train a small MossFormer2 on dynamic fixture mixtures (PIT SI-SDR)."""
    from ..models.separation import MossFormer2
    from .data import DynamicMixDataset, MixConfig
    from .metrics import si_snr_i

    chat = _load_fixture("chat_mix.wav")
    female = _load_fixture("female_a.wav")
    ds = DynamicMixDataset(
        {"a": [female], "b": [chat]},
        MixConfig(segment_seconds=seconds), seed=seed)
    model = model or MossFormer2(
        dim=64, enc_channels=64, num_blocks=4, group_size=64, qk_dim=32,
        fsmn_inner=64)
    tr = trainer.SeparationTrainer(
        model,
        cfg=trainer.TrainConfig(learning_rate=5e-4, save_every=0, n_devices=1),
        example_seconds=seconds, seed=seed, device=device)
    history = tr.fit(ds.batches(batch, steps), log_every=max(steps // 5, 1),
                     log_fn=log_fn)
    tr.export_inference_checkpoint(checkpoint_dir)

    # held-out eval
    eval_ds = DynamicMixDataset(
        {"a": [female], "b": [chat]},
        MixConfig(segment_seconds=seconds), seed=seed + 999)
    mix, srcs = eval_ds.sample()
    with torch.no_grad():
        est = tr.model(_t(mix, device)[None]).cpu().numpy()[0]
    # best-permutation SI-SNRi
    i_a = max(
        si_snr_i(est[0], srcs[0], mix) + si_snr_i(est[1], srcs[1], mix),
        si_snr_i(est[0], srcs[1], mix) + si_snr_i(est[1], srcs[0], mix),
    ) / 2
    metrics = {
        "final_loss": history[-1]["loss"] if history else float("nan"),
        "eval_si_snr_i": float(i_a),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"separator bootstrap: {metrics}")
    return metrics


@_reproducible
def bootstrap_restorer(steps: int = 1500, batch: int = 8, seconds: float = 2.0,
                       checkpoint_dir: str = "checkpoints/rest-bootstrap",
                       seed: int = 0, log_fn=print,
                       feature_dim: int = 96, layer: int = 4, device="cuda") -> dict:
    """Train an Apollo restorer to undo synthetic degradations of the
    fixture voices at 16 kHz. Loss on the spectrum (Apollo return_spec=True):
    real/imag L1 + magnitude L1. Degradations model post-separation damage:
    additive noise, lowpass, clipping, spectral holes, level warble. Reports
    held-out SI-SDR and STOI of the degraded and restored audio."""
    from ..models.restoration import Apollo
    from ..ops.stft import stft
    from ..runtime.registry import save_checkpoint

    rng = np.random.default_rng(seed)
    voices = [_load_fixture("chat_mix.wav"), _load_fixture("female_a.wav")]
    sr = 16000
    n = int(seconds * sr)
    model_args = dict(sr=sr, win_ms=20, feature_dim=feature_dim, layer=layer)
    model = Apollo(**model_args)

    def degrade(clean, gen):
        x = clean.copy()
        kind = gen.integers(4)
        # additive noise (always, mild)
        x = x + gen.standard_normal(n).astype(np.float32) * gen.uniform(0.003, 0.02)
        if kind == 0:  # lowpass
            k = int(gen.integers(2, 7))
            x = np.convolve(x, np.ones(k, np.float32) / k, mode="same")
        elif kind == 1:  # clipping
            c = gen.uniform(0.25, 0.8)
            x = np.clip(x, -c, c)
        elif kind == 2:  # spectral holes (separation-artifact-like)
            spec = np.fft.rfft(x)
            n_holes = int(gen.integers(1, 4))
            for _ in range(n_holes):
                lo = int(gen.integers(0, len(spec) - 200))
                spec[lo: lo + int(gen.integers(50, 200))] *= gen.uniform(0, 0.2)
            x = np.fft.irfft(spec, n=n).astype(np.float32)
        else:  # level warble (gain modulation)
            t = np.arange(n) / sr
            f = gen.uniform(1.0, 6.0)
            x = x * (1.0 + 0.5 * gen.uniform(0.3, 0.9)
                     * np.sin(2 * np.pi * f * t)).astype(np.float32)
        return x.astype(np.float32)

    def sample_batch(gen):
        xs, ys = [], []
        for _ in range(batch):
            src = voices[int(gen.integers(len(voices)))]
            start = int(gen.integers(0, max(len(src) - n, 1)))
            clean = src[start: start + n]
            clean = np.pad(clean, (0, n - len(clean)))
            xs.append(degrade(clean, gen))
            ys.append(clean)
        return np.stack(xs), np.stack(ys)

    params = _place(model, seed, device)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(100, steps // 10 + 1),
        decay_steps=max(steps, 2))
    opt = optim.adamw(sched, weight_decay=1e-5)
    opt_state = opt.init(params)

    for i in range(steps):
        noisy, clean = sample_batch(rng)
        noisy, clean = _t(noisy, device), _t(clean, device)

        def loss_fn():
            est_ri = model(noisy, return_spec=True)  # (B, F, frames, 2)
            ref_spec = stft(clean, model.win, model.stride)
            ref_ri = torch.stack([ref_spec.real, ref_spec.imag], dim=-1)
            ri_l1 = (est_ri - ref_ri).abs().mean()
            est_mag = torch.sqrt(est_ri.square().sum(dim=-1) + 1e-9)
            ref_mag = torch.sqrt(ref_ri.square().sum(dim=-1) + 1e-9)
            return ri_l1 + (est_mag - ref_mag).abs().mean()

        loss, grads = _value_and_grad(loss_fn, params)
        opt_state = _apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 10, 1) == 0:
            log_fn(f"rest step {i + 1}/{steps}: loss={float(loss):.3f}")

    save_checkpoint(checkpoint_dir, model, "Apollo", model_args)

    # held-out eval (fresh degradation stream): SI-SDR + STOI movement
    from .metrics import si_snr as _si_snr
    from .perceptual import stoi as _stoi

    gen = np.random.default_rng(seed + 999)
    deltas, noisy_sdr, rest_sdr, stoi_n, stoi_r = [], [], [], [], []
    for _ in range(8):
        src = voices[int(gen.integers(len(voices)))]
        start = int(gen.integers(0, max(len(src) - n, 1)))
        clean = np.pad(src[start: start + n],
                       (0, max(0, n - len(src[start: start + n]))))
        noisy = degrade(clean, gen)
        with torch.no_grad():
            est = model(_t(noisy, device)[None]).cpu().numpy()[0]
        noisy_sdr.append(_si_snr(noisy, clean))
        rest_sdr.append(_si_snr(est, clean))
        deltas.append(rest_sdr[-1] - noisy_sdr[-1])
        stoi_n.append(_stoi(clean, noisy))
        stoi_r.append(_stoi(clean, est))
    metrics = {
        "final_loss": float(loss),
        "noisy_si_sdr": round(float(np.mean(noisy_sdr)), 2),
        "restored_si_sdr": round(float(np.mean(rest_sdr)), 2),
        "si_sdr_delta": round(float(np.mean(deltas)), 2),
        "noisy_stoi": round(float(np.mean(stoi_n)), 3),
        "restored_stoi": round(float(np.mean(stoi_r)), 3),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"restorer bootstrap: {metrics}")
    return metrics


# ---------------- the ASR recipes ----------------


def _cmvn(batches, feat_fn) -> tuple[np.ndarray, np.ndarray]:
    """Corpus CMVN over LFR features in FunASR's convention (negative means,
    inverse standard deviations), accumulated in float64."""
    s1 = s2 = 0.0
    cnt = 0
    for audios in batches:
        f = feat_fn(audios).cpu().numpy().astype(np.float64)
        s1 = s1 + f.sum(axis=(0, 1))
        s2 = s2 + (f ** 2).sum(axis=(0, 1))
        cnt += f.shape[0] * f.shape[1]
    mu = s1 / cnt
    sd = np.sqrt(np.maximum(s2 / cnt - mu ** 2, 1e-8))
    return (-mu).astype(np.float32), (1.0 / sd).astype(np.float32)


def _synth_seed(key: tuple) -> int:
    """A torch.Generator seed for a PRNG key path: (base,) is the JAX
    recipe's PRNGKey(base), (base, i) its fold_in(PRNGKey(base), i)."""
    base, *fold = key
    return (int(base) * 1_000_003 + (int(fold[0]) + 1 if fold else 0)) % (2 ** 63)


def _synth_draws(key: tuple, b: int, c: int, n: int, device) -> tuple[dict, dict]:
    """One synthesized batch's draws (render_batch's, then add_noise's) for
    the key path `key` (`_synth_seed`), on `device`."""
    from .synth_device import draw_noise, draw_render

    gen = torch.Generator(device=torch.device(device)).manual_seed(_synth_seed(key))
    return draw_render(gen, b, c), draw_noise(gen, b, n)


def _preprocess_one(den_eng, a: torch.Tensor, nv: torch.Tensor, n: int) -> torch.Tensor:
    """The fused pipeline's preprocess chain on one (n,)-sample buffer with
    nv valid samples (pipeline/fused.py's FusedFrontend): BS.1770
    loudness, MDX denoise, loudness again, an int16 round trip."""
    from ..models.denoise import denoise_chain_16k
    from ..pipeline.fused import _masked_loudness_normalize

    a = _masked_loudness_normalize(a, 16000, nv)
    valid = (torch.arange(n, device=a.device) < nv).float()
    a = denoise_chain_16k(den_eng, a, n) * valid
    a = _masked_loudness_normalize(a, 16000, nv)
    q = torch.clamp(torch.round(a * 32768.0), -32768, 32767)
    return q / 32768.0


@_reproducible
def bootstrap_asr(steps: int = 2000, batch: int = 16, seconds: float = 4.0,
                  checkpoint_dir: str = "checkpoints/asr-bootstrap",
                  seed: int = 0, log_fn=print, eval_utts: int = 50,
                  dim: int = 128, enc_layers: int = 4, dec_layers: int = 2,
                  ffn: int = 512, device_synth: bool = False,
                  aug_frac: float = 0.0,
                  denoiser_dir: str = "checkpoints/den-bootstrap", device="cuda") -> dict:
    """Train a small Paraformer on the procedural synthetic language
    (train/synth.py). Loss = token CE (CIF with target_len scaling) +
    0.5 x the quantity loss |sum(alphas_raw) - n_chars|, and, on the device
    data path, + 0.3 x the CIF alignment loss (the raw alphas' running sum
    crossing k + 1 at character k's end). Ships vocab.txt and corpus CMVN
    (cmvn.npz) beside the parameters; reports held-out CER (clean, and
    through the preprocess chain where a denoiser is loaded) and the
    character timestamps' MAE.

    `device_synth=True` renders every batch on the device inside the step
    (train/synth_device.py), true-length masks; `aug_frac` of each batch
    then goes through the pipeline's preprocess chain, one row at a time
    (`_preprocess_one`). Otherwise batches come from a host `UnitPool`."""
    from ..models import features
    from ..models.asr import LFR_M, LFR_N, ASREngine, Paraformer
    from ..models.tokenizer import CharTokenizer
    from ..runtime.registry import save_checkpoint
    from .synth import BOOT_CHARS, UnitPool, cer, random_text, synth_utterance

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    tok = CharTokenizer()
    n = int(seconds * 16000)
    max_chars = 10

    # ---- device-synthesis path: fresh data every step ----
    den_eng = None
    n_aug = 0
    if device_synth:
        from ..models.denoise import DenoiseEngine
        from .synth_device import add_noise_from_draws, render_from_draws

        n_aug = int(round(batch * aug_frac))
        if (n_aug > 0 or aug_frac == 0.0) and os.path.isdir(denoiser_dir):
            den_eng = DenoiseEngine.from_pretrained(denoiser_dir, device=dev)
        if den_eng is None:
            n_aug = 0
        boot2tok = np.asarray(tok.encode(BOOT_CHARS), np.int32)  # (32,)

        def sample_ids(gen):
            boot_idx = np.zeros((batch, max_chars), np.int32)
            n_chars = np.zeros(batch, np.int32)
            for b in range(batch):
                text = random_text(gen, 2, max_chars)
                for i, ch in enumerate(text):
                    boot_idx[b, i] = BOOT_CHARS.index(ch)
                n_chars[b] = len(text)
            return boot_idx, boot2tok[boot_idx], n_chars

        def synth(key, boot_idx, n_chars):
            """A batch rendered, noised and (its first n_aug rows)
            preprocessed on the device, its LFR frame counts and its
            characters' end times."""
            with torch.no_grad():
                r_draws, n_draws = _synth_draws(key, batch, max_chars, n, dev)
                r = render_from_draws(r_draws, boot_idx, n_chars, n)
                audio = add_noise_from_draws(n_draws, r["audio"], r["n_valid"])
                if n_aug > 0:
                    aug = torch.stack([_preprocess_one(den_eng, audio[b], r["n_valid"][b], n)
                                       for b in range(n_aug)])
                    audio = torch.cat([aug, audio[n_aug:]], dim=0)
                nv = r["n_valid"]
                nf = torch.where(nv < 400, 0, 1 + (nv - 400) // 160)
                n_lfr = torch.clamp_min(-(-nf // LFR_N), 1)
            return audio, n_lfr, r["ends"]

    pool = None
    if not device_synth:
        pool = UnitPool(variants=96, seed=seed + 77)

    def sample_batch(gen):
        audios = np.zeros((batch, n), np.float32)
        ids = np.zeros((batch, max_chars), np.int32)
        n_chars = np.zeros(batch, np.int32)
        n_lfr = np.ones(batch, np.int32)
        for b in range(batch):
            text = random_text(gen, 2, max_chars)
            snr = float(gen.uniform(12, 35)) if gen.random() < 0.5 else None
            audio, _ = pool.utterance(text, gen, noise_snr_db=snr)
            audios[b, : min(len(audio), n)] = audio[:n]
            # the true LFR frame count: inference's padded-bucket mask
            n_lfr[b] = max(
                -(-features.num_frames(min(len(audio), n)) // LFR_N), 1)
            enc = tok.encode(text)
            ids[b, : len(enc)] = enc
            n_chars[b] = len(enc)
        return audios, ids, n_chars, n_lfr

    # corpus CMVN over LFR features (FunASR am.mvn slot)
    def feat_fn(a):
        with torch.no_grad():
            return features.lfr(features.fbank(a), LFR_M, LFR_N)

    def cmvn_batches():
        for ci in range(4):
            if device_synth:
                bi, _, nc = sample_ids(rng)
                yield synth((seed * 7919 + ci,), _t(bi, dev), _t(nc, dev))[0]
            else:
                yield _t(sample_batch(rng)[0], dev)

    cmvn_mean, cmvn_istd = _cmvn(cmvn_batches(), feat_fn)

    model = Paraformer(vocab_size=len(tok), dim=dim, heads=4, ffn=ffn,
                       enc_layers=enc_layers, dec_layers=dec_layers)
    params = _place(model, seed, dev)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(100, steps // 10 + 1),
        decay_steps=max(steps, 2))
    # global-norm clipping; apply_if_finite skips the update of a batch
    # whose gradient is not finite instead of writing NaN into the weights
    opt = optim.apply_if_finite(
        optim.chain(optim.clip_by_global_norm(1.0),
                    optim.adamw(sched, weight_decay=1e-4)),
        max_consecutive_errors=25)
    opt_state = opt.init(params)
    mean_t, istd_t = _t(cmvn_mean, dev), _t(cmvn_istd, dev)

    def step(audio, ids, n_chars, n_lfr, char_ends=None):
        def loss_fn():
            feats = features.lfr(features.fbank(audio), LFR_M, LFR_N)
            feats = features.apply_cmvn(feats, mean_t, istd_t)
            t = feats.shape[1]
            mask = (torch.arange(t, device=dev)[None, :] < n_lfr[:, None]).float()
            out = model(feats, mask, n_chars.float())
            logp = torch.log_softmax(out["logits"], dim=-1)  # (B, U, V)
            u = logp.shape[1]
            pos_mask = (torch.arange(u, device=dev)[None, :] < n_chars[:, None]).float()
            tgt = F.pad(ids.long(), (0, u - ids.shape[1]))
            ce = -torch.gather(logp, 2, tgt[..., None])[..., 0]
            ce = (ce * pos_mask).sum() / torch.clamp_min(pos_mask.sum(), 1.0)
            # the quantity loss on the alphas before target_len scaling
            # (the scaled ones sum to n_chars exactly)
            qty = (out["alphas_raw"].sum(dim=1) - n_chars.float()).abs().mean()
            loss = ce + 0.5 * qty
            if char_ends is not None:
                # CIF alignment: the raw alphas' running sum crosses k + 1
                # at character k's true end
                csum = torch.cumsum(out["alphas_raw"], dim=1)  # (B, T)
                end_f = (char_ends * 16000.0 - 400.0) / 160.0 / LFR_N
                idx = torch.clamp(end_f.to(torch.int32), 0, t - 1).long()
                got = torch.gather(csum, 1, idx)
                c = char_ends.shape[1]
                want = torch.arange(1, c + 1, dtype=torch.float32, device=dev)[None, :]
                cmask = (torch.arange(c, device=dev)[None, :] < n_chars[:, None]).float()
                align = ((got - want).square() * cmask).sum() / torch.clamp_min(cmask.sum(), 1.0)
                loss = loss + 0.3 * align
            return loss, ce, qty

        (loss, ce, qty), grads = _value_and_grad(loss_fn, params)
        diag = (bool(torch.isfinite(audio).all()), optim.global_norm(grads))
        return loss, ce, qty, diag, grads

    def _save_asr_ckpt():
        save_checkpoint(checkpoint_dir, model, "Paraformer",
                        dict(vocab_size=len(tok), dim=dim, heads=4, ffn=ffn,
                             enc_layers=enc_layers, dec_layers=dec_layers))
        tok.save(os.path.join(checkpoint_dir, "vocab.txt"))
        np.savez(os.path.join(checkpoint_dir, "cmvn.npz"),
                 mean=cmvn_mean, istd=cmvn_istd)

    base_key = seed + 31337
    nan_debug = os.environ.get("TD_ASR_NAN_DEBUG", "") == "1"
    for i in range(steps):
        if device_synth:
            bi, ids, n_chars = sample_ids(rng)
            bi, ids, n_chars = _t(bi, dev), _t(ids, dev), _t(n_chars, dev)
            audio, n_lfr, ends = synth((base_key, i), bi, n_chars)
            loss, ce_v, qty_v, diag, grads = step(audio, ids, n_chars, n_lfr, ends)
        else:
            audios, ids, n_chars, n_lfr = sample_batch(rng)
            loss, ce_v, qty_v, diag, grads = step(
                _t(audios, dev), _t(ids, dev), _t(n_chars, dev), _t(n_lfr, dev))
        opt_state = _apply(opt, opt_state, params, grads, model)
        if nan_debug and not np.isfinite(float(loss)):
            # TD_ASR_NAN_DEBUG=1: stop at the first non-finite step and say
            # whether the data or the gradient went bad
            raise FloatingPointError(
                f"nan_debug: step {i}: loss={float(loss)} "
                f"ce={float(ce_v)} qty={float(qty_v)} "
                f"audio_finite={diag[0]} grad_norm={float(diag[1])}")
        if (i + 1) % max(min(steps // 10, 500), 1) == 0:
            loss_v = float(loss)
            skipped = int(opt_state["total_notfinite"])
            log_fn(f"asr step {i + 1}/{steps}: loss={loss_v:.4f} "
                   f"ce={float(ce_v):.4f} qty={float(qty_v):.4f}"
                   + (f" skipped={skipped}" if skipped else ""))
            if not np.isfinite(loss_v):
                # a lone non-finite batch only skips its update: fatal only
                # once the weights themselves are broken
                if not all(bool(torch.isfinite(p).all()) for p in params):
                    raise FloatingPointError(
                        f"asr params diverged to NaN by step {i + 1} "
                        f"(total skipped updates: {skipped})")
                log_fn(f"  non-finite batch at step {i + 1} skipped "
                       f"(params still finite)")
        if (i + 1) % 2500 == 0 and (i + 1) < steps:
            # periodic save: a long run stays recoverable
            _save_asr_ckpt()

    _save_asr_ckpt()

    # held-out eval: CER + char-timestamp MAE (inference-time CIF, no
    # target_len oracle)
    eng = ASREngine(model, tokenizer=tok, cmvn=(cmvn_mean, cmvn_istd), device=dev)
    gen = np.random.default_rng(seed + 1)
    cers, cers_pre, ts_err = [], [], []
    for _ in range(eval_utts):
        text = random_text(gen, 2, max_chars)
        audio, ranges = synth_utterance(text, gen)
        res = eng.asr_detection(audio)[0]
        cers.append(cer(text, res["text"]))
        if den_eng is not None:
            # held-out CER through the pipeline's preprocess chain
            nv = min(len(audio), n)
            buf = np.zeros(n, np.float32)
            buf[:nv] = audio[:nv]
            with torch.no_grad():
                pa = _preprocess_one(den_eng, _t(buf, dev), _t(nv, dev), n)
            cers_pre.append(cer(text, eng.asr_detection(pa.cpu().numpy()[:nv])[0]["text"]))
        if res["text"] == text and len(res["timestamp"]) == len(ranges):
            for (ps, pe), (ts, te) in zip(res["timestamp"], ranges):
                pred_mid = (ps + pe) / 2.0
                true_mid = (ts + te) / 2.0 * 1000.0
                ts_err.append(abs(pred_mid - true_mid))
    metrics = {
        "final_loss": float(loss),
        "eval_cer": float(np.mean(cers)),
        "eval_cer_preprocessed": float(np.mean(cers_pre)) if cers_pre else None,
        "eval_exact": float(np.mean([c == 0.0 for c in cers])),
        "timestamp_mae_ms": float(np.mean(ts_err)) if ts_err else None,
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"asr bootstrap: {metrics}")
    return metrics


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """optax.ctc_loss's conventions on F.ctc_loss: logits (B, T, V) (log-
    softmaxed here), paddings 1.0 where padded, labels (B, S); the negative
    log-likelihood of each sequence (B,)."""
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    in_len = (1.0 - logit_paddings).sum(dim=1).round().long()
    lab_len = (1.0 - label_paddings).sum(dim=1).round().long()
    return F.ctc_loss(logp, labels.long(), in_len, lab_len, blank=blank_id,
                      reduction="none", zero_infinity=False)


def _ce_class0(logits: torch.Tensor) -> torch.Tensor:
    """The integer-label cross-entropy against class 0, mean."""
    zeros = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    return softmax_cross_entropy_with_integer_labels(logits, zeros).mean()


@_reproducible
def bootstrap_sensevoice(steps: int = 3000, batch: int = 16,
                         seconds: float = 4.0,
                         checkpoint_dir: str = "checkpoints/sv-bootstrap",
                         seed: int = 0, log_fn=print,
                         eval_utts: int = 50,
                         dim: int = 192, enc_layers: int = 6,
                         ffn: int = 768, device="cuda") -> dict:
    """Train the SenseVoice engine (encoder-only CTC + rich-tag heads) on the
    synthetic language: CTC over the char vocabulary plus 0.1 x the
    cross-entropies of the language, emotion and event heads against fixed
    zh / NEUTRAL / Speech. Ships vocab + corpus CMVN like bootstrap_asr;
    reports held-out CER through the engine's greedy CTC decode."""
    from ..models import features
    from ..models.asr import LFR_M, LFR_N, ASREngine, SenseVoice
    from ..models.tokenizer import CharTokenizer
    from ..runtime.registry import save_checkpoint
    from .synth import UnitPool, cer, random_text, synth_utterance

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    tok = CharTokenizer()
    n = int(seconds * 16000)
    t_lfr = -(-features.num_frames(n) // LFR_N)
    max_chars = 10
    pool = UnitPool(variants=96, seed=seed + 77)

    def sample_batch(gen):
        audios = np.zeros((batch, n), np.float32)
        ids = np.full((batch, max_chars), tok.blank_id, np.int32)
        n_chars = np.zeros(batch, np.int32)
        n_lfr = np.ones(batch, np.int32)
        for b in range(batch):
            text = random_text(gen, 2, max_chars)
            snr = float(gen.uniform(12, 35)) if gen.random() < 0.5 else None
            audio, _ = pool.utterance(text, gen, noise_snr_db=snr)
            audios[b, : min(len(audio), n)] = audio[:n]
            n_lfr[b] = max(
                -(-features.num_frames(min(len(audio), n)) // LFR_N), 1)
            enc = tok.encode(text)
            ids[b, : len(enc)] = enc
            n_chars[b] = len(enc)
        return audios, ids, n_chars, n_lfr

    # corpus CMVN (as bootstrap_asr)
    def feat_fn(a):
        with torch.no_grad():
            return features.lfr(features.fbank(a), LFR_M, LFR_N)

    cmvn_mean, cmvn_istd = _cmvn((_t(sample_batch(rng)[0], dev) for _ in range(4)), feat_fn)

    model = SenseVoice(vocab_size=len(tok), dim=dim, heads=4, ffn=ffn,
                       enc_layers=enc_layers)
    params = _place(model, seed, dev)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(100, steps // 10 + 1),
        decay_steps=max(steps, 2))
    opt = optim.apply_if_finite(
        optim.chain(optim.clip_by_global_norm(1.0),
                    optim.adamw(sched, weight_decay=1e-4)), 50)
    opt_state = opt.init(params)
    cm, ci = _t(cmvn_mean, dev), _t(cmvn_istd, dev)
    frames = torch.arange(t_lfr, device=dev)[None, :]
    slots = torch.arange(max_chars, device=dev)[None, :]

    for i in range(steps):
        audios, ids, n_chars, n_lfr = sample_batch(rng)
        audio, ids, n_chars, n_lfr = (_t(a, dev) for a in (audios, ids, n_chars, n_lfr))

        def loss_fn():
            feats = features.lfr(features.fbank(audio), LFR_M, LFR_N)
            feats = (feats + cm) * ci
            mask = (frames < n_lfr[:, None]).float()
            out = model(feats, mask)
            label_pad = (slots >= n_chars[:, None]).float()
            ctc = ctc_loss(out["ctc_logits"], 1.0 - mask, ids, label_pad,
                           blank_id=tok.blank_id).mean()
            tag = (_ce_class0(out["lang_logits"]) + _ce_class0(out["emotion_logits"])
                   + _ce_class0(out["event_logits"]))
            return ctc + 0.1 * tag

        loss, grads = _value_and_grad(loss_fn, params)
        opt_state = _apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 10, 1) == 0:
            log_fn(f"sv step {i + 1}/{steps}: loss={float(loss):.3f}")

    os.makedirs(checkpoint_dir, exist_ok=True)
    save_checkpoint(checkpoint_dir, model, "SenseVoice",
                    {"vocab_size": len(tok), "dim": dim, "heads": 4,
                     "ffn": ffn, "enc_layers": enc_layers})
    tok.save(os.path.join(checkpoint_dir, "vocab.txt"))
    np.savez(os.path.join(checkpoint_dir, "cmvn.npz"),
             mean=cmvn_mean, istd=cmvn_istd)

    eng = ASREngine(model, tokenizer=tok, cmvn=(cmvn_mean, cmvn_istd), device=dev)
    gen = np.random.default_rng(seed + 1)
    cers = []
    for _ in range(eval_utts):
        text = random_text(gen, 2, max_chars)
        audio, _ = synth_utterance(text, gen)
        res = eng.asr_detection(audio)[0]
        cers.append(cer(text, res["text"]))
    metrics = {
        "final_loss": float(loss),
        "eval_cer": round(float(np.mean(cers)), 4),
        "eval_exact": round(float(np.mean([c == 0 for c in cers])), 3),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"sensevoice bootstrap: {metrics}")
    return metrics


# the recipes whose models run no kernel: `recipes_plain` reads this
# module's pieces at import, so its names are fetched on first use here
# (either module may be imported first)
_PLAIN = ("_pseudo_speakers", "bootstrap_denoiser", "bootstrap_emotion", "bootstrap_enhancer",
          "bootstrap_mos", "bootstrap_punc", "bootstrap_segmentation", "bootstrap_sigmos",
          "bootstrap_speaker", "bootstrap_whisper")


def __getattr__(name: str):
    if name in _PLAIN:
        from . import recipes_plain

        return getattr(recipes_plain, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
