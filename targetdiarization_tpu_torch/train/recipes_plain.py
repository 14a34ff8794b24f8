"""Bootstrap training recipes whose models run no kernel.

The other nine recipes of targetdiarization_tpu/train/recipes.py:
`bootstrap_speaker` (ERes2NetV2 or CAM++ on pitch-shifted pseudo-speakers),
`bootstrap_segmentation` (SegmentationNet, PIT over slot permutations),
`bootstrap_enhancer` (FlowEnhancer by conditional flow matching),
`bootstrap_mos` and `bootstrap_sigmos` (the MOS estimators of
`train/mos.py`), `bootstrap_denoiser` (TDFUNet at 44.1 kHz),
`bootstrap_punc` (CTTransformerPunc on rule-punctuated text),
`bootstrap_emotion` (EmotionNet on prosody-transformed speech) and
`bootstrap_whisper` (WhisperStyleASR on the synthetic language, with its
finite corpus, host and device data paths). They made the shipped
`checkpoints/{spk,campp,seg,enh,mos,sigmos,den,punc,emo,whisper}-bootstrap`.

They share `train/recipes.py`'s pieces and rules, read through that module
at call time (`recipes.ASSETS`, `_place`, `_value_and_grad`, `_apply`,
`_synth_draws`), and each is importable from it: the JAX signatures,
defaults, numpy data streams from `seed`, losses, optimizers, log lines,
metrics and checkpoint layouts, plus `device` ("cuda" by default), under
cuDNN's deterministic algorithms. Where the JAX recipe draws inside its
jitted step (the enhancer's flow times and prior noise) or draws a leaf
outside `Module.init` (the speaker recipe's class weights), the draws come
from a `torch.Generator` here, through one function each (`_flow_draws`,
`_class_weights`) that a test can hand the JAX draws.
"""

from __future__ import annotations

import os
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F

from . import optim
from . import recipes as R
from .losses import softmax_cross_entropy_with_integer_labels


def _place_from(path: str, device) -> tuple:
    """The model of the checkpoint under `path`, placed as `recipes._place`
    places a fresh one (float32 on `device`, eval mode), and its parameters."""
    from ..runtime.registry import from_pretrained

    model = from_pretrained(path).to(device=torch.device(device), dtype=torch.float32)
    return model, list(model.parameters())


# ---------------- speakers ----------------


def _two_voices() -> dict:
    """The fixtures' two single-voice pools: the female_a voice (its sample
    and its span 0.031-1.702 s of chat_mix) and chat_mix's other voice (its
    span 5.077-8.620 s)."""
    chat = R._load_fixture("chat_mix.wav")
    return {
        "female": np.concatenate(
            [R._load_fixture("female_a.wav"), chat[int(0.031 * 16000):int(1.702 * 16000)]]),
        "chatb": chat[int(5.077 * 16000):int(8.620 * 16000)],
    }


def _pseudo_speakers(n_shift: int = 2) -> dict:
    """Pseudo-speaker pools from `_two_voices`, each (voice, pitch shift)
    pair one class: each voice shifted by 0, +-2, ..., +-2 n_shift
    semitones."""
    from ..processors.audio import AudioProcessor

    ap = AudioProcessor(device="cpu")  # the pitch shift is host numpy
    pools: dict = {}
    shifts = [0] + [s for k in range(1, n_shift + 1) for s in (2 * k, -2 * k)]
    for name, audio in _two_voices().items():
        for s in shifts:
            pools[f"{name}_{s:+d}"] = (
                audio if s == 0
                else ap.audio_pitch_shift(audio, 16000, float(s)).astype(np.float32))
    return pools


def _class_weights(seed: int, shape: tuple, device) -> torch.Tensor:
    """The class weights' initial draw: 0.1 x a standard normal (the JAX
    recipe's scale) from a torch.Generator seeded by `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    return (0.1 * torch.randn(shape, generator=gen)).to(torch.device(device))


@R._reproducible
def bootstrap_speaker(steps: int = 400, batch: int = 16, seconds: float = 2.0,
                      checkpoint_dir: str = "checkpoints/spk-bootstrap",
                      model_name: str = "eres2net", seed: int = 0,
                      log_fn=print, device="cuda") -> dict:
    """Train a speaker embedder with additive-margin softmax (m 0.2, s 16)
    over pitch-shifted pseudo-speakers, on variable-length crops with their
    true frame counts.

    As in the JAX recipe, the model runs with its BatchNorms on their running
    statistics (flax's `train=False`), and the step differentiates the whole
    variables dict: the statistics are trained by Adam like the weights. They
    are buffers here, so the recipe hands them to autograd and to the
    optimizer as leaves (torch's `train()` mode is never used)."""
    from ..models import features
    from ..models.speaker import MODEL_PRESETS, SpeakerEngine, cosine_similarity
    from ..runtime.registry import save_checkpoint

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    pools = _pseudo_speakers()
    classes = sorted(pools)
    n = int(seconds * 16000)
    t_frames = features.num_frames(n)

    cls, args = MODEL_PRESETS[model_name]
    model = cls(**args)
    params = R._place(model, seed, dev)
    stats = [b for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    w = _class_weights(seed + 1, (192, len(classes)), dev)
    leaves = params + stats + [w]
    for leaf in stats + [w]:
        leaf.requires_grad_(True)
    opt = optim.adam(1e-3)
    opt_state = opt.init(leaves)
    frames = torch.arange(t_frames, device=dev)[None, :]

    def sample_batch():
        """Crops of 0.6 s to the full window with their true frame counts,
        noise and gain augmentation."""
        xs, ys, ls = [], [], []
        for _ in range(batch):
            c = int(rng.integers(len(classes)))
            src = pools[classes[c]]
            dur = int(rng.uniform(0.6, seconds) * 16000)
            start = int(rng.integers(0, max(len(src) - dur, 1)))
            crop = src[start: start + dur]
            if rng.random() < 0.3:  # noise augmentation
                crop = crop + rng.standard_normal(len(crop)).astype(np.float32) * 0.01
            if rng.random() < 0.3:  # gain variation
                crop = crop * float(rng.uniform(0.3, 1.5))
            ls.append(features.num_frames(len(crop)))
            xs.append(np.pad(crop, (0, max(0, n - len(crop))))[:n])
            ys.append(c)
        return np.stack(xs), np.asarray(ys, np.int32), np.asarray(ls, np.int32)

    for i in range(steps):
        audio, labels, lengths = (R._t(a, dev) for a in sample_batch())

        def loss_fn():
            feats = features.fbank(audio)
            fmask = (frames < lengths[:, None]).float()
            denom = torch.clamp_min(fmask.sum(dim=1, keepdim=True), 1.0)
            mean = (feats * fmask[..., None]).sum(dim=1, keepdim=True) / denom[..., None]
            emb = model((feats - mean) * fmask[..., None], lengths)
            emb = emb / torch.clamp_min(torch.linalg.norm(emb, dim=-1, keepdim=True), 1e-6)
            wn = w / torch.clamp_min(torch.linalg.norm(w, dim=0, keepdim=True), 1e-6)
            cos = emb @ wn  # (B, C)
            margin = F.one_hot(labels.long(), cos.shape[-1]).float() * 0.2
            logits = 16.0 * (cos - margin)
            return softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = R._value_and_grad(loss_fn, leaves)
        opt_state = R._apply(opt, opt_state, leaves, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"spk step {i + 1}/{steps}: loss={float(loss):.4f}")

    for leaf in stats:
        leaf.requires_grad_(False)
    save_checkpoint(checkpoint_dir, model, type(model).__name__, dict(args))

    # eval: same-voice crops more similar than cross-voice crops
    eng = SpeakerEngine(model, device=dev)
    chat, fem = pools["chatb_+0"], pools["female_+0"]
    e = eng.embed_batch([chat[:n], chat[n: 2 * n], fem[:n], fem[n: 2 * n]])
    same = (cosine_similarity(e[0], e[1]) + cosine_similarity(e[2], e[3])) / 2
    cross = (cosine_similarity(e[0], e[2]) + cosine_similarity(e[1], e[3])) / 2
    # short-crop robustness: a 0.64 s tail crop must still land with its own voice
    sh = 10240
    es = eng.embed_batch([chat[-sh:], chat[:n], fem[:n]])
    short_same = cosine_similarity(es[0], es[1])
    short_cross = cosine_similarity(es[0], es[2])
    metrics = {"final_loss": float(loss), "same_voice_cos": round(same, 3),
               "cross_voice_cos": round(cross, 3),
               "short_same_cos": round(short_same, 3),
               "short_cross_cos": round(short_cross, 3),
               "checkpoint": checkpoint_dir}
    log_fn(f"speaker bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_segmentation(steps: int = 300, batch: int = 8, seconds: float = 4.0,
                           checkpoint_dir: str = "checkpoints/seg-bootstrap",
                           seed: int = 0, log_fn=print,
                           boundary_weight: float = 0.0,
                           boundary_frames: int = 3,
                           slot_gain: bool = False,
                           init_from: str | None = None,
                           lr: float = 1e-3, device="cuda") -> dict:
    """Train the SegmentationNet on synthetic multi-slot scenes (crops of the
    fixtures' single-voice spans placed on a timeline with known per-slot
    activity): multilabel BCE, the best of every slot permutation (PIT).
    `boundary_weight` > 0 weighs frames within `boundary_frames` of a slot's
    transition by (1 + w); `slot_gain` scales each crop by U(0.4, 1.0);
    `init_from` fine-tunes a checkpoint at learning rate `lr`."""
    from ..models import features
    from ..models.diarization import SegmentationEngine, SegmentationNet
    from ..runtime.registry import save_checkpoint

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    pools = _two_voices()
    pool_keys = sorted(pools)
    n = int(seconds * 16000)
    t_frames = features.num_frames(n)
    model = SegmentationNet()
    # SAME-padded stride-2 convs: two ceil-divisions, not one floor-by-4
    t_out = -(-(-(-t_frames // 2)) // 2)

    def sample_scene():
        audio = np.zeros(n, np.float32)
        act = np.zeros((t_out, model.max_speakers), np.float32)
        n_spk = int(rng.integers(0, model.max_speakers + 1))
        order = rng.permutation(len(pool_keys))
        for slot in range(n_spk):
            src = pools[pool_keys[order[slot % len(pool_keys)]]]
            dur = int(rng.uniform(0.5, seconds * 0.8) * 16000)
            dur = min(dur, len(src), n - 1)
            start = int(rng.integers(0, n - dur))
            s0 = int(rng.integers(0, max(len(src) - dur, 1)))
            crop = src[s0: s0 + dur]
            if slot_gain:
                crop = crop * float(rng.uniform(0.4, 1.0))
            audio[start: start + len(crop)] += crop
            f0 = start // (160 * model.downsample)
            f1 = min(t_out, (start + len(crop)) // (160 * model.downsample))
            act[f0:f1, slot] = 1.0
        if rng.random() < 0.5:
            audio += rng.standard_normal(n).astype(np.float32) * 0.005
        return audio, act

    if init_from:
        # boundary-sharpening fine-tune of a shipped checkpoint
        model, params = _place_from(init_from, dev)
    else:
        params = R._place(model, seed, dev)
    opt = optim.adam(lr)
    opt_state = opt.init(params)
    perms = list(permutations(range(model.max_speakers)))
    lengths = torch.full((batch,), t_frames, device=dev)

    def frame_weights(a):
        """1 + w on frames within boundary_frames of a slot transition."""
        if boundary_weight <= 0.0:
            return torch.ones_like(a)
        trans = F.pad((a[:, 1:] - a[:, :-1]).abs(), (0, 0, 0, 1))  # (B, T, S)
        near = trans
        for _ in range(max(boundary_frames - 1, 0)):
            near = torch.maximum(near, torch.maximum(F.pad(near, (0, 0, 1, 0))[:, :-1],
                                                     F.pad(near, (0, 0, 0, 1))[:, 1:]))
        return 1.0 + boundary_weight * torch.clamp_max(near, 1.0)

    for i in range(steps):
        scenes = [sample_scene() for _ in range(batch)]
        audio = R._t(np.stack([a for a, _ in scenes]), dev)
        act = R._t(np.stack([s for _, s in scenes]), dev)

        def loss_fn():
            probs = torch.clamp(model(features.fbank(audio), lengths), 1e-6, 1 - 1e-6)
            per_perm = []
            for perm in perms:
                a = act[..., list(perm)]
                w = frame_weights(a)
                bce = -(a * torch.log(probs) + (1 - a) * torch.log(1 - probs))
                per_perm.append((bce * w).sum(dim=(1, 2))
                                / torch.clamp_min(w.sum(dim=(1, 2)), 1.0))
            return torch.stack(per_perm, dim=-1).min(dim=-1).values.mean()

        loss, grads = R._value_and_grad(loss_fn, params)
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"seg step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "SegmentationNet", {})

    # eval: silence -> no activity; speech -> some slot active
    eng = SegmentationEngine(model, device=dev)
    silence_act = eng.activations(np.zeros(n, np.float32)).max()
    speech_act = eng.activations(pools[pool_keys[0]][:n]).max()
    metrics = {"final_loss": float(loss),
               "silence_max_act": round(float(silence_act), 3),
               "speech_max_act": round(float(speech_act), 3),
               "checkpoint": checkpoint_dir}
    log_fn(f"segmentation bootstrap: {metrics}")
    return metrics


# ---------------- enhancement and quality ----------------


def _flow_draws(gen: torch.Generator, b: int, shape: tuple) -> tuple:
    """One flow-matching step's draws: the times t (b,) in [0, 1) and the
    prior's standard normal (`shape`), from `gen` on its device."""
    t = torch.rand((b,), generator=gen, device=gen.device)
    return t, torch.randn(shape, generator=gen, device=gen.device)


@R._reproducible
def bootstrap_enhancer(steps: int = 2000, batch: int = 8, seconds: float = 2.0,
                       checkpoint_dir: str = "checkpoints/enh-bootstrap",
                       seed: int = 0, log_fn=print, ch: int = 48, device="cuda") -> dict:
    """Train the FlowEnhancer by conditional flow matching: x0 ~ N(0,
    PRIOR_STD^2) -> x1 the clean log-magnitude spectrogram, conditioned on
    the degraded one; the model regresses the straight path's velocity
    x1 - x0 at t ~ U(0, 1) (`_flow_draws`, a generator seeded by seed + 7).
    Degradations: noise, muffling, clipping, spectral holes. Eval: held-out
    STOI and SI-SDR at nfe 1 and 64."""
    from ..models.enhancement import PRIOR_STD, EnhancerEngine, FlowEnhancer, _stft_mag_phase
    from ..runtime.registry import save_checkpoint
    from .metrics import si_snr as _si_snr
    from .perceptual import stoi as _stoi

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    voices = [R._load_fixture("chat_mix.wav"), R._load_fixture("female_a.wav")]
    sr = 16000
    n = int(seconds * sr)
    model = FlowEnhancer(ch=ch)

    def degrade(clean, gen):
        x = clean + gen.standard_normal(n).astype(np.float32) * gen.uniform(0.005, 0.03)
        kind = gen.integers(3)
        if kind == 0:  # muffling
            k = int(gen.integers(3, 9))
            x = np.convolve(x, np.ones(k, np.float32) / k, mode="same")
        elif kind == 1:  # clipping
            x = np.clip(x, -gen.uniform(0.2, 0.7), gen.uniform(0.2, 0.7))
        else:  # spectral holes
            spec = np.fft.rfft(x)
            for _ in range(int(gen.integers(1, 4))):
                lo = int(gen.integers(0, len(spec) - 200))
                spec[lo: lo + int(gen.integers(50, 200))] *= gen.uniform(0, 0.2)
            x = np.fft.irfft(spec, n=n)
        return x.astype(np.float32)

    def clip_of(gen):
        src = voices[int(gen.integers(len(voices)))]
        start = int(gen.integers(0, max(len(src) - n, 1)))
        return np.pad(src[start: start + n], (0, max(0, n - (len(src) - start))))[:n]

    def sample_batch(gen):
        xs, ys = [], []
        for _ in range(batch):
            clean = clip_of(gen)
            xs.append(degrade(clean, gen))
            ys.append(clean)
        return np.stack(xs), np.stack(ys)

    params = R._place(model, seed, dev)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(100, steps // 10 + 1), decay_steps=max(steps, 2))
    opt = optim.adamw(sched, weight_decay=1e-5)
    opt_state = opt.init(params)
    gen_t = torch.Generator(device=dev).manual_seed(seed + 7)

    for i in range(steps):
        noisy, clean = (R._t(a, dev) for a in sample_batch(rng))
        with torch.no_grad():
            cond = _stft_mag_phase(noisy)[0]
            x1 = _stft_mag_phase(clean)[0]
        t, z = _flow_draws(gen_t, x1.shape[0], tuple(x1.shape))

        def loss_fn():
            x0 = z * PRIOR_STD
            xt = (1 - t)[:, None, None] * x0 + t[:, None, None] * x1
            v = model(xt, t, cond)
            return (v - (x1 - x0)).square().mean()

        loss, grads = R._value_and_grad(loss_fn, params)
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 10, 1) == 0:
            log_fn(f"enh step {i + 1}/{steps}: loss={float(loss):.3f}")

    save_checkpoint(checkpoint_dir, model, "FlowEnhancer", {"ch": ch, "sample_rate": sr})

    # held-out eval at the preset NFE endpoints
    eng = EnhancerEngine(model, device=dev)
    gen = np.random.default_rng(seed + 999)
    res = {1: {"stoi": [], "sdr": []}, 64: {"stoi": [], "sdr": []}}
    base = {"stoi": [], "sdr": []}
    for _ in range(6):
        clean = clip_of(gen)
        noisy = degrade(clean, gen)
        base["stoi"].append(_stoi(clean, noisy))
        base["sdr"].append(_si_snr(noisy, clean))
        for nfe in (1, 64):
            est = eng.enhance(noisy, sr=sr, nfe=nfe)
            res[nfe]["stoi"].append(_stoi(clean, est))
            res[nfe]["sdr"].append(_si_snr(est, clean))
    metrics = {
        "final_loss": float(loss),
        "noisy_stoi": round(float(np.mean(base["stoi"])), 3),
        "noisy_si_sdr": round(float(np.mean(base["sdr"])), 2),
        "nfe1_stoi": round(float(np.mean(res[1]["stoi"])), 3),
        "nfe64_stoi": round(float(np.mean(res[64]["stoi"])), 3),
        "nfe1_si_sdr": round(float(np.mean(res[1]["sdr"])), 2),
        "nfe64_si_sdr": round(float(np.mean(res[64]["sdr"])), 2),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"enhancer bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_mos(steps: int = 800, batch: int = 8, pool: int = 240,
                  checkpoint_dir: str = "checkpoints/mos-bootstrap",
                  seed: int = 0, log_fn=print, device="cuda") -> dict:
    """Calibrate DNSMOSNet's two heads (`train/mos.py`) on synthetic
    degradations against pseudo-MOS targets: BAK from the injected noise's
    SNR, SIG from STOI(clean, distorted without noise), OVRL their
    min-weighted blend; the 3-output head trains in the raw domain (the
    P.835 polynomials inverted on [0, 5]), the P.808 head on OVRL. A pool of
    `pool` samples is made once and batches drawn from it. Eval: Pearson r
    of the predicted OVRL against the true one on 12 held-out samples."""
    from ..runtime.registry import save_checkpoint
    from .mos import _P_BAK, _P_OVR, _P_SIG, INPUT_LENGTH, DNSMOSNet, MOSEstimator, audio_melspec
    from .perceptual import stoi as _stoi

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    voices = [R._load_fixture("chat_mix.wav"), R._load_fixture("female_a.wav")]
    sr = 16000
    n = int(INPUT_LENGTH * sr)

    def inv_poly(p, y):
        """x in [0, 5] with polyval(p, x) == y (monotone on the range)."""
        xs = np.linspace(0.0, 5.0, 501)
        return float(np.interp(y, np.polyval(p, xs), xs))

    def sample(gen):
        src = voices[int(gen.integers(len(voices)))]
        tiled = np.tile(src, int(np.ceil(n / len(src))) + 1)
        start = int(gen.integers(0, len(tiled) - n))
        clean = tiled[start: start + n].copy()
        # speech distortion: muffling / clipping of varying severity
        sev = float(gen.uniform(0.0, 1.0))
        distorted = clean
        if sev > 0.05:
            k = 1 + int(sev * 10)
            distorted = np.convolve(clean, np.ones(k, np.float32) / k, mode="same")
            c = 1.0 - 0.75 * sev
            distorted = np.clip(distorted, -c, c)
        # background noise of varying SNR
        snr_db = float(gen.uniform(0.0, 40.0))
        sig_pow = np.mean(clean ** 2) + 1e-9
        noise = gen.standard_normal(n).astype(np.float32)
        noise *= np.sqrt(sig_pow / 10 ** (snr_db / 10))
        degraded = distorted + noise
        sig_mos = 1.0 + 4.0 * _stoi(clean, distorted)
        bak_mos = 1.0 + 4.0 * min(snr_db, 40.0) / 40.0
        ovr_mos = min(sig_mos, bak_mos) * 0.7 + 0.3 * (sig_mos + bak_mos) / 2.0
        raw = [inv_poly(_P_SIG, sig_mos), inv_poly(_P_BAK, bak_mos),
               inv_poly(_P_OVR, ovr_mos)]
        return degraded, np.asarray(raw, np.float32), ovr_mos

    net, net808 = DNSMOSNet(n_out=3), DNSMOSNet(n_out=1)
    leaves = R._place(net, seed, dev) + R._place(net808, seed + 1, dev)
    opt = optim.adam(3e-4)
    opt_state = opt.init(leaves)

    # a fixed sample pool, made once (the mel and STOI are host work)
    pool_mels, pool_raws, pool_mos = [], [], []
    for _ in range(pool):
        deg, raw, ovr = sample(rng)
        pool_mels.append(audio_melspec(deg[:-160]))
        pool_raws.append(raw)
        pool_mos.append(ovr)
    pool_mels = R._t(np.stack(pool_mels), dev)
    pool_raws = R._t(np.stack(pool_raws), dev)
    pool_mos = R._t(np.asarray(pool_mos, np.float32), dev)

    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, pool, size=batch), device=dev)
        mels, raw3, mos1 = pool_mels[idx], pool_raws[idx], pool_mos[idx]

        def loss_fn():
            return ((net(mels) - raw3).square().mean()
                    + (net808(mels)[:, 0] - mos1).square().mean())

        loss, grads = R._value_and_grad(loss_fn, leaves)
        opt_state = R._apply(opt, opt_state, leaves, grads, net)
        if (i + 1) % max(steps // 8, 1) == 0:
            log_fn(f"mos step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, net, "DNSMOSNet", {"n_out": 3})
    save_checkpoint(f"{checkpoint_dir}/p808", net808, "DNSMOSNet", {"n_out": 1})

    # held-out: correlation between predicted OVRL and true pseudo-MOS
    est = MOSEstimator(net, net808, device=dev)
    gen = np.random.default_rng(seed + 999)
    pred, true = [], []
    for _ in range(12):
        deg, _, ovr = sample(gen)
        pred.append(est(deg)["OVRL"])
        true.append(ovr)
    r = float(np.corrcoef(pred, true)[0, 1])
    metrics = {"final_loss": float(loss), "ovrl_pearson_r": round(r, 3),
               "checkpoint": checkpoint_dir}
    log_fn(f"mos bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_sigmos(steps: int = 2500, batch: int = 16, pool: int = 512,
                     checkpoint_dir: str = "checkpoints/sigmos-bootstrap",
                     seed: int = 0, log_fn=print, device="cuda") -> dict:
    """Calibrate SigMOSNet (`train/mos.py`) on synthetic degradations with an
    independent severity per P.804 dimension (noise SNR, an exponential
    reverb tail, a loudness offset, lowpass coloration, dropouts); SIG and
    OVRL are min-weighted blends. Adam on a cosine decay from 5e-4 to 5 % of
    it. Eval: Pearson r of the predicted MOS_OVRL on 16 held-out crops, and
    whether each single-dimension degradation lowers its own dimension."""
    from ..runtime.registry import save_checkpoint
    from .mos import SigMOSEstimator, SigMOSNet, sigmos_frontend

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    voices = [R._load_fixture("chat_mix.wav"), R._load_fixture("female_a.wav")]
    sr, secs = 16000, 2.0
    n = int(secs * sr)
    t_frames = sigmos_frontend(np.zeros(n, np.float32), sr).shape[1]

    def sample(gen, only: str | None = None):
        src = voices[int(gen.integers(len(voices)))]
        tiled = np.tile(src, int(np.ceil(n / len(src))) + 1)
        start = int(gen.integers(0, len(tiled) - n))
        x = tiled[start: start + n].copy()
        x /= max(float(np.abs(x).max()), 1e-6)  # nominal level
        sev = {k: float(gen.uniform(0.0, 1.0))
               for k in ("noise", "reverb", "loud", "col", "disc")}
        if only is not None:  # single-dimension probe for the eval
            sev = {k: (0.9 if k == only else 0.0) for k in sev}
        if sev["col"] > 0.05:  # coloration: moving-average lowpass
            k = 1 + int(sev["col"] * 11)
            x = np.convolve(x, np.ones(k, np.float32) / k, mode="same")
        if sev["reverb"] > 0.05:  # reverb: exponential-decay tail
            rt = sev["reverb"] * 0.8
            t = np.arange(int(rt * sr))
            ir = np.exp(-3.0 * np.log(10) * t / (rt * sr)).astype(np.float32)
            ir *= gen.standard_normal(len(ir)).astype(np.float32) * 0.25
            ir[0] = 1.0
            x = np.convolve(x, ir, mode="full")[:n]
        for _ in range(int(round(sev["disc"] * 6))):  # discontinuities: dropouts
            at = int(gen.integers(0, n - 640))
            x[at: at + 640] = 0.0
        x = x * 10 ** (-30.0 * sev["loud"] / 20)  # loudness offset (quiet side)
        snr_db = 40.0 * (1.0 - sev["noise"])  # additive noise
        sig_pow = np.mean(x ** 2) + 1e-12
        noise = gen.standard_normal(n).astype(np.float32)
        noise *= np.sqrt(sig_pow / 10 ** (snr_db / 10))
        x = x + noise
        mos = {
            "MOS_NOISE": 1.0 + 4.0 * (1.0 - sev["noise"]),
            "MOS_REVERB": 5.0 - 4.0 * sev["reverb"],
            "MOS_LOUD": 5.0 - 4.0 * sev["loud"],
            "MOS_COL": 5.0 - 4.0 * sev["col"],
            "MOS_DISC": 5.0 - 4.0 * sev["disc"],
        }
        sig3 = np.array([mos["MOS_COL"], mos["MOS_DISC"], mos["MOS_REVERB"]])
        mos["MOS_SIG"] = float(0.7 * sig3.min() + 0.3 * sig3.mean())
        all4 = np.array([mos["MOS_SIG"], mos["MOS_NOISE"], mos["MOS_LOUD"]])
        mos["MOS_OVRL"] = float(0.7 * all4.min() + 0.3 * all4.mean())
        feat = sigmos_frontend(x, sr)[:, :t_frames]
        target = np.asarray([mos[k] for k in SigMOSEstimator.KEYS], np.float32)
        return feat, target, mos["MOS_OVRL"]

    net = SigMOSNet(n_out=7)
    params = R._place(net, seed, dev)
    opt = optim.adam(optim.cosine_decay_schedule(5e-4, steps, 0.05))
    opt_state = opt.init(params)

    pool_f, pool_t = [], []
    for _ in range(pool):
        f, t, _ = sample(rng)
        pool_f.append(f)
        pool_t.append(t)
    pool_f, pool_t = R._t(np.stack(pool_f), dev), R._t(np.stack(pool_t), dev)

    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, pool, size=batch), device=dev)
        feats, targets = pool_f[idx], pool_t[idx]

        def loss_fn():
            return (net(feats) - targets).square().mean()

        loss, grads = R._value_and_grad(loss_fn, params)
        opt_state = R._apply(opt, opt_state, params, grads, net)
        if (i + 1) % max(steps // 6, 1) == 0:
            log_fn(f"sigmos step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, net, "SigMOSNet", {"n_out": 7})

    est = SigMOSEstimator(net, device=dev)
    gen = np.random.default_rng(seed + 999)
    ovrl = SigMOSEstimator.KEYS.index("MOS_OVRL")
    pred, true = [], []
    for _ in range(16):
        f, _, ovr = sample(gen)
        pred.append(float(est.scores(f[None])[0, ovrl]))
        true.append(ovr)
    r = float(np.corrcoef(pred, true)[0, 1])
    # directionality: each single-dimension degradation must lower its own
    # MOS dimension against a clean crop
    probes = {"noise": "MOS_NOISE", "reverb": "MOS_REVERB",
              "loud": "MOS_LOUD", "col": "MOS_COL", "disc": "MOS_DISC"}
    f_clean, _, _ = sample(np.random.default_rng(seed + 5), only="none")
    clean_out = est.scores(f_clean[None])[0]
    direction_ok = {}
    for dim, key in probes.items():
        f_deg, _, _ = sample(np.random.default_rng(seed + 5), only=dim)
        ki = SigMOSEstimator.KEYS.index(key)
        direction_ok[dim] = bool(est.scores(f_deg[None])[0, ki] < clean_out[ki])
    metrics = {"final_loss": float(loss), "ovrl_pearson_r": round(r, 3),
               "direction_ok": direction_ok, "checkpoint": checkpoint_dir}
    log_fn(f"sigmos bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_denoiser(steps: int = 200, batch: int = 2,
                       checkpoint_dir: str = "checkpoints/den-bootstrap",
                       seed: int = 0, log_fn=print, device="cuda") -> dict:
    """Train a small MDX TDF-UNet (8 channels, depth 3, growth 4) to predict
    the noise ("instrumental") component of noisy stereo 44.1 kHz mixtures
    on the packed STFT, so that vocals = mix - prediction (the contract the
    denoise engine implements): L1 on the packed spectra. Eval: SI-SDR of a
    noisy and a denoised fixture through the engine."""
    from ..models.denoise import DenoiseEngine, TDFUNet, mdx_chunk_size, mdx_stft
    from ..ops.resample import resample_poly_np
    from ..runtime.registry import save_checkpoint
    from .metrics import si_snr as _si_snr

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    hop = 1024
    chunk = mdx_chunk_size(hop)
    voices = [resample_poly_np(R._load_fixture("chat_mix.wav"), 44100, 16000),
              resample_poly_np(R._load_fixture("female_a.wav"), 44100, 16000)]
    model_args = dict(channels=8, depth=3, growth=4)
    model = TDFUNet(**model_args)

    def sample_batch():
        mixes, noises = [], []
        for _ in range(batch):
            src = voices[int(rng.integers(len(voices)))]
            start = int(rng.integers(0, max(len(src) - chunk, 1)))
            speech = src[start: start + chunk]
            speech = np.pad(speech, (0, chunk - len(speech)))
            noise = rng.standard_normal(chunk).astype(np.float32)
            noise *= rng.uniform(0.01, 0.1) / (np.abs(noise).max() + 1e-9)
            mix = speech + noise
            mixes.append(np.stack([mix, mix]))  # stereo
            noises.append(np.stack([noise, noise]))
        return np.stack(mixes), np.stack(noises)

    params = R._place(model, seed, dev)
    opt = optim.adam(1e-3)
    opt_state = opt.init(params)

    for i in range(steps):
        mix_wav, noise_wav = (R._t(a, dev) for a in sample_batch())
        with torch.no_grad():
            mix_spec, noise_spec = mdx_stft(mix_wav, hop), mdx_stft(noise_wav, hop)

        def loss_fn():
            return (model(mix_spec) - noise_spec).abs().mean()

        loss, grads = R._value_and_grad(loss_fn, params)
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"den step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "TDFUNet", model_args)

    # eval through the engine: denoising must raise SNR against clean speech
    eng = DenoiseEngine(model, hop=hop, device=dev)
    src16 = R._load_fixture("female_a.wav")
    noisy16 = src16 + rng.standard_normal(len(src16)).astype(np.float32) * 0.02
    den = eng.denoise_vocal(noisy16, sr=16000)
    metrics = {
        "final_loss": float(loss),
        "noisy_si_sdr": round(_si_snr(noisy16, src16), 2),
        "denoised_si_sdr": round(_si_snr(den, src16), 2),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"denoiser bootstrap: {metrics}")
    return metrics


# ---------------- text, emotion and the whisper-style ASR ----------------


def _token_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy: the integer-label cross-entropy
    summed over the mask, over max(mask's sum, 1)."""
    ce = softmax_cross_entropy_with_integer_labels(logits, targets)
    return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


@R._reproducible
def bootstrap_punc(steps: int = 800, batch: int = 32,
                   checkpoint_dir: str = "checkpoints/punc-bootstrap",
                   seed: int = 0, log_fn=print, eval_utts: int = 200, device="cuda") -> dict:
    """Train CTTransformerPunc (128 wide, 2 layers) on rule-punctuated
    synthetic text (`train/synth.py::punctuate_by_rule`): masked token CE,
    AdamW. Eval: class accuracy and exact restores on held-out text."""
    from ..models.punctuation import CTTransformerPunc, PunctuationEngine
    from ..models.tokenizer import CharTokenizer
    from ..runtime.registry import save_checkpoint
    from .synth import punctuate_by_rule, random_text

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    tok = CharTokenizer()
    max_len = 16

    def sample_batch(gen):
        ids = np.zeros((batch, max_len), np.int32)
        cls = np.zeros((batch, max_len), np.int32)
        mask = np.zeros((batch, max_len), np.float32)
        for b in range(batch):
            text = random_text(gen, 2, max_len)
            _, classes = punctuate_by_rule(text)
            enc = tok.encode(text)
            ids[b, : len(enc)] = enc
            cls[b, : len(enc)] = classes
            mask[b, : len(enc)] = 1.0
        return ids, cls, mask

    model_args = dict(vocab_size=len(tok), dim=128, ffn=256, n_layers=2)
    model = CTTransformerPunc(**model_args)
    params = R._place(model, seed, dev)
    opt = optim.adamw(1e-3, weight_decay=1e-4)
    opt_state = opt.init(params)

    for i in range(steps):
        ids, cls, mask = (R._t(a, dev) for a in sample_batch(rng))
        loss, grads = R._value_and_grad(lambda: _token_ce(model(ids, mask), cls, mask), params)
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"punc step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "CTTransformerPunc", model_args)
    tok.save(os.path.join(checkpoint_dir, "vocab.txt"))

    # held-out: class accuracy + end-to-end restore equality
    eng = PunctuationEngine(model, tokenizer=tok, device=dev)
    gen = np.random.default_rng(seed + 1)
    correct = total = exact = 0
    for _ in range(eval_utts):
        text = random_text(gen, 2, max_len)
        want_text, want_cls = punctuate_by_rule(text)
        got_cls = eng.predict_classes(text)
        correct += int(np.sum(np.asarray(want_cls) == got_cls))
        total += len(want_cls)
        exact += int(eng.punctuation_restore(text) == want_text)
    metrics = {
        "final_loss": float(loss),
        "class_accuracy": correct / max(total, 1),
        "exact_restore": exact / max(eval_utts, 1),
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"punc bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_emotion(steps: int = 4000, batch: int = 32, seconds: float = 2.0,
                      checkpoint_dir: str = "checkpoints/emo-bootstrap",
                      seed: int = 0, log_fn=print, eval_utts: int = 240, device="cuda") -> dict:
    """Train EmotionNet on prosody transforms of the fixture voices, one a
    class: neutral unchanged, happy pitch up ~20 %, sad pitch down ~20 % at
    -6 dB, angry +9 dB hard-clipped, fearful a 6 Hz tremolo, surprised a
    strong pitch rise with a rising gain ramp (a deterministic, evaluable
    label, not a claim about human emotion). Eval: held-out transform
    accuracy and its confusion counts."""
    from ..models import features
    from ..models.emotion import EMOTION_LABELS, EmotionEngine, EmotionNet
    from ..ops.resample import resample_poly_np
    from ..runtime.registry import save_checkpoint

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    voices = [R._load_fixture("chat_mix.wav"), R._load_fixture("female_a.wav")]
    sr = 16000
    n = int(seconds * sr)
    t_frames = features.num_frames(n)

    def pitch(x, factor):
        # resample-based shift (the duration change is part of the prosody)
        y = resample_poly_np(x, int(sr / factor), sr)[:n]
        return np.pad(y, (0, n - len(y)))

    classes = ["neutral", "happy", "sad", "angry", "fearful", "surprised"]
    cls_ids = torch.as_tensor([EMOTION_LABELS.index(c) for c in classes], device=dev)

    def transform(x, cls, gen):
        if cls == "neutral":
            return x
        if cls == "happy":
            return pitch(x, gen.uniform(1.15, 1.3))
        if cls == "sad":
            return pitch(x, gen.uniform(0.75, 0.87)) * 0.5
        if cls == "angry":
            return np.clip(x * gen.uniform(2.5, 3.5), -0.5, 0.5)
        if cls == "fearful":
            t = np.arange(n) / sr
            f = gen.uniform(5.0, 8.0)
            return x * (1.0 + 0.6 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        ramp = np.linspace(0.3, 1.8, n).astype(np.float32)
        return pitch(x, gen.uniform(1.25, 1.4)) * ramp  # surprised

    def sample(gen):
        # near-silent source windows are redrawn (up to 8 tries): a prosody
        # transform of silence is indistinguishable
        for _ in range(8):
            src = voices[int(gen.integers(len(voices)))]
            start = int(gen.integers(0, max(len(src) - n, 1)))
            x = src[start: start + n]
            x = np.pad(x, (0, n - len(x)))
            if float(np.sqrt(np.mean(x ** 2))) >= 5e-3:
                break
        ci = int(gen.integers(len(classes)))
        return transform(x, classes[ci], gen).astype(np.float32), ci

    def sample_batch(gen):
        xs, ys = zip(*(sample(gen) for _ in range(batch)))
        return np.stack(xs), np.array(ys, np.int32)

    model = EmotionNet()
    params = R._place(model, seed, dev)
    opt = optim.adamw(1e-3, weight_decay=1e-4)
    opt_state = opt.init(params)
    lengths = torch.full((batch,), t_frames, device=dev)

    for i in range(steps):
        audio, labels = (R._t(a, dev) for a in sample_batch(rng))

        def loss_fn():
            return softmax_cross_entropy_with_integer_labels(
                model(features.fbank(audio), lengths), cls_ids[labels.long()]).mean()

        loss, grads = R._value_and_grad(loss_fn, params)
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 5, 1) == 0:
            log_fn(f"emo step {i + 1}/{steps}: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "EmotionNet", {})

    eng = EmotionEngine(model, device=dev)
    gen = np.random.default_rng(seed + 999)
    correct = 0
    confusion = np.zeros((len(classes), len(classes)), np.int64)
    for _ in range(eval_utts):
        x, ci = sample(gen)
        out = eng.emotion_detection(x)
        top = out["labels"][int(np.argmax(out["scores"]))]
        pj = classes.index(top) if top in classes else ci
        confusion[ci, pj] += 1
        correct += int(top == classes[ci])
    metrics = {
        "final_loss": float(loss),
        "eval_accuracy": correct / max(eval_utts, 1),
        "confusion": {c: {classes[j]: int(confusion[i, j])
                          for j in range(len(classes)) if confusion[i, j]}
                      for i, c in enumerate(classes)},
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"emotion bootstrap: {metrics}")
    return metrics


@R._reproducible
def bootstrap_whisper(steps: int = 3000, batch: int = 16, seconds: float = 4.0,
                      checkpoint_dir: str = "checkpoints/whisper-bootstrap",
                      seed: int = 0, log_fn=print, eval_utts: int = 50,
                      dim: int = 128, enc_layers: int = 3, dec_layers: int = 2,
                      ffn: int = 512, phase1_steps: int | None = None,
                      device_synth: bool = False,
                      init_from: str | None = None, aug_frac: float = 0.0,
                      denoiser_dir: str = "checkpoints/den-bootstrap",
                      peak_lr: float = 1e-3,
                      fresh_source: str = "host",
                      n_corpus: int = 2000,
                      corpus_noise: str = "fixed",
                      phase1_exit_loss: float = 1.5, device="cuda") -> dict:
    """Train the whisper-style encoder-decoder ASR on the synthetic language:
    teacher-forced CE, AdamW on a warmup cosine schedule; greedy-decode CER
    on held-out utterances.

    Batches come from a finite corpus of `n_corpus` utterances (`corpus_noise`
    "fixed": noise baked in; "fresh": clean, a new gain and noise each draw).
    With `device_synth`, a two-phase curriculum: the corpus for
    `phase1_steps` (default min(3000, steps // 3)), then, once the loss is
    under `phase1_exit_loss` (or at a cap), fresh batches ramped in over
    max(steps // 6, 1000) steps (at once where phase 1 is empty), made on
    the host (`fresh_source="host"`, `UnitPool`) or on the device
    (`train/synth_device.py`, one key a step). `aug_frac` of each fresh
    batch goes through the pipeline's preprocess chain where a denoiser is
    loaded (`recipes._preprocess_one`). `init_from` continues from a
    checkpoint of the same geometry."""
    from ..models import features
    from ..models.tokenizer import CharTokenizer
    from ..models.whisper_style import WhisperStyleASR, WhisperStyleEngine
    from ..runtime.registry import save_checkpoint
    from .synth import BOOT_CHARS, UnitPool, cer, random_text, synth_utterance

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    tok = CharTokenizer()
    sos, eos = tok.sos_id, tok.eos_id
    n = int(seconds * 16000)
    max_chars = 10
    u = max_chars + 2  # sos + chars + eos
    pool = UnitPool(seed=seed + 177)

    # the finite corpus: epochs over it let the cross-attention align
    corpus = []
    for _ in range(n_corpus):
        text = random_text(rng, 2, max_chars)
        if corpus_noise == "fresh":
            audio, _ = pool.utterance(text, rng)  # clean; noise per draw
        else:
            snr = float(rng.uniform(12, 35)) if rng.random() < 0.5 else None
            audio, _ = pool.utterance(text, rng, noise_snr_db=snr)
        corpus.append((audio[:n], tok.encode(text)))

    def targets(b, ids, tok_in, tgt, tgt_mask):
        tok_in[b, 0] = sos
        tok_in[b, 1: 1 + len(ids)] = ids
        tgt[b, : len(ids)] = ids
        tgt[b, len(ids)] = eos
        tgt_mask[b, : len(ids) + 1] = 1.0

    def token_arrays():
        return (np.full((batch, u), eos, np.int32), np.full((batch, u), eos, np.int32),
                np.zeros((batch, u), np.float32))

    def sample_batch(gen):
        audios = np.zeros((batch, n), np.float32)
        n_frames = np.ones(batch, np.int32)
        tok_in, tgt, tgt_mask = token_arrays()
        for b in range(batch):
            audio, ids = corpus[int(gen.integers(n_corpus))]
            if corpus_noise == "fresh":
                audio = audio * float(gen.uniform(0.5, 1.2))
                if gen.random() < 0.7:
                    snr_db = float(gen.uniform(8, 35))
                    rms = float(np.sqrt(np.mean(audio**2)) + 1e-9)
                    noise = gen.standard_normal(len(audio)).astype(
                        np.float32) * (rms / (10 ** (snr_db / 20)))
                    audio = audio + noise
            audios[b, : len(audio)] = audio
            # the true frame count: inference's padded-bucket masks
            n_frames[b] = max(features.num_frames(len(audio)), 1)
            targets(b, ids, tok_in, tgt, tgt_mask)
        return audios, n_frames, tok_in, tgt, tgt_mask

    model_args = dict(vocab_size=len(tok), dim=dim, heads=4, ffn=ffn,
                      enc_layers=enc_layers, dec_layers=dec_layers)
    if init_from:
        # fine-tune: continue from a checkpoint at the same geometry
        model, params = _place_from(init_from, dev)
    else:
        model = WhisperStyleASR(**model_args)
        params = R._place(model, seed, dev)
    sched = optim.warmup_cosine_decay_schedule(
        0.0, peak_lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=max(steps, 2))
    opt = optim.adamw(sched, weight_decay=1e-4)
    opt_state = opt.init(params)

    def step(audio, n_frames, tok_in, tgt, tgt_mask):
        def loss_fn():
            feats = features.fbank(audio)
            fmask = (torch.arange(feats.shape[1], device=dev)[None, :]
                     < n_frames[:, None]).float()
            return _token_ce(model(feats, fmask, tok_in.long()), tgt, tgt_mask)

        loss, grads = R._value_and_grad(loss_fn, params)
        return loss, grads

    # ---- the fresh-batch source (device_synth) ----
    p1 = steps if not device_synth else (
        phase1_steps if phase1_steps is not None else min(3000, steps // 3))
    den_eng = None
    n_aug = 0
    if device_synth:
        # the first aug_frac of each fresh batch through the pipeline's
        # preprocess chain (loudness, MDX denoise, loudness, int16 round trip)
        n_aug = int(round(batch * aug_frac))
        if n_aug > 0 and os.path.isdir(denoiser_dir):
            from ..models.denoise import DenoiseEngine

            den_eng = DenoiseEngine.from_pretrained(denoiser_dir, device=dev)

    def preprocess(audio, n_valid):
        """The first n_aug rows of `audio` (a device batch) preprocessed."""
        if n_aug == 0 or den_eng is None:
            return audio
        with torch.no_grad():
            aug = torch.stack([R._preprocess_one(den_eng, audio[b], n_valid[b], n)
                               for b in range(n_aug)])
        return torch.cat([aug, audio[n_aug:]], dim=0)

    if device_synth and fresh_source == "host":
        # a new UnitPool batch a step: the distribution of the corpus and of
        # the held-out eval, unseen samples only
        def sample_fresh(gen, step_i):
            audios = np.zeros((batch, n), np.float32)
            n_valid = np.ones(batch, np.int32)
            n_frames = np.ones(batch, np.int32)
            tok_in, tgt, tgt_mask = token_arrays()
            for b in range(batch):
                text = random_text(gen, 2, max_chars)
                snr = float(gen.uniform(12, 35)) if gen.random() < 0.5 else None
                audio, _ = pool.utterance(text, gen, noise_snr_db=snr)
                audio = audio[:n]
                audios[b, : len(audio)] = audio
                n_valid[b] = len(audio)
                n_frames[b] = max(features.num_frames(len(audio)), 1)
                targets(b, tok.encode(text), tok_in, tgt, tgt_mask)
            audios = preprocess(R._t(audios, dev), R._t(n_valid, dev))
            return audios, n_frames, tok_in, tgt, tgt_mask

    elif device_synth:
        from .synth_device import add_noise_from_draws, render_from_draws

        def sample_fresh(gen, step_i):
            boot_idx = np.zeros((batch, max_chars), np.int32)
            n_chars = np.zeros(batch, np.int32)
            tok_in, tgt, tgt_mask = token_arrays()
            for b in range(batch):
                text = random_text(gen, 2, max_chars)
                for ci, ch in enumerate(text):
                    boot_idx[b, ci] = BOOT_CHARS.index(ch)
                n_chars[b] = len(text)
                targets(b, tok.encode(text), tok_in, tgt, tgt_mask)
            with torch.no_grad():
                r_draws, n_draws = R._synth_draws((seed * 104729 + step_i,), batch,
                                                  max_chars, n, dev)
                r = render_from_draws(r_draws, R._t(boot_idx, dev), R._t(n_chars, dev), n)
                audio = add_noise_from_draws(n_draws, r["audio"], r["n_valid"])
                audio = preprocess(audio, r["n_valid"])
                nv = r["n_valid"]
                nf = torch.clamp_min(torch.where(nv < 400, 0, 1 + (nv - 400) // 160), 1)
            return audio, nf, tok_in, tgt, tgt_mask

    # the switch to fresh batches waits for the corpus loss to fall (the
    # alignment locked), capped; then a linear ramp of the fresh share
    ramp_steps = max(steps // 6, 1000)
    p1_cap = min(max(p1 * 3, p1 + 6000), steps) if device_synth else p1
    in_phase1 = p1 > 0
    ramp_start = None
    loss = torch.tensor(999.0)
    for i in range(steps):
        if device_synth and in_phase1 and i >= p1:
            if float(loss) < phase1_exit_loss:
                in_phase1 = False
                ramp_start = i
                log_fn(f"whisper: alignment locked (CE "
                       f"{float(loss):.3f}) — ramping in fresh "
                       f"synthesis over {ramp_steps} steps from step {i}")
            elif i >= p1_cap:
                in_phase1 = False
                ramp_start = i
                log_fn(f"whisper: phase-1 cap {p1_cap} reached at CE "
                       f"{float(loss):.3f} — ramping anyway")
        if device_synth and not in_phase1 and p1 == 0 and ramp_start is None:
            ramp_start = 0  # init_from fine-tune: no corpus phase at all
        p_fresh = 0.0 if (not device_synth or in_phase1) else (
            1.0 if p1 == 0 else min(1.0, (i - ramp_start) / ramp_steps))
        if rng.random() < p_fresh:
            batch_arrays = sample_fresh(rng, i)
        else:
            batch_arrays = sample_batch(rng)
        loss, grads = step(*(a if isinstance(a, torch.Tensor) else R._t(a, dev)
                             for a in batch_arrays))
        opt_state = R._apply(opt, opt_state, params, grads, model)
        if (i + 1) % max(steps // 20, 1) == 0:
            phase = "p1-corpus" if (not device_synth or in_phase1) \
                else f"p2-fresh={p_fresh:.2f}"
            log_fn(f"whisper step {i + 1}/{steps} [{phase}]: loss={float(loss):.4f}")

    save_checkpoint(checkpoint_dir, model, "WhisperStyleASR", model_args)
    tok.save(os.path.join(checkpoint_dir, "vocab.txt"))

    eng = WhisperStyleEngine(model, tokenizer=tok, max_decode=max_chars + 2, device=dev)
    gen = np.random.default_rng(seed + 1)
    # the preprocessed leg: held-out utterances through the preprocess chain too
    cers, cers_pre = [], []
    for _ in range(eval_utts):
        text = random_text(gen, 2, max_chars)
        audio, _ = synth_utterance(text, gen)
        cers.append(cer(text, eng.asr_detection(audio)[0]["text"]))
        if device_synth and n_aug > 0 and den_eng is not None:
            nv = min(len(audio), n)
            buf = np.zeros(n, np.float32)
            buf[:nv] = audio[:nv]
            with torch.no_grad():
                pre = R._preprocess_one(den_eng, R._t(buf, dev), R._t(nv, dev), n)
            cers_pre.append(cer(text, eng.asr_detection(pre.cpu().numpy()[:nv])[0]["text"]))
    metrics = {
        "final_loss": float(loss),
        "eval_cer": float(np.mean(cers)),
        "eval_exact": float(np.mean([c == 0.0 for c in cers])),
        "eval_cer_preprocessed": float(np.mean(cers_pre)) if cers_pre else None,
        "checkpoint": checkpoint_dir,
    }
    log_fn(f"whisper bootstrap: {metrics}")
    return metrics
