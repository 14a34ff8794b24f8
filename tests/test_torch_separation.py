"""The PyTorch port's MossFormer2 against the JAX package, module by module.

One flax parameter tree (random init, perturbed so that no bias is zero
and no scale is one) goes through `runtime/convert.py` into the port; the
same numpy inputs go through both. JAX runs on the CPU at full float32
matmul precision, the port with `device="cpu"` in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import separation as jsep
from targetdiarization_tpu_torch.models import separation as tsep
from targetdiarization_tpu_torch.runtime.convert import mossformer2_state_dict

SMALL = dict(dim=64, enc_channels=64, num_blocks=2, group_size=32, qk_dim=32, fsmn_inner=64)
RTOL, ATOL = 1e-4, 1e-5


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(p.shape),
                              jnp.float32), params)


def _init(module, *args, seed=0):
    with jax.default_matmul_precision("highest"):
        params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    return _perturb(params, seed)


def _apply(module, params, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(module.apply)(params, *args))


def _port(module, params, prefix=""):
    sd = mossformer2_state_dict(
        {prefix.rstrip("/"): params["params"]} if prefix else params["params"])
    if prefix:
        sd = {k[len(prefix.rstrip("/")) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _inputs(rng, b=2, t=64, c=64, valid=(64, 50)):
    x = (rng.standard_normal((b, t, c)) * 0.5).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(valid)[:, None]).astype(np.float32)
    return x, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_scale_norm(rng):
    x, _ = _inputs(rng)
    x[0, :3] = 0.0  # all-zero rows take the eps clamp
    mod = jsep.ScaleNorm()
    params = _init(mod, jnp.asarray(x))
    port = _port(tsep.ScaleNorm(), params)
    with torch.no_grad():
        _close(port(_t(x)), _apply(mod, params, jnp.asarray(x)))


def test_global_layer_norm(rng):
    x, mask = _inputs(rng)
    mod = jsep.GlobalLayerNorm(64)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.GlobalLayerNorm(64), params)
    with torch.no_grad():
        _close(port(_t(x), _t(mask)), _apply(mod, params, jnp.asarray(x), jnp.asarray(mask)))
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tsep.masked_global_layer_norm(_t(x), _t(mask), _t(w), _t(bias)),
           jsep.masked_global_layer_norm(jnp.asarray(x), jnp.asarray(mask), w, bias))


@pytest.mark.parametrize("norm,cout", [("scalenorm", 256), ("layernorm", 64)])
def test_ffconvm_module(norm, cout, rng):
    x, _ = _inputs(rng)
    mod = jsep.FFConvM(cout, norm=norm)
    params = _init(mod, jnp.asarray(x))
    port = _port(tsep.FFConvM(64, cout, norm=norm), params)
    with torch.no_grad():
        _close(port(_t(x)), _apply(mod, params, jnp.asarray(x)))


def test_rope_rotate(rng):
    x = rng.standard_normal((2, 300, 48)).astype(np.float32)
    _close(tsep.rope_rotate(_t(x)), np.asarray(jsep.rope_rotate(jnp.asarray(x))),
           rtol=1e-4, atol=1e-4)


def test_flash_block(rng):
    x, mask = _inputs(rng)
    mod = jsep.FlashBlock(dim=64, group_size=32, qk_dim=32)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.FlashBlock(64, group_size=32, qk_dim=32), params)
    with torch.no_grad():
        _close(port(_t(x), _t(mask)), _apply(mod, params, jnp.asarray(x), jnp.asarray(mask)))


def test_dilated_dense_fsmn(rng):
    x, mask = _inputs(rng)
    mod = jsep.DilatedDenseFsmnNet(64)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.DilatedDenseFsmnNet(64), params, prefix="ddn/")
    with torch.no_grad():
        _close(port(_t(x), _t(mask)), _apply(mod, params, jnp.asarray(x), jnp.asarray(mask)),
               atol=1e-4)


def test_dilated_fsmn(rng):
    x, mask = _inputs(rng)
    mod = jsep.DilatedFsmn(64, 64)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.DilatedFsmn(64, 64), params)
    with torch.no_grad():
        _close(port(_t(x), _t(mask)), _apply(mod, params, jnp.asarray(x), jnp.asarray(mask)),
               atol=1e-4)


def test_gated_fsmn_block(rng):
    x, mask = _inputs(rng)
    mod = jsep.GatedFsmnBlock(dim=64, inner=64)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.GatedFsmnBlock(64, inner=64), params)
    with torch.no_grad():
        _close(port(_t(x), _t(mask)), _apply(mod, params, jnp.asarray(x), jnp.asarray(mask)),
               atol=1e-4)


def test_mask_net(rng):
    x, mask = _inputs(rng)
    x = np.abs(x)  # encoder output is post-ReLU
    mod = jsep.MaskNet(dim=64, num_blocks=2, group_size=32, qk_dim=32, fsmn_inner=64)
    params = _init(mod, jnp.asarray(x), jnp.asarray(mask))
    port = _port(tsep.MaskNet(64, 64, num_blocks=2, group_size=32, qk_dim=32,
                              fsmn_inner=64), params)
    with torch.no_grad():
        got = port(_t(x), _t(mask)).numpy()
    want = _apply(mod, params, jnp.asarray(x), jnp.asarray(mask))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_decoder_flip(rng):
    """flax's ConvTranspose does not flip its kernel; the port's converted
    conv_transpose1d weight must give the same output."""
    import flax.linen as nn

    x = rng.standard_normal((2, 50, 64)).astype(np.float32)
    dec = nn.ConvTranspose(1, (16,), strides=(8,), padding="VALID", use_bias=False)
    params = _init(dec, jnp.asarray(x))
    want = _apply(dec, params, jnp.asarray(x))[..., 0]
    w = mossformer2_state_dict({"decoder": params["params"]})["decoder.weight"]
    got = torch.nn.functional.conv_transpose1d(_t(x).transpose(1, 2), w, stride=8)[:, 0]
    _close(got, want)


def _small_model():
    mod = jsep.MossFormer2(**SMALL)
    params = _init(mod, jnp.zeros((1, 16 * SMALL["group_size"])))
    port = tsep.MossFormer2(**SMALL)
    port.load_state_dict(mossformer2_state_dict(params), strict=True)
    return mod, params, port.eval()


def test_full_model(rng):
    mod, params, port = _small_model()
    wav = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    lengths = np.array([4000, 3100])
    want = _apply(mod, params, jnp.asarray(wav), jnp.asarray(lengths))
    with torch.no_grad():
        got = port(_t(wav), _t(lengths)).numpy()
    assert got.shape == want.shape == (2, 2, 4000)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def _two_voice_mix(seconds=2.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr

    def voice(f0, rate, phase):
        env = np.clip(np.sin(2 * np.pi * rate * t + phase), 0, None) ** 2
        tone = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
        return env * tone

    mix = 0.3 * voice(140.0, 3.0, 0.0) + 0.12 * voice(260.0, 4.1, 1.3)
    return (mix + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def _si_sdr(est, ref):
    est, ref = est - est.mean(), ref - ref.mean()
    proj = np.dot(est, ref) / max(np.dot(ref, ref), 1e-12) * ref
    return 10 * np.log10(np.dot(proj, proj) / max(np.dot(est - proj, est - proj), 1e-20))


@pytest.fixture(scope="module")
def engines():
    """The JAX and the ported SeparationEngine on checkpoints/sep-bootstrap."""
    from targetdiarization_tpu.models.separation import SeparationEngine as JEngine

    return (JEngine.from_pretrained("checkpoints/sep-bootstrap"),
            tsep.SeparationEngine.from_pretrained("checkpoints/sep-bootstrap", device="cpu"))


@pytest.mark.parametrize("seconds,sr", [(2.0, 16000), (1.0, 8000)])
def test_engine_separate_on_shipped_checkpoint(engines, seconds, sr):
    """SeparationEngine.separate on checkpoints/sep-bootstrap (256/12): the
    same stream order and >= 50 dB SI-SDR per stream against JAX, at the
    model's rate and through the resampler."""
    jax_engine, port_engine = engines
    mix = _two_voice_mix(seconds, sr=sr)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.separate(mix, sr=sr)
    got = port_engine.separate(mix, sr=sr)
    assert got.shape == want.shape == (2, mix.size)
    for s in range(2):
        assert _si_sdr(got[s], want[s]) >= 50.0


def test_engine_separate_batch_matches_separate(engines):
    engine = engines[1]
    clips = [_two_voice_mix(1.0, seed=1), _two_voice_mix(1.5, seed=2)[:20000]]
    batched = engine.separate_batch(clips)
    for clip, out in zip(clips, batched):
        alone = engine.separate(clip)
        assert out.shape == alone.shape == (2, clip.size)
        for s in range(2):
            assert _si_sdr(out[s], alone[s]) >= 50.0


def test_both_checkpoint_layouts_convert_alike():
    from targetdiarization_tpu.runtime.params import (
        load_checkpoint as jload, upgrade_scan_layout)
    from targetdiarization_tpu_torch.runtime.params import load_checkpoint

    legacy, _ = load_checkpoint("checkpoints/sep-bootstrap")
    assert "flash_0" in legacy["params"]["mask_net"]
    stacked, _ = jload("checkpoints/sep-bootstrap")
    stacked = upgrade_scan_layout("MossFormer2", stacked)
    assert "layers" in stacked["params"]["mask_net"]
    sd_legacy = mossformer2_state_dict(legacy)
    sd_stacked = mossformer2_state_dict(
        jax.tree_util.tree_map(np.asarray, stacked))
    assert sd_legacy.keys() == sd_stacked.keys()
    for k in sd_legacy:
        torch.testing.assert_close(sd_legacy[k], sd_stacked[k], rtol=0, atol=0)


def test_fp16_checkpoint_512_loads_and_converts():
    """The shipped 512/24 separator is stored in float16: it loads as
    float32 and fills every parameter of the port's model (no forward)."""
    import json

    from targetdiarization_tpu_torch.runtime.params import load_checkpoint

    raw = np.load("checkpoints/sep-bootstrap-512/params.npz")
    assert raw["params/encoder/kernel"].dtype == np.float16
    tree, meta = load_checkpoint("checkpoints/sep-bootstrap-512")
    with open("checkpoints/sep-bootstrap-512/model.json") as f:
        assert meta == json.load(f)
    sd = mossformer2_state_dict(tree)
    with torch.device("meta"):
        model = tsep.MossFormer2(**meta["model_args"])
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in sd.items():
        assert v.dtype == torch.float32 and v.shape == want[k].shape, k
    assert len(model.mask_net.layers) == 24


# ---------------- bf16 mode: the JAX package's types ----------------


def _bf16_engine(params):
    port = tsep.MossFormer2(**SMALL)
    port.load_state_dict(mossformer2_state_dict(params), strict=True)
    return tsep.SeparationEngine(port, device="cpu", compute_dtype="bfloat16")


def test_bf16_engine_computes_in_float32_after_position_add(rng):
    """In bf16 mode the encoder, in_norm and the bottleneck compute in bf16;
    every MossLayer and the decoder receive float32 and hold bf16-exact
    float32 weights (the JAX model's float32 position table promotes the
    stream); every FFConvM's kernel operands are float32 with no W_lo."""
    _, params, _ = _small_model()
    engine = _bf16_engine(params)
    model = engine.model
    net = model.mask_net
    seen = {}

    def hook(name):
        return lambda mod, args, out: seen.__setitem__(name, (args[0].dtype, out.dtype))

    handles = [layer.register_forward_hook(hook(f"layer{i}"))
               for i, layer in enumerate(net.layers)]
    handles += [model.decoder.register_forward_hook(hook("decoder")),
                net.bottleneck.register_forward_hook(hook("bottleneck"))]
    wav = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    est = engine._dispatch(wav, np.array([4000, 3100]))
    for h in handles:
        h.remove()
    assert est.dtype == np.float32 and np.isfinite(est).all()
    assert seen["bottleneck"] == (torch.bfloat16, torch.bfloat16)
    for name in [f"layer{i}" for i in range(len(net.layers))] + ["decoder"]:
        assert seen[name] == (torch.float32, torch.float32), (name, seen[name])
    for mod in (model.encoder, net.in_norm, net.bottleneck):
        assert all(p.dtype == torch.bfloat16 for p in mod.parameters())
    later = [p for m in (net.layers, net.out_ln, net.intra_norm, net.spk_expand, net.out_tanh,
                         net.out_sig, net.mask_proj, model.decoder) for p in m.parameters()]
    later.append(net.prelu)
    for p in later:
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, p.bfloat16().float(), rtol=0, atol=0)
    ops = [m.kernel_ops for m in net.layers.modules() if isinstance(m, tsep.FFConvM)]
    assert len(ops) == 5 * len(net.layers)
    assert all(o.dtype == torch.float32 and o.w_lo is None for o in ops)
    # the estimate leaves the engine rounded to bf16, in float32
    np.testing.assert_array_equal(est, torch.from_numpy(est).bfloat16().float().numpy())


def test_bf16_engine_matches_jax_bf16_mode(rng):
    """A 2-layer MossFormer2 in bf16 mode against the JAX package's bf16
    mode (params cast to bf16, input cast to bf16, estimate rounded to bf16,
    as its SeparationEngine does) on the same params and input. Both round
    the estimate to bf16, so a float32 difference in the last bits can flip
    one rounding by one bf16 step: up to 2^-8 of the largest value, within
    the 4e-3 max limit; the mean difference bounds everything else."""
    from targetdiarization_tpu.runtime.precision import cast_params

    mod, params, _ = _small_model()
    wav = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    lengths = np.array([4000, 3100])
    bf = jnp.bfloat16
    with jax.default_matmul_precision("highest"):
        want = jax.jit(mod.apply)(cast_params(params, bf), jnp.asarray(wav, bf),
                                  jnp.asarray(lengths))
    want = np.asarray(want.astype(bf).astype(jnp.float32))
    got = _bf16_engine(params)._dispatch(wav, lengths)
    assert got.shape == want.shape == (2, 2, 4000)
    diff = np.abs(got - want)
    assert diff.max() <= 4e-3 * np.abs(want).max()
    assert diff.mean() <= 1e-4 * np.abs(want).mean()
