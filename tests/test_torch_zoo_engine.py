"""The port's `SeparationEngine` with the zoo's separators, against the JAX
engine, and the registry and kernel limits the zoo relies on.

- `window=` moves the ladder: the rungs of 32k/64k/96k below the window,
  then the window;
- pad-safe classes (MossFormer, ConvTasNet, DPRNNTasNet, SkiMNet): a
  bucket-padded forward equals the exact-length one within the JAX
  package's recorded `PADDED_BUCKET_DEVIATION`, plus 1e-5 of the peak for
  float32 rounding;
- `separate` and `separate_batch` of TFGridNet (not pad-safe: exact
  lengths, clip by clip, full windows plus an exact remainder) and
  DPRNNTasNet (pad-safe: ladder rungs) equal the JAX engine's outputs
  within 1e-4 of their peak, both engines in float32 on the CPU;
- every `DepthwiseConv1d` a ported model reaches at its class defaults is
  a (K, m, C, dilation) that the card's kernel takes.
"""

import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import zoo as jzoo
from targetdiarization_tpu_torch.models import zoo as tzoo
from targetdiarization_tpu_torch.models.separation import SeparationEngine
from torch_zoo_cases import TINY, seeded_params, port_forward, port_model

PAD_SAFE = ["ConvTasNet", "DPRNNTasNet", "MossFormer", "SkiMNet"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(name, seed=0):
    module = getattr(jzoo, name)(**TINY[name])
    wav = (np.random.default_rng(seed).standard_normal((1, 2000)) * 0.1).astype(np.float32)
    params = seeded_params(module, wav, seed)
    return module, params


def test_registry_returns_every_zoo_class():
    from targetdiarization_tpu.runtime.registry import list_models
    from targetdiarization_tpu_torch.runtime.convert import ZOO_NAMES
    from targetdiarization_tpu_torch.runtime.registry import get_model_cls

    # the converters' names (convert.py imports no model) are the classes'
    assert ZOO_NAMES == tuple(tzoo.CLASSES)
    for name in TINY:
        assert name in list_models()
        assert get_model_cls(name) is getattr(tzoo, name)


def test_pad_safety_table_is_the_jax_packages():
    assert tzoo.PADDED_BUCKET_DEVIATION == jzoo.PADDED_BUCKET_DEVIATION
    assert tzoo.PAD_SAFE_THRESHOLD == jzoo.PAD_SAFE_THRESHOLD
    for name in TINY:
        assert tzoo.pad_safe(getattr(tzoo, name)(**TINY[name])) == \
            jzoo.pad_safe(getattr(jzoo, name)(**TINY[name])), name
    assert sorted(n for n in TINY if tzoo.pad_safe(getattr(tzoo, n)(**TINY[n]))) == PAD_SAFE

    class Unknown:
        pass

    assert not tzoo.pad_safe(Unknown())


@pytest.mark.parametrize("window,rungs", [(None, (32_000, 64_000, 96_000, 160_000)),
                                          (64_000, (32_000, 64_000)),
                                          (100_000, (32_000, 64_000, 96_000, 100_000)),
                                          (20_000, (20_000,))])
def test_window_moves_the_ladder(window, rungs):
    model = tzoo.ConvTasNet(**TINY["ConvTasNet"])
    eng = SeparationEngine(model, device="cpu", compute_dtype="float32", window=window)
    assert eng.ladder.rungs == rungs and eng.window == rungs[-1]
    shapes = []
    forward = eng._forward
    eng._forward = lambda b, l: shapes.append((b.shape, list(l))) or forward(b, l)
    n = rungs[-1] + 5000
    out = eng.separate(np.zeros(n, np.float32) + 0.01, sr=16000)
    assert out.shape == (2, n)
    assert shapes == [((2, rungs[-1]), [rungs[-1], 5000])]


@pytest.mark.parametrize("name", PAD_SAFE)
def test_bucket_padded_forward_matches_exact(name):
    module, params = _case(name)
    model = port_model(name, params)
    wav = (np.random.default_rng(3).standard_normal((2, 2000)) * 0.1).astype(np.float32)
    exact = port_forward(model, wav)
    padded = port_forward(model, np.pad(wav, ((0, 0), (0, 1200))), [2000, 2000])[..., :2000]
    rel = np.abs(padded - exact).max() / np.abs(exact).max()
    assert rel <= jzoo.PADDED_BUCKET_DEVIATION[name] + 1e-5, (name, rel)


def _engines(name, window):
    from targetdiarization_tpu.models.separation import SeparationEngine as JaxEngine

    module, params = _case(name, seed=4)
    theirs = JaxEngine(params=params, model=module, window=window, compute_dtype="float32")
    ours = SeparationEngine(port_model(name, params), device="cpu", compute_dtype="float32",
                            window=window)
    return ours, theirs


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", ["TFGridNet", "DPRNNTasNet"])
def test_engine_matches_jax_engine(name):
    import jax

    window = 4000
    ours, theirs = _engines(name, window)
    rng = np.random.default_rng(5)
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (1500, 3100, 9000)]
    shapes = []
    forward = ours._forward
    ours._forward = lambda b, l: shapes.append((b.shape[1], list(l))) or forward(b, l)
    with jax.default_matmul_precision("highest"):
        want = [theirs.separate(c) for c in clips] + theirs.separate_batch(clips[:2])
    got = [ours.separate(c) for c in clips] + ours.separate_batch(clips[:2])
    for g, w in zip(got, want):
        _close(g, w)
    if name == "TFGridNet":  # exact lengths; 9000 = two windows + 1000
        assert shapes == [(1500, [1500]), (3100, [3100]), (4000, [4000, 4000]),
                          (1000, [1000]), (1500, [1500]), (3100, [3100])]
    else:  # ladder rungs (the window is the only one), one batched forward a
        # call, its rows padded to a row rung with rows of length 1
        assert shapes == [(4000, [1500]), (4000, [3100]), (4000, [4000, 4000, 1000, 1]),
                          (4000, [1500, 3100])]


def test_dwconv_kernel_takes_every_conv_of_the_ported_models():
    """Every depthwise conv that a ported model reaches at its class
    defaults (the separator's FSMN memories, the SAN-M memories of
    Paraformer and SenseVoice, Apollo's, the VAD's, ConvTasNet's at
    dilations 1 to 128) is a (K, m, C*m, dilation) the kernel takes in
    float32 and bf16: a shape that the CPU's plain version takes and the
    card would refuse cannot come back unseen."""
    from targetdiarization_tpu_torch.models.asr import Paraformer, SANMAttention, SenseVoice
    from targetdiarization_tpu_torch.models.restoration import Apollo, DepthwiseConv1d
    from targetdiarization_tpu_torch.models.separation import (DilatedDenseFsmnNet, FFConvM,
                                                               MossFormer2)
    from targetdiarization_tpu_torch.models.vad import FsmnBlock, FsmnVADNet
    from targetdiarization_tpu_torch.ops.kernels import dwconv as dwmod

    def convs(module):
        if isinstance(module, DilatedDenseFsmnNet):
            return [(k.shape, 2 ** i) for i, k in enumerate(module.conv_kernels)]
        if isinstance(module, DepthwiseConv1d):
            return [(module.kernel.shape, module.dilation)]
        if isinstance(module, FsmnBlock):
            return [(module.memory.shape, module.dilation)]
        if isinstance(module, SANMAttention) and module.fsmn is not None:
            return [(module.fsmn.shape, 1)]
        return []

    with torch.device("meta"):
        models = {"MossFormer2": MossFormer2(), "Paraformer": Paraformer(),
                  "SenseVoice": SenseVoice(), "Apollo": Apollo(), "FsmnVADNet": FsmnVADNet(),
                  "ConvTasNet": tzoo.ConvTasNet()}
    shapes = {}
    for name, model in models.items():
        for m in model.modules():
            # every module that makes kernel operands is an FFConvM, a SAN-M
            # attention without memory (the decoder's cross-attention), or is seen here
            assert not hasattr(m, "prepare_kernel") or isinstance(m, FFConvM) or convs(m) \
                or (isinstance(m, SANMAttention) and m.fsmn is None), m
            for (k, mm, c), d in convs(m):
                shapes.setdefault(name, set()).add((k, mm, c, d))
    assert set(shapes) == set(models)
    assert {d for *_, d in shapes["ConvTasNet"]} == {1, 2, 4, 8, 16, 32, 64, 128}
    for name, found in shapes.items():
        for k, m, c, d in sorted(found):
            for dtype in (torch.float32, torch.bfloat16):
                # the wrapper's predicate: `prepare_taps`' kernel_ok and max_dilation
                assert dwmod._kernel_takes(m, c * m, dtype) \
                    and 1 <= d <= dwmod.max_dilation(k), (name, k, m, c, d, dtype)


def test_tdanet_pools_the_lengths_the_jax_package_refuses():
    """At TDANet's class-default encoder (21 ms windows, four pyramid
    levels) the coarsest level divides almost no other: the JAX package's
    pooling takes only exact multiples and raises there (1.5 s gives
    294 -> 37). The port's is torch's adaptive pooling, the reference
    model's, and equals the JAX package's where that runs."""
    import jax.numpy as jnp
    import torch.nn.functional as F

    x = torch.randn(2, 296, 5, generator=torch.Generator().manual_seed(0))
    exact = tzoo._adaptive_avg_pool(x, 37)
    np.testing.assert_allclose(exact.numpy(), np.asarray(jzoo._adaptive_avg_pool(
        jnp.asarray(x.numpy()), 37)), rtol=1e-6, atol=1e-7)
    got = tzoo._adaptive_avg_pool(x[:, :294], 37)
    want = F.adaptive_avg_pool1d(x[:, :294].transpose(1, 2), 37).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="not exact"):
        jzoo._adaptive_avg_pool(jnp.asarray(x[:, :294].numpy()), 37)
    model = tzoo.TDANet(out_channels=8, in_channels=16, num_blocks=1).eval()
    with torch.inference_mode():
        y = model(torch.randn(1, 24000) * 0.1, torch.tensor([24000]))
    assert y.shape == (1, 2, 24000) and torch.isfinite(y).all()
