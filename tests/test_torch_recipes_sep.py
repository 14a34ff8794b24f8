"""`bootstrap_separator` against the JAX recipe on the CPU, and the gated
FLASH at the recipe's default separator shape (g 64, d 32, e 128, which
the card's kernel now takes) against the JAX kernel in interpret mode.

The separator is the JAX test's small MossFormer2, 2 steps of 2 x 0.1 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.separation import MossFormer2 as JaxMossFormer2
from targetdiarization_tpu.ops.pallas.flash import _gated_fused
from targetdiarization_tpu.parallel.mesh import replicated
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import SeparationTrainer as JaxTrainer
from targetdiarization_tpu_torch.models.separation import MossFormer2
from targetdiarization_tpu_torch.ops.kernels import flash as flmod
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

SEP = dict(dim=16, enc_channels=16, num_blocks=1, group_size=32, qk_dim=16, kernel_size=8,
           fsmn_inner=8)  # tests/test_recipes.py's MossFormer2
SEP_SIZE = dict(steps=2, batch=2, seconds=0.1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


def _replicated_init(orig):
    """The JAX trainer's constructor, its state then placed as its step's
    jit places it (replicated), so that the step compiles once, not again
    for the second step's committed state (as tests/test_torch_train.py)."""
    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.state = jax.device_put(self.state, replicated(self.mesh))

    return init


@pytest.fixture(scope="module")
def sep_run(assets, tmp_path_factory):
    torch.set_num_threads(2)
    patch = (JaxTrainer, "__init__", _replicated_init(JaxTrainer.__init__))
    return cases.run_both(str(tmp_path_factory.mktemp("sep")), assets, "bootstrap_separator",
                          {**SEP_SIZE, "model": JaxMossFormer2(**SEP)},
                          {**SEP_SIZE, "model": MossFormer2(**SEP)}, jax_cls=JaxMossFormer2,
                          patches=(patch,))


def test_separator_steps_match_jax(sep_run):
    cases.check_logs_and_losses(sep_run, SEP_SIZE["steps"])
    cases.check_saved_params(sep_run, "MossFormer2")


def test_separator_metrics_and_export_match_jax(sep_run):
    """The held-out best-permutation SI-SNRi within 1e-3 dB; each export's
    forward the same in the other package's registry."""
    cases.check_metrics(sep_run, {"eval_si_snr_i": 1e-3})
    wav = (np.random.default_rng(7).standard_normal((2, 1600)) * 0.3).astype(np.float32)
    apply = None
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(sep_run[who]["path"])
        apply = apply or jax.jit(model.apply)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(apply(params, jnp.asarray(wav)))
        with torch.no_grad():
            got = from_pretrained(sep_run[who]["path"])(torch.from_numpy(wav)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


def test_flash_widened_shape_matches_jax_kernel_interpret():
    """g 64, d 32, e 128, the recipe's default separator's FLASH shape:
    the plain version (the CPU branch of the kernel's wrapper) against the
    JAX kernel in interpret mode and its reference, and the wrapper's
    check takes it."""
    from targetdiarization_tpu.ops.pallas.flash import flash_gated_attention_reference

    rng = np.random.default_rng(3)
    b, n_groups, g, d, e = 2, 3, 64, 32, 128
    q, k, lq = (rng.standard_normal((b, n_groups, g, d)).astype(np.float32) for _ in range(3))
    v, u = (rng.standard_normal((b, n_groups, g, e)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, n_groups, 1, g), np.float32)
    mask[:, -1, :, 40:] = 0
    kv, ku = (rng.standard_normal((b, d, e)).astype(np.float32) * 0.1 for _ in range(2))
    args = (q, k, v, u, mask, lq, kv, ku)
    with jax.default_matmul_precision("highest"):
        interp = np.asarray(_gated_fused(*map(jnp.asarray, args)))
        ref = np.asarray(flash_gated_attention_reference(*map(jnp.asarray, args)))
    got = flmod.flash_gated_plain(*map(torch.from_numpy, args)).numpy()
    assert _rel(got, interp) <= 1e-5 and _rel(got, ref) <= 1e-5
    assert flmod.in_range(g, d, e)
    flmod._check(*map(torch.from_numpy, args))


@pytest.mark.parametrize("config", ["sep", None])
def test_chip_smoke_holds_the_recipe_separators_kernel_shapes(config):
    """Each FFConvM and gated FLASH call of the recipes phase's separators
    (sep-bootstrap's 256/12 and the recipe's default 64/4) on 1 s has a row
    at its shape in chip_smoke.py's kernel tables, and every FLASH_RANGE
    shape is one the kernels take."""
    from unittest import mock

    import chip_smoke
    from targetdiarization_tpu_torch.models import separation

    args = chip_smoke.RECIPE_MODELS[config] if config else chip_smoke.RECIPE_SEP_DEFAULT
    ffconvm_calls, flash_calls = set(), set()
    ffconvm, flash_gated = separation.ffconvm, separation.flash_gated

    def ffconvm_probe(x, na, nb, w, *rest, **kw):
        ffconvm_calls.add((x.shape[1], w.shape[1], w.shape[0], rest[2]))
        return ffconvm(x, na, nb, w, *rest, **kw)

    def flash_probe(q, k, v, *rest):
        flash_calls.add((*q.shape[1:], v.shape[-1]))
        return flash_gated(q, k, v, *rest)

    torch.manual_seed(0)
    model = MossFormer2(**args).eval()
    with mock.patch.object(separation, "ffconvm", ffconvm_probe), \
            mock.patch.object(separation, "flash_gated", flash_probe), torch.no_grad():
        model(torch.randn(1, 16000))
    label = "256/12" if config else "64/4"
    rows = {(t, cin, cout, norm) for name, b, t, cin, cout, norm, _ in chip_smoke.FFCONVM_SHAPES
            if name.startswith(f"recipe {label} ") and b == 8}
    assert ffconvm_calls == rows and len(rows) == 4
    flash_rows = {(n, g, d, e) for _, b, n, g, d, e, _ in chip_smoke.FLASH_SHAPES if b == 8}
    assert flash_calls and flash_calls <= flash_rows
    assert all(flmod.in_range(g, d, e) for _, g, d, e in chip_smoke.FLASH_RANGE)
