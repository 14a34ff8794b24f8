"""Both packages' streaming systems for the CPU tests of the port's
streaming and serving (`test_torch_streaming.py`,
`test_torch_streaming_bf16.py`, `test_torch_server.py`,
`test_torch_target_asr.py` import them from here), and the test that the
shared small separator is one network in both packages.

`stream_systems()` builds each package's model as its server does
(`build_model()` on the CPU, float32 unless asked for bf16: the shipped
VAD, ASR, punctuation, speaker, segmentation, denoiser, Apollo, enhancer
and emotion checkpoints) and gives both the
same small random separator (one flax init carried into the port by
`runtime/convert.py`) in place of the 256/12 checkpoint, whose CPU
forwards would take most of the suite's time (every flush runs it once in
stream mode, an overlap flush twice). The JAX server's persistent
compilation cache is left off, so that a test writes nothing outside the
repository.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from targetdiarization_tpu.models import separation as jsep
from targetdiarization_tpu.runtime.config import env_config as jax_env_config
from targetdiarization_tpu.serve import server as jserver
from targetdiarization_tpu_torch.models import separation as tsep
from targetdiarization_tpu_torch.runtime.convert import mossformer2_state_dict
from targetdiarization_tpu_torch.serve import server as tserver

SEP = dict(dim=64, enc_channels=64, num_blocks=2, group_size=32, qk_dim=32, fsmn_inner=64)


def small_separators(seed: int = 1, dtype: str = "float32"):
    """(port engine, JAX engine) of one small random MossFormer2, both
    computing in `dtype`."""
    with jax.default_matmul_precision("highest"):
        sep_mod = jsep.MossFormer2(**SEP)
        sep_p = jax.jit(sep_mod.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 1024)))
    sep = tsep.MossFormer2(**SEP)
    sep.load_state_dict(mossformer2_state_dict(sep_p), strict=True)
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}):
        theirs = jsep.SeparationEngine(params=sep_p, model=sep_mod)
    return tsep.SeparationEngine(sep.eval(), device="cpu", compute_dtype=dtype), theirs


def stream_systems(dtype: str = "float32"):
    """(port model, JAX model): each server's `build_model()` on the CPU with
    every engine computing in `dtype` (the JAX engines made under
    TD_COMPUTE_DTYPE), both with the small separator."""
    with mock.patch.dict(os.environ, {"TD_COMPUTE_DTYPE": dtype}), \
            mock.patch("targetdiarization_tpu.runtime.compile_cache.enable_persistent_cache",
                       lambda *a, **k: None):
        ours = tserver.build_model(device="cpu")
        theirs = jserver.build_model(jax_env_config())
    ours.ap.separator, theirs.ap.separator = small_separators(dtype=dtype)
    return ours, theirs


def test_small_separators_agree():
    """The port's engine and the JAX engine of `small_separators()` give the
    same sources on a 1 s mix, within 1e-4 of the peak (float32, the JAX
    side at full matmul precision)."""
    ours, theirs = small_separators()
    mix = np.random.default_rng(3).standard_normal(16000).astype(np.float32) * 0.1
    with jax.default_matmul_precision("highest"):
        want = np.asarray(theirs.separate(mix))
    got = ours.separate(mix)
    assert got.shape == want.shape == (2, 16000)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
