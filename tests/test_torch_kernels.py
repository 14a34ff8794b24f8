"""The port's kernel modules on the CPU against the JAX package's kernels.

On a CPU tensor each wrapper runs its plain PyTorch version; the JAX side
runs both its jnp reference and its Pallas kernel in interpret mode (as
tests/test_pallas.py runs them). The CUDA kernels themselves are checked
against the same plain versions on the card by chip_smoke.py.
"""

import ctypes
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.ops.dwconv import dw_conv1d as jax_dw_conv1d
from targetdiarization_tpu.ops.pallas.dwconv import dw_conv1d_pallas
from targetdiarization_tpu.ops.pallas.ffconvm import ffconvm_fused, ffconvm_reference
from targetdiarization_tpu.ops.pallas.flash import (
    flash_gated_attention, flash_gated_attention_reference, flash_group_attention as
    jax_flash_group_attention, flash_group_attention_reference)
from targetdiarization_tpu_torch.ops.dwconv import dw_conv1d
from targetdiarization_tpu_torch.ops.kernels import _build
from targetdiarization_tpu_torch.ops.kernels import dwconv as dwmod
from targetdiarization_tpu_torch.ops.kernels import ffconvm as ffmod
from targetdiarization_tpu_torch.ops.kernels import flash as flmod
from targetdiarization_tpu_torch.ops.kernels.dwconv import dwconv
from targetdiarization_tpu_torch.ops.kernels.ffconvm import ffconvm
from targetdiarization_tpu_torch.ops.kernels.flash import flash_gated, flash_group_attention

RTOL, ATOL = 1e-4, 1e-5


def _ff_inputs(rng, b, t, cin, cout, norm):
    x = (rng.standard_normal((b, t, cin)) * 0.3).astype(np.float32)
    x[0, 5:9] = 0.0  # in-array silent rows still add silu(bias) to the conv
    if norm == "scalenorm":
        na, nb = np.array([1.3], np.float32), np.zeros(1, np.float32)
    else:
        na = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
        nb = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    wk = (rng.standard_normal((cin, cout)) * 0.05).astype(np.float32)
    wb = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    dwk = (rng.standard_normal((17, 1, cout)) * 0.2).astype(np.float32)
    return x, na, nb, wk, wb, dwk


def _port_ffconvm(x, na, nb, wk, wb, dwk, norm):
    t = torch.from_numpy
    return ffconvm(t(x), t(na), t(nb), t(np.ascontiguousarray(wk.T)), t(wb), t(dwk),
                   norm).numpy()


@pytest.mark.parametrize("norm", ["scalenorm", "layernorm"])
@pytest.mark.parametrize("b,t,cin,cout", [(2, 300, 128, 256), (1, 1111, 128, 2048)])
def test_ffconvm_matches_jax_reference(norm, b, t, cin, cout, rng):
    """Both norms; T=1111 spans several tiles with a ragged tail; cout up
    to 2048; the edge rows take the array's zero padding."""
    args = _ff_inputs(rng, b, t, cin, cout, norm)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(ffconvm_reference(*map(jnp.asarray, args), norm=norm))
    got = _port_ffconvm(*args, norm)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, :20], want[:, :20], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, -20:], want[:, -20:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["scalenorm", "layernorm"])
def test_ffconvm_matches_jax_kernel_interpret(norm, rng):
    args = _ff_inputs(rng, 1, 1111, 128, 2048 if norm == "scalenorm" else 256, norm)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(ffconvm_fused(*map(jnp.asarray, args), norm=norm, use_pallas=True))
    np.testing.assert_allclose(_port_ffconvm(*args, norm), want, rtol=RTOL, atol=ATOL)


def test_ffconvm_keeps_bf16_semantics(rng):
    """In bf16 the normalised row is rounded before the product and h stays
    float32 through the conv; the output is bf16."""
    x, na, nb, wk, wb, dwk = _ff_inputs(rng, 1, 64, 128, 128, "scalenorm")
    bf = torch.bfloat16
    got = ffconvm(torch.from_numpy(x).to(bf), torch.from_numpy(na).to(bf),
                  torch.from_numpy(nb).to(bf), torch.from_numpy(wk.T.copy()).to(bf),
                  torch.from_numpy(wb).to(bf), torch.from_numpy(dwk).to(bf))
    assert got.dtype == bf
    with jax.default_matmul_precision("highest"):
        want = ffconvm_fused(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (x, na, nb, wk, wb, dwk)), use_pallas=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def _gated_inputs(rng, b, n_groups, g, d, e, masked_cols=0):
    f = np.float32
    q, k, lq = (rng.standard_normal((b, n_groups, g, d)).astype(f) for _ in range(3))
    v, u = (rng.standard_normal((b, n_groups, g, e)).astype(f) for _ in range(2))
    kv, ku = ((rng.standard_normal((b, d, e)) * 0.1).astype(f) for _ in range(2))
    mask = np.ones((b, n_groups, 1, g), f)
    if masked_cols:
        mask[:, -1, :, g - masked_cols:] = 0.0
    return q, k, v, u, mask, lq, kv, ku


@pytest.mark.parametrize("shape,masked", [((1, 2, 32, 16, 64), 0), ((2, 3, 64, 32, 128), 0),
                                          ((2, 2, 32, 16, 32), 16), ((1, 3, 64, 32, 96), 7)])
def test_flash_gated_matches_jax(shape, masked, rng):
    args = _gated_inputs(rng, *shape, masked_cols=masked)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(flash_gated_attention_reference(*map(jnp.asarray, args)))
        interp = np.asarray(flash_gated_attention(*map(jnp.asarray, args), use_pallas=True))
    got = flash_gated(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, interp, rtol=RTOL, atol=ATOL)


def test_flash_gated_masked_keys_do_not_leak(rng):
    """Changing V in masked key rows changes no unmasked query row."""
    args = list(_gated_inputs(rng, 1, 2, 32, 16, 32, masked_cols=16))
    args[4][:] = 1.0
    args[4][..., 16:] = 0.0
    got = flash_gated(*map(torch.from_numpy, args)).numpy()
    v2 = args[2].copy()
    v2[..., 16:, :] = 99.0
    args[2] = v2
    got2 = flash_gated(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got[..., :16, :], got2[..., :16, :], atol=1e-5)


@pytest.mark.parametrize("shape,k,m,dil", [
    ((2, 100, 64), 3, 1, 1),
    ((1, 257, 32), 39, 1, 1),
    ((1, 200, 64), 3, 1, 8),
    ((1, 64, 96), 5, 3, 2),
    ((2, 150, 64), 39, 2, 2),  # the FSMN's conv1 form: 39 taps, m 2, dilation 2
])
def test_dw_conv1d_matches_jax(shape, k, m, dil, rng):
    c = shape[-1] // m
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, m, c)) * 0.3).astype(np.float32)
    span = (k - 1) * dil
    for pad in ("SAME", (span // 2, span - span // 2), (span, 0)):
        want = np.asarray(jax_dw_conv1d(jnp.asarray(x), jnp.asarray(w), dilation=dil,
                                        padding=pad))
        got = dw_conv1d(torch.from_numpy(x), torch.from_numpy(w), dilation=dil,
                        padding=pad).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_dw_conv1d_unbatched(rng):
    x = rng.standard_normal((80, 32)).astype(np.float32)
    w = (rng.standard_normal((17, 1, 32)) * 0.3).astype(np.float32)
    want = np.asarray(jax_dw_conv1d(jnp.asarray(x), jnp.asarray(w)))
    got = dw_conv1d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrappers_count_only_kernel_launches(rng):
    """On the CPU the wrappers run the plain versions, so no launch counts."""
    before = (ffconvm.launches, flash_gated.launches)
    _port_ffconvm(*_ff_inputs(rng, 1, 40, 32, 64, "scalenorm"), "scalenorm")
    flash_gated(*map(torch.from_numpy, _gated_inputs(rng, 1, 1, 16, 8, 16)))
    assert (ffconvm.launches, flash_gated.launches) == before


def test_kernel_wrappers_reject_bad_cuda_inputs():
    """The CUDA branch validates before it builds or launches anything."""
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="dwk"):
        ffmod._check(x, torch.zeros(64, 32), torch.zeros(9, 1, 64), "scalenorm")
    with pytest.raises(ValueError, match="norm"):
        ffmod._check(x, torch.zeros(64, 32), torch.zeros(17, 1, 64), "rmsnorm")
    with pytest.raises(TypeError):
        ffmod._check(x.half(), torch.zeros(64, 32).half(), torch.zeros(17, 1, 64), "scalenorm")
    q = torch.zeros(1, 2, 16, 8)
    v = torch.zeros(1, 2, 16, 24)
    with pytest.raises(ValueError, match="mask"):
        flmod._check(q, q, v, v, torch.zeros(1, 2, 16, 1), q, torch.zeros(1, 8, 24),
                     torch.zeros(1, 8, 24))


@pytest.mark.parametrize("shape,k,m,dil,pads", [
    ((1, 300, 128), 7, 1, 1, None),     # tests/test_pallas.py's cases
    ((1, 513, 128), 3, 1, 4, None),
    ((2, 128, 256), 9, 2, 1, None),
    ((2, 700, 64), 13, 1, 1, (10, 2)),  # the VAD memory: explicit pads at C 64
    ((1, 333, 512), 39, 2, 2, None),    # the separator's conv1: 39 taps, m 2, d 2
    ((2, 1000, 256), 11, 1, 1, None),   # the SAN-M memory; T a multiple of no tile
])
def test_dw_conv1d_matches_pallas_kernel_interpret(shape, k, m, dil, pads, rng):
    c = shape[-1] // m
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, m, c)) * 0.3).astype(np.float32)
    span = (k - 1) * dil
    pad_l, pad_r = pads or (span // 2, span - span // 2)
    want = np.asarray(dw_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), dil, pad_l, pad_r))
    got = dw_conv1d(torch.from_numpy(x), torch.from_numpy(w), dil, (pad_l, pad_r)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _group_inputs(rng, b, n_groups, g, d, e, masked_cols=0):
    q, k, v, u, mask, *_ = _gated_inputs(rng, b, n_groups, g, d, e, masked_cols)
    return q, k, v, u, mask


@pytest.mark.parametrize("shape,masked", [((1, 2, 32, 16, 64), 0), ((2, 3, 64, 32, 128), 0),
                                          ((1, 1, 32, 16, 32), 16), ((2, 2, 64, 32, 96), 7)])
def test_flash_group_matches_jax(shape, masked, rng):
    args = _group_inputs(rng, *shape, masked_cols=masked)
    with jax.default_matmul_precision("highest"):
        ref = flash_group_attention_reference(*map(jnp.asarray, args))
        interp = jax_flash_group_attention(*map(jnp.asarray, args), use_pallas=True)
    got = flash_group_attention(*map(torch.from_numpy, args))
    for g_, r_, i_ in zip(got, ref, interp):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r_), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_.numpy(), np.asarray(i_), rtol=RTOL, atol=ATOL)


def test_flash_group_masked_keys_do_not_leak(rng):
    args = list(_group_inputs(rng, 1, 1, 32, 16, 32, masked_cols=16))
    out_v, out_u = flash_group_attention(*map(torch.from_numpy, args))
    args[2] = args[2].copy()
    args[2][..., 16:, :] = 99.0
    out_v2, out_u2 = flash_group_attention(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out_v.numpy(), out_v2.numpy(), atol=1e-5)
    np.testing.assert_allclose(out_u.numpy(), out_u2.numpy(), atol=1e-5)


def test_flash_group_keeps_bf16_semantics(rng):
    """A is rounded to bf16 before the products; both outputs are bf16."""
    args = _group_inputs(rng, 1, 2, 32, 16, 64)
    bf = torch.bfloat16
    got = flash_group_attention(*(torch.from_numpy(a).to(bf) for a in args))
    assert all(o.dtype == bf for o in got)
    want = jax_flash_group_attention(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                                     use_pallas=True)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.float().numpy(), np.asarray(w_, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_new_wrappers_count_only_kernel_launches(rng):
    """dwconv and flash_group on CPU tensors run their plain versions: no launch counts."""
    before = (dwconv.launches, flash_group_attention.launches)
    dw_conv1d(torch.zeros(1, 40, 64), torch.zeros(13, 1, 64), padding=(10, 2))
    flash_group_attention(*map(torch.from_numpy, _group_inputs(rng, 1, 1, 16, 8, 16)))
    assert (dwconv.launches, flash_group_attention.launches) == before


def test_dwconv_wrapper_rejects_bad_cuda_inputs():
    """The CUDA branch validates before it builds or launches anything."""
    x = torch.zeros(2, 50, 64)
    assert dwmod._check(x, torch.zeros(13, 1, 64), 1, 10, 2) == 50
    assert dwmod._check(torch.zeros(1, 50, 512), torch.zeros(39, 2, 256), 2, 38, 38) == 50
    with pytest.raises(ValueError, match="channels"):
        dwmod._check(x, torch.zeros(13, 2, 64), 1, 6, 6)
    with pytest.raises(ValueError, match="contiguous"):
        dwmod._check(x.transpose(0, 1), torch.zeros(13, 1, 64), 1, 6, 6)
    with pytest.raises(TypeError):
        dwmod._check(x.half(), torch.zeros(13, 1, 64), 1, 6, 6)
    with pytest.raises(ValueError, match="shared memory"):
        dwmod._check(torch.zeros(1, 5000, 256), torch.zeros(513, 1, 256), 8, 2048, 2048)
    with pytest.raises(ValueError, match="no output rows"):
        dwmod._check(torch.zeros(1, 5, 64), torch.zeros(13, 1, 64), 1, 0, 0)
    q = torch.zeros(1, 2, 16, 8)
    v = torch.zeros(1, 2, 16, 24)
    with pytest.raises(ValueError, match="u must be"):
        flmod._check(q, q, v, torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 1, 16))


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def test_ctypes_signatures_match_cuda_sources():
    """Every extern "C" entry point of csrc/ is declared to ctypes with the
    same argument count and types (pointers as c_void_p)."""
    found = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            for name, params in re.findall(r'extern "C" int (td_\w+)\(([^)]*)\)', f.read()):
                found[name] = [ctypes.c_void_p if "*" in p else _C_TYPES[p.split()[-2]]
                               for p in params.split(",")]
    assert set(found) == {"td_ffconvm", "td_flash_gated", "td_flash_group", "td_dwconv"}
    assert found == _build.SIGNATURES
