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

torch.set_num_threads(2)  # beside the other test workers' threads

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
    """The CUDA branch validates before it builds or launches anything: FFConvM's
    weights when its operands are made, x against them at every call."""
    g, z = torch.ones(1), torch.zeros(1)
    with pytest.raises(ValueError, match="dwk"):
        ffmod.prepare_ffconvm(g, z, torch.zeros(64, 32), torch.zeros(64), torch.zeros(9, 1, 64),
                              "scalenorm", torch.float32)
    with pytest.raises(ValueError, match="norm"):
        ffmod.prepare_ffconvm(g, z, torch.zeros(64, 32), torch.zeros(64),
                              torch.zeros(17, 1, 64), "rmsnorm", torch.float32)
    with pytest.raises(TypeError):
        ffmod.prepare_ffconvm(g, z, torch.zeros(64, 32), torch.zeros(64),
                              torch.zeros(17, 1, 64), "scalenorm", torch.float16)
    with pytest.raises(ValueError, match="prepare_ffconvm"):
        ffmod._check_prepared(torch.zeros(1, 8, 32), None, "scalenorm")
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


# ---------------- FFConvM's prepared operands and float32 split ----------------


@pytest.mark.parametrize("scale", [1e-3, 0.05, 30.0])
def test_split_bf16_reconstructs_float32(scale, rng):
    """W_hi + W_lo gives W within 2^-16 relative; W_lo is exactly zero when W
    is bf16-exact (the main path's weights), so that pass is skipped."""
    w = torch.from_numpy((rng.standard_normal((96, 64)) * scale).astype(np.float32))
    hi, lo = ffmod.split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - w.double()).abs()
    assert (err <= 2.0 ** -16 * w.double().abs()).all()
    hi2, lo2 = ffmod.split_bf16(w.bfloat16().float())
    assert not lo2.any()
    torch.testing.assert_close(hi2, w.bfloat16(), rtol=0, atol=0)


def _emulate_kernel_product(y, ops):
    """The kernel's product: y split into bf16 halves for float32 y (one
    bf16 pass for bf16 y), each bf16 x bf16 product exact, summed in float64
    here (the card sums in float32)."""
    hi, lo = ffmod.split_bf16(y)
    w_hi = ops.w_hi.double()
    acc = hi.double() @ w_hi.T
    if y.dtype == torch.float32:
        acc += lo.double() @ w_hi.T
    if ops.w_lo is not None:
        acc += hi.double() @ ops.w_lo.double().T
    return acc.float()


@pytest.mark.parametrize("bf16_weights", [False, True])
@pytest.mark.parametrize("norm", ["scalenorm", "layernorm"])
def test_split_product_meets_float32_limit(norm, bf16_weights, rng):
    """Two passes (three when W is not bf16-exact) stay within the card
    check's 1e-4 limit of the float32 product; one bf16 pass alone does not."""
    x, na, nb, wk, wb, dwk = _ff_inputs(rng, 1, 200, 256, 128, norm)
    w = torch.from_numpy(np.ascontiguousarray(wk.T))
    if bf16_weights:
        w = w.bfloat16().float()
    ops = ffmod.prepare_ffconvm(torch.from_numpy(na), torch.from_numpy(nb), w,
                                torch.from_numpy(wb), torch.from_numpy(dwk), norm,
                                torch.float32)
    assert (ops.w_lo is None) == bf16_weights
    y = ffmod._norm_f32(torch.from_numpy(x), torch.from_numpy(na), torch.from_numpy(nb), norm)
    exact = (y.double() @ w.double().T).float()
    got = _emulate_kernel_product(y, ops)
    scale = exact.abs().max()
    assert (got - exact).abs().max() <= 1e-5 * scale
    one_pass = (y.bfloat16().double() @ ops.w_hi.double().T).float()
    assert (one_pass - exact).abs().max() > 1e-4 * scale


def test_prepare_ffconvm_operands(rng):
    x, na, nb, wk, wb, dwk = _ff_inputs(rng, 1, 20, 64, 136, "layernorm")
    t = torch.from_numpy
    w = t(np.ascontiguousarray(wk.T))
    ops = ffmod.prepare_ffconvm(t(na), t(nb), w, t(wb), t(dwk), "layernorm", torch.float32)
    assert ops.layernorm and ops.dtype == torch.float32
    assert ops.w_hi.shape == (136, 64) and ops.w_hi.is_contiguous()
    assert ops.w_lo is not None and ops.w_lo.dtype == torch.bfloat16
    assert ops.na.shape == ops.nb.shape == (64,) and ops.bias.shape == (136,)
    assert ops.dwk.shape == (17, 136) and ops.dwk.dtype == torch.float32
    torch.testing.assert_close(ops.dwk, t(dwk)[:, 0], rtol=0, atol=0)
    # for bf16 activations every operand is rounded to bf16 and W has one half
    bf = ffmod.prepare_ffconvm(t(na), t(nb), w, t(wb), t(dwk), "layernorm", torch.bfloat16)
    assert bf.w_lo is None and bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.bias, t(wb).bfloat16().float(), rtol=0, atol=0)
    torch.testing.assert_close(bf.w_hi, w.bfloat16(), rtol=0, atol=0)


def test_prepared_ffconvm_operands_are_checked(rng):
    """The CUDA path checks the prepared operands with attribute reads and
    raises when they were made for another type, norm or width."""
    x, na, nb, wk, wb, dwk = _ff_inputs(rng, 1, 20, 64, 128, "scalenorm")
    t = torch.from_numpy
    args = (t(na), t(nb), t(np.ascontiguousarray(wk.T)), t(wb), t(dwk), "scalenorm")
    ops = ffmod.prepare_ffconvm(*args, torch.float32)
    xt = t(x)
    ffmod._check_prepared(xt, ops, "scalenorm")
    with pytest.raises(ValueError, match="prepared for"):
        ffmod._check_prepared(xt.bfloat16(), ops, "scalenorm")
    with pytest.raises(ValueError, match="prepared for"):
        ffmod._check_prepared(xt, ops, "layernorm")
    with pytest.raises(ValueError, match="contiguous"):
        ffmod._check_prepared(t(np.zeros((1, 20, 72), np.float32)), ops, "scalenorm")
    with pytest.raises(ValueError, match="contiguous"):
        ffmod._check_prepared(t(np.zeros((1, 64, 20), np.float32)).transpose(1, 2), ops,
                              "scalenorm")
    with pytest.raises(ValueError, match="norm"):
        ffmod.prepare_ffconvm(*args[:-1], "rmsnorm", torch.float32)
    with pytest.raises(TypeError):
        ffmod.prepare_ffconvm(*args, torch.float16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ffmod.prepare_ffconvm(*args[:2], torch.zeros(64, 60), *args[3:], torch.float32)


def test_dwconv_taps_must_be_ready():
    """The CUDA path copies nothing: taps in another type, or not contiguous,
    raise instead of being converted per call."""
    x = torch.zeros(1, 50, 64)
    with pytest.raises(ValueError, match="taps"):
        dwmod._check(x, torch.zeros(13, 1, 64, dtype=torch.bfloat16), 1, 10, 2)
    with pytest.raises(ValueError, match="taps"):
        dwmod._check(x, torch.zeros(64, 1, 13).transpose(0, 2), 1, 10, 2)


def test_packed_entry_fills_one_block_per_call():
    """A packed entry point gets the address of one int64 block holding the
    call's arguments and then the stream, refilled on every call."""
    seen = []

    def c_function(address):
        seen.append(list((ctypes.c_int64 * 4).from_address(address)))
        return 0

    entry = _build.Entry("td_fake", [ctypes.c_void_p], packed=4)
    entry._fn = c_function
    entry._device = lambda: 0
    entry._stream = lambda index: 1234
    entry(0, 2 ** 40 + 3, -1, 7)
    entry(0, 5, 6, 8)
    assert seen == [[2 ** 40 + 3, -1, 7, 1234], [5, 6, 8, 1234]]
    entry._fn = lambda address: 700
    with pytest.raises(RuntimeError, match="td_fake failed with CUDA error 700"):
        entry(0, 1, 2, 3)


def test_prepared_taps_match_tensor_taps(rng):
    """Taps made once (`prepare_taps`) hold the tensor's values contiguous in
    the kernel's (K, m, C) layout; on the CPU `dw_conv1d` takes them beside
    the tensor, through its padding forms, and reads the tensor."""
    x = rng.standard_normal((2, 90, 64)).astype(np.float32)
    w = (rng.standard_normal((13, 1, 64)) * 0.3).astype(np.float32)
    strided = torch.from_numpy(w).permute(2, 1, 0).contiguous().permute(2, 1, 0)
    taps = dwmod.prepare_taps(strided)
    assert taps.shape == (13, 1, 64) and taps.device == -1 and taps.dtype == torch.float32
    assert taps.weight.is_contiguous() and taps.ptr == taps.weight.data_ptr()
    torch.testing.assert_close(taps.weight, torch.from_numpy(w), rtol=0, atol=0)
    for pad in ("SAME", (10, 2)):
        want = dw_conv1d(torch.from_numpy(x), torch.from_numpy(w), padding=pad)
        got = dw_conv1d(torch.from_numpy(x), strided, padding=pad, taps=taps)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="kernel must be"):
        dwmod.prepare_taps(torch.zeros(13, 64))


@pytest.mark.parametrize("k,m", [(1, 1), (11, 1), (13, 1), (39, 1), (39, 2), (5, 3)])
def test_prepared_taps_dilation_limit_matches_shared_memory(k, m):
    """`max_dilation` is the largest dilation the kernel takes: dilated
    tiles up to the largest dilation whose tile and halo fit the block's
    shared memory, phase tiles (K-1 halo rows at any dilation) above it, as
    the kernel sizes them; a K whose phase tile does not fit takes none."""
    taps = dwmod.prepare_taps(torch.zeros(k, m, 32))
    d = taps.max_dilation
    assert d == dwmod.max_dilation(k) == dwmod.MAX_DILATION
    assert dwmod.smem_bytes(k, m, d) <= dwmod.MAX_SMEM
    d0 = max(dd for dd in range(1, 1000) if not dwmod.phase_tiles(k, dd))
    assert dwmod.smem_bytes(k, m, d0) <= dwmod.MAX_SMEM
    assert dwmod.phase_tiles(k, d0 + 1) and dwmod.smem_bytes(k, m, d0 + 1) <= dwmod.MAX_SMEM
    assert dwmod.max_dilation(440) == 0


def test_chip_smoke_plain_patch_takes_the_models_calls(rng):
    """chip_smoke.py's plain paths patch the wrappers with their plain
    versions: the patches take the calls the models make (prepared
    operands and taps included) and give the wrappers' CPU results."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from targetdiarization_tpu_torch.models import separation
    from targetdiarization_tpu_torch.ops import dwconv as dwconv_op

    x, na, nb, wk, wb, dwk = map(torch.from_numpy, _ff_inputs(rng, 1, 30, 32, 64, "layernorm"))
    w = wk.T.contiguous()
    ops = ffmod.prepare_ffconvm(na, nb, w, wb, dwk, "layernorm", torch.float32)
    taps_w = torch.from_numpy((rng.standard_normal((13, 1, 32)) * 0.3).astype(np.float32))
    taps = dwmod.prepare_taps(taps_w)
    want_ff = ffconvm(x, na, nb, w, wb, dwk, "layernorm", prepared=ops)
    want_dw = dw_conv1d(x, taps_w, padding=(10, 2), taps=taps)
    with chip_smoke.plain_kernels():
        assert separation.ffconvm is not ffconvm and dwconv_op.dwconv is not dwconv
        got_ff = separation.ffconvm(x, na, nb, w, wb, dwk, "layernorm", prepared=ops)
        got_dw = dw_conv1d(x, taps_w, padding=(10, 2), taps=taps)
    torch.testing.assert_close(got_ff, want_ff, rtol=0, atol=0)
    torch.testing.assert_close(got_dw, want_dw, rtol=0, atol=0)


# ---------------- gated FLASH's float32 split on the tensor cores ----------------


def _split_product(a, b, passes, half=False):
    """a @ b as the kernel's tensor cores run it: both operands split into
    bf16 halves (or, with `half`, each scaled by a power of two that puts
    its largest |x| in [2^14, 2^15) and split into fp16 halves: the FLASH
    kernel's float32 path), each 16-bit product exact, summed in float64
    here (the card sums in float32); passes 1 is hi.hi, 3 adds hi.lo and
    lo.hi."""
    def halves(x):
        if not half:
            return (t.double() for t in ffmod.split_bf16(x))
        scale = 2.0 ** (14 - int(np.floor(np.log2(float(x.abs().max())))))
        hi = (x * scale).half().float()
        return hi.double() / scale, ((x * scale) - hi).half().double() / scale

    a_hi, a_lo = halves(a)
    b_hi, b_lo = halves(b)
    acc = a_hi @ b_hi
    if passes == 3:
        acc = acc + a_hi @ b_lo + a_lo @ b_hi
    return acc.float()


def _emulate_flash_gated(q, k, v, u, mask, lq, kv, ku, passes, half=False):
    """csrc/flash_gated.cu's float32 arithmetic: S = q k^T in `passes` split
    passes, A = relu(S / g)^2 * mask in float32, then A, lq, v, u, lin_kv
    and lin_ku split for [A | lq] . [v ; lin_kv] and . [u ; lin_ku], the
    gate in float32; `half` for fp16 halves of scaled operands."""
    g = q.shape[-2]
    s = _split_product(q, k.transpose(-1, -2), passes, half)
    attn = torch.relu(s * (1.0 / g)).square() * mask
    a_lq = torch.cat([attn, lq], dim=-1)
    att_v = _split_product(a_lq, torch.cat([v, kv[:, None]], dim=-2), passes, half)
    att_u = _split_product(a_lq, torch.cat([u, ku[:, None]], dim=-2), passes, half)
    return (att_u * v) * torch.sigmoid(att_v * u)


def _gated_exact(args):
    qd, kd, vd, ud, md, lqd, kvd, kud = (a.double() for a in args)
    attn = torch.relu(qd @ kd.transpose(-1, -2) / qd.shape[-2]).square() * md
    att_v = attn @ vd + lqd @ kvd[:, None]
    att_u = attn @ ud + lqd @ kud[:, None]
    return (att_u * vd) * torch.sigmoid(att_v * ud)


@pytest.mark.parametrize("qk_scale", [4.0, 1.0])
def test_flash_split_passes_meet_float32_limit(qk_scale, rng):
    """Three passes (hi.hi + hi.lo + lo.hi) of both products stay within
    the card check's 1e-4 limit of a float64 `flash_gated_plain` at the main
    path's group shape (g 256, d 128, e 1024) with a masked tail of 225
    keys, at chip_smoke.py's input scale (q, k x 4) and at unit scale, with
    fp16 halves of scaled operands (the kernel's float32 path) and with bf16
    halves; one bf16 pass alone misses it. So the kernel runs three passes,
    no lo.lo."""
    q, k, v, u, mask, lq, kv, ku = _gated_inputs(rng, 1, 1, 256, 128, 1024, masked_cols=225)
    q, k = q * qk_scale, k * qk_scale
    args = [torch.from_numpy(a) for a in (q, k, v, u, mask, lq, kv, ku)]
    exact = _gated_exact(args)
    limit = 1e-4 * exact.abs().max()
    for half in (True, False):
        three = _emulate_flash_gated(*args, passes=3, half=half).double()
        assert (three - exact).abs().max() <= limit
    one = _emulate_flash_gated(*args, passes=1).double()
    assert (one - exact).abs().max() > limit
    torch.testing.assert_close(flash_gated(*args).double(), exact, rtol=0,
                               atol=float(limit))


@pytest.mark.parametrize("g, d, e", [(256, 128, 1024), (128, 128, 512), (64, 32, 128)])
def test_flash_fp16_split_keeps_margin_where_bf16_split_does_not(g, d, e, rng):
    """At every FLASH_SHAPES group shape and chip_smoke.py's input scale,
    three passes over fp16 halves of power-of-two scaled operands (the
    kernel's float32 path) err by under a tenth of the 1e-4 limit, and by
    under a tenth of what three passes over bf16 halves err by (those reach
    2.2e-4 at g 128 on the card's inputs, tools/flash_precision.py)."""
    q, k, v, u, mask, lq, kv, ku = _gated_inputs(rng, 6, 1, g, d, e, masked_cols=g // 5)
    args = [torch.from_numpy(a) for a in (q * 4.0, k * 4.0, v, u, mask, lq, kv, ku)]
    exact = _gated_exact(args)
    top = float(exact.abs().max())
    fp16 = float((_emulate_flash_gated(*args, passes=3, half=True).double() - exact).abs().max())
    bf16 = float((_emulate_flash_gated(*args, passes=3).double() - exact).abs().max())
    assert fp16 <= 1e-5 * top and fp16 <= 0.1 * bf16


def test_flash_wrapper_refuses_shapes_the_kernel_does_not_take():
    """The CUDA branch takes g a multiple of 64 in [64, 256], d a multiple of
    16 in [16, min(g, 128)] and e a multiple of 128 (csrc/flash_gated.cu):
    both shipped separators and the training recipe's default fit."""
    def args(g, d, e, gated=True):
        q, v = torch.zeros(1, 2, g, d), torch.zeros(1, 2, g, e)
        extra = (q, torch.zeros(1, d, e), torch.zeros(1, d, e)) if gated else ()
        return (q, q, v, v, torch.zeros(1, 2, 1, g), *extra)

    for g, d, e in ((256, 128, 1024), (128, 128, 512), (64, 32, 128), (256, 64, 1024),
                    (128, 16, 128), (64, 64, 256)):
        flmod._check(*args(g, d, e))
        flmod._check(*args(g, d, e, gated=False))
    for g, d, e in ((96, 128, 1024), (512, 128, 1024), (256, 128, 1000), (64, 128, 1024),
                    (256, 24, 1024), (256, 144, 1024), (32, 16, 128), (64, 0, 128)):
        with pytest.raises(ValueError, match="flash kernels take"):
            flmod._check(*args(g, d, e))


@pytest.mark.parametrize("m,c,dtype,ok", [
    (1, 256, torch.float32, True), (2, 256, torch.float32, True), (4, 16, torch.float32, True),
    (1, 64, torch.bfloat16, True), (3, 32, torch.float32, False), (1, 6, torch.float32, False),
    (1, 12, torch.bfloat16, False),
])
def test_dwconv_kernel_takes_its_vector_widths(m, c, dtype, ok):
    """The kernel reads 4 input channels a thread and stages rows in 16-byte
    copies: m 1, 2 or 4 and C*m a multiple of 4 (float32) or 8 (bf16). Taps it
    cannot take are marked, and a call on the card then raises the reason."""
    taps = dwmod.prepare_taps(torch.zeros(13, m, c, dtype=dtype))
    assert taps.kernel_ok is ok
    assert taps.max_dilation >= 1  # shared memory does not refuse them
    x = torch.zeros(1, 50, m * c, dtype=dtype)
    if ok:
        assert dwmod._check(x, taps.weight, 1, 6, 6) == 50
    else:
        with pytest.raises(ValueError, match="dwconv kernel takes m"):
            dwmod._check(x, taps.weight, 1, 6, 6)


def test_flash_phase_probe_finds_its_anchors():
    """tools/flash_phases.py instruments a copy of csrc/flash_gated.cu at
    fixed anchors: each is found once, so the probe follows the source."""
    from targetdiarization_tpu_torch.tools.flash_phases import instrument

    with open(os.path.join(_build.CSRC, "flash_gated.cu")) as f:
        text = instrument(f.read())
    assert text.count("TICK(") == 10 and 'extern "C" int td_flash_phases' in text
    assert text.index("TICK(8)") < text.index("int launch_d(")  # the kernel's own end
    with pytest.raises(ValueError, match="anchor"):
        instrument(text.replace("    fetch(0);", "    fetch(0) ;"))


def test_tensor_core_kernels_share_the_hopper_header():
    """FFConvM and FLASH take their wgmma primitives from csrc/hopper.cuh;
    neither keeps a copy of its own."""
    for name in ("ffconvm.cu", "flash_gated.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        assert '#include "hopper.cuh"' in text
        assert "uint64_t gmma_desc(" not in text and "void split_bf16(" not in text


def test_build_compiles_each_source_in_parallel_then_links(monkeypatch, tmp_path):
    """`_build.build` with a stand-in nvcc (this machine has none): one
    compile a source, each running while all three have started, then one
    link of their objects; the ptxas reports joined in source order and no
    object left; a failing compile raises with its output and leaves no
    library."""
    import sys

    calls, started = tmp_path / "calls", tmp_path / "started"
    started.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({str(calls)!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if args[-1].endswith("broken.cu"):
    sys.exit("error in broken.cu")
if "-c" in args:
    open(os.path.join({str(started)!r}, os.path.basename(args[-1])), "w").close()
    time.sleep(1)
    with open(out, "w") as f:
        f.write(str(len(os.listdir({str(started)!r}))))
    sys.stderr.write("ptxas report of " + os.path.basename(args[-1]) + "\\n")
else:
    with open(out, "w") as f:
        f.write(" ".join(open(a).read() for a in args if a.endswith(".o")))
""")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text("// source\n")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path = str(tmp_path / "build" / "lib.so")
    _build.build(path)
    lines = calls.read_text().splitlines()
    compiles, links = [c for c in lines if " -c " in c], [c for c in lines if " -c " not in c]
    assert len(compiles) == 3 and len(links) == 1
    assert "-shared" in links[0].split() and all("-shared" not in c.split() for c in compiles)
    assert open(path).read().split() == ["3", "3", "3"]  # all three had started
    assert open(_build.ptxas_log(path)).read() == "".join(
        f"ptxas report of {n}\n" for n in ("a.cu", "b.cu", "c.cu"))
    assert sorted(os.listdir(tmp_path / "build")) == ["lib.ptxas.txt", "lib.so"]
    (csrc / "broken.cu").write_text("// source\n")
    with pytest.raises(RuntimeError, match="error in broken.cu"):
        _build.build(str(tmp_path / "build" / "lib2.so"))
    assert sorted(os.listdir(tmp_path / "build")) == ["lib.ptxas.txt", "lib.so"]
