"""Gradients of the port's kernel Functions against the JAX package's custom VJPs.

The JAX package wraps each Pallas kernel in a `jax.custom_vjp`: FFConvM and
FLASH differentiate their jnp reference formulations, dwconv launches its
kernel again for dx at m = 1 (on the taps flipped in time) and sums dw per
tap. The port's `torch.autograd.Function`s follow the same rules; on a CPU
tensor the forward and dx run the plain versions, so these tests reach the
backward code the card runs. The JAX side runs its Pallas kernels in
interpret mode, as tests/test_pallas.py does, at widths the kernels take.
Gradients are held within 1e-4 of each reference gradient's largest
magnitude, in float32, against `jax.vjp` and against autograd of the port's
plain versions. The staleness guard of the prepared operands is checked on
CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.ops.pallas.dwconv import dw_conv1d_pallas
from targetdiarization_tpu.ops.pallas.ffconvm import _ffconvm_fused
from targetdiarization_tpu.ops.pallas.flash import _flash_fused, _gated_fused
from targetdiarization_tpu_torch.models.separation import DilatedDenseFsmnNet, FFConvM
from targetdiarization_tpu_torch.ops.kernels import check_fresh, prepare_kernels
from targetdiarization_tpu_torch.ops.kernels import dwconv as dwmod
from targetdiarization_tpu_torch.ops.kernels import ffconvm as ffmod
from targetdiarization_tpu_torch.ops.kernels import flash as flmod

torch.set_num_threads(2)  # beside the other test workers' threads

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _jax_grads(fn, inputs, cot, argnums):
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda *a: fn(*a), *[jnp.asarray(a) for a in inputs])
        grads = vjp(jax.tree_util.tree_map(jnp.asarray, cot))
    return np.asarray(out) if not isinstance(out, tuple) else tuple(map(np.asarray, out)), \
        [np.asarray(grads[i]) for i in argnums]


def _torch_grads(fn, inputs, cot, argnums):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in argnums)
          for i, a in enumerate(inputs)]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    grads = torch.autograd.grad(outs, [ts[i] for i in argnums],
                                [torch.from_numpy(c) for c in cots])
    value = tuple(o.detach().numpy() for o in outs)
    return value if isinstance(out, tuple) else value[0], [g.numpy() for g in grads]


def _check(jax_fn, port_fn, plain_fn, inputs, cot, argnums):
    want_out, want = _jax_grads(jax_fn, inputs, cot, argnums)
    got_out, got = _torch_grads(port_fn, inputs, cot, argnums)
    plain_out, plain = _torch_grads(plain_fn, inputs, cot, argnums)
    for g, w, p in zip(got, want, plain):
        _close(g, w)
        _close(g, p)
    for g, w in zip(got_out if isinstance(got_out, tuple) else (got_out,),
                    want_out if isinstance(want_out, tuple) else (want_out,)):
        _close(g, w)


@pytest.mark.parametrize("m,dil,pads", [
    (1, 1, None), (1, 1, (10, 2)), (1, 2, None), (1, 64, None),
    (2, 1, None), (2, 2, None), (2, 2, (10, 2)), (2, 64, (10, 2)),
])
def test_dwconv_gradients_match_jax_vjp(m, dil, pads):
    rng = np.random.default_rng(100 + 10 * m + dil)
    # K 13 with (10, 2) is the VAD memory's conv; the JAX backward takes pads
    # up to the span (its dx pads are span - pad)
    c, k = 128, 3 if dil == 64 else 13
    span = (k - 1) * dil
    pad_l, pad_r = (span // 2, span - span // 2) if pads is None else pads
    x = rng.standard_normal((2, 300, c * m)).astype(np.float32)
    w = (rng.standard_normal((k, m, c)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((2, 300 + pad_l + pad_r - span, c)).astype(np.float32)
    _check(lambda x_, w_: dw_conv1d_pallas(x_, w_, dil, pad_l, pad_r),
           lambda x_, w_: dwmod.dwconv(x_, w_, dil, pad_l, pad_r),
           lambda x_, w_: dwmod.dwconv_plain(x_, w_, dil, pad_l, pad_r), (x, w), cot, (0, 1))


def test_dwconv_dx_runs_the_conv_on_flipped_taps(monkeypatch):
    """dx at m = 1 is one more conv through the forward's path, on the taps
    flipped in time with the pads swapped to span - pad; m > 1 sums per tap."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 50, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((5, 1, 16)).astype(np.float32))
    calls = []
    plain = dwmod.dwconv_plain

    def spy(x_, w_, dil, pad_l, pad_r):
        calls.append((tuple(x_.shape), w_.clone(), dil, pad_l, pad_r))
        return plain(x_, w_, dil, pad_l, pad_r)

    monkeypatch.setattr(dwmod, "dwconv_plain", spy)
    out = dwmod.dwconv(x, w, 2, 10, 2)
    assert type(out.grad_fn).__name__ == "DwconvFnBackward"
    out.sum().backward()
    # span 8: pads (10, 2) swap to (-2, 6); the negative pad crops g's first two rows
    assert len(calls) == 2 and calls[1][0] == (1, 52, 16) and calls[1][2:] == (2, 0, 6)
    torch.testing.assert_close(calls[1][1], w.flip(0), rtol=0, atol=0)
    assert dwmod.dwconv.backward_launches == 0  # no launch on the CPU


def test_wrappers_go_straight_on_without_autograd():
    """No Function (and no saved inputs) where autograd does not record."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(np.float32))
    w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((3, 1, 16)).astype(np.float32)))
    with torch.no_grad():
        assert dwmod.dwconv(x, w, 1, 1, 1).grad_fn is None
    with torch.inference_mode():
        assert dwmod.dwconv(x, w, 1, 1, 1).grad_fn is None
    assert type(dwmod.dwconv(x, w, 1, 1, 1).grad_fn).__name__ == "DwconvFnBackward"
    assert dwmod.dwconv(x, w.detach(), 1, 1, 1).grad_fn is None


def _ff_inputs(rng, cin, cout, norm):
    x = (rng.standard_normal((2, 40, cin)) * 0.3).astype(np.float32)
    x[0, 5:9] = 0.0
    if norm == "scalenorm":
        na, nb = np.array([1.3], np.float32), np.zeros(1, np.float32)
    else:
        na = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
        nb = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    wk = (rng.standard_normal((cin, cout)) * 0.05).astype(np.float32)
    wb = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    dwk = (rng.standard_normal((17, 1, cout)) * 0.2).astype(np.float32)
    return x, na, nb, wk, wb, dwk


@pytest.mark.parametrize("norm", ["scalenorm", "layernorm"])
def test_ffconvm_gradients_match_jax_vjp(norm):
    rng = np.random.default_rng(21 if norm == "scalenorm" else 22)
    x, na, nb, wk, wb, dwk = _ff_inputs(rng, 128, 256, norm)
    cot = rng.standard_normal((2, 40, 256)).astype(np.float32)
    argnums = (0, 1, 3, 4, 5) + ((2,) if norm == "layernorm" else ())
    # the port's Linear weight is (cout, cin): the JAX kernel (cin, cout) transposed
    _check(lambda x_, a, b, w_, bias, k_: _ffconvm_fused(x_, a, b, w_, bias, k_, norm),
           lambda x_, a, b, w_, bias, k_: ffmod.ffconvm(x_, a, b, w_.T, bias, k_, norm),
           lambda x_, a, b, w_, bias, k_: ffmod.ffconvm_plain(x_, a, b, w_.T, bias, k_, norm),
           (x, na, nb, wk, wb, dwk), cot, argnums)


def test_ffconvm_grouped_recompute_equals_taps():
    """The backward's recompute takes the 17 taps as one grouped conv."""
    rng = np.random.default_rng(23)
    x, na, nb, wk, wb, dwk = map(torch.from_numpy, _ff_inputs(rng, 32, 64, "layernorm"))
    w = wk.T.contiguous()
    a = ffmod.ffconvm_plain(x, na, nb, w, wb, dwk, "layernorm")
    b = ffmod.ffconvm_plain(x, na, nb, w, wb, dwk, "layernorm", grouped=True)
    _close(b.numpy(), a.numpy(), 1e-6)


def _flash_inputs(rng, b=1, n_groups=2, g=128, d=128, e=128):
    q = (rng.standard_normal((b, n_groups, g, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, n_groups, g, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, n_groups, g, e)).astype(np.float32)
    u = rng.standard_normal((b, n_groups, g, e)).astype(np.float32)
    mask = np.ones((b, n_groups, 1, g), np.float32)
    mask[:, -1, :, 90:] = 0.0
    return q, k, v, u, mask


def test_flash_gated_gradients_match_jax_vjp():
    rng = np.random.default_rng(31)
    q, k, v, u, mask = _flash_inputs(rng)
    lq = (rng.standard_normal(q.shape) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((1, 128, 128)) * 0.05).astype(np.float32)
    ku = (rng.standard_normal((1, 128, 128)) * 0.05).astype(np.float32)
    cot = rng.standard_normal(v.shape).astype(np.float32)
    _check(_gated_fused, flmod.flash_gated, flmod.flash_gated_plain,
           (q, k, v, u, mask, lq, kv, ku), cot, (0, 1, 2, 3, 5, 6, 7))


def test_flash_group_gradients_match_jax_vjp():
    rng = np.random.default_rng(32)
    q, k, v, u, mask = _flash_inputs(rng)
    cot = (rng.standard_normal(v.shape).astype(np.float32),
           rng.standard_normal(v.shape).astype(np.float32))
    _check(_flash_fused, flmod.flash_group_attention, flmod.flash_group_plain,
           (q, k, v, u, mask), cot, (0, 1, 2, 3))


def test_flash_mask_gets_no_gradient():
    rng = np.random.default_rng(33)
    ts = [torch.from_numpy(a).requires_grad_() for a in _flash_inputs(rng, g=64, d=16, e=32)]
    out_v, out_u = flmod.flash_group_attention(*ts)
    (out_v.sum() + out_u.sum()).backward()
    assert ts[4].grad is None and all(t.grad is not None for t in ts[:4])


def test_staleness_guard_raises_after_an_in_place_change():
    """Prepared operands record their weights' versions; after an in-place
    change the check raises, naming the module, until they are made again."""
    torch.manual_seed(0)
    ff = FFConvM(32, 64, norm="layernorm")
    prepare_kernels(ff)
    x = torch.randn(1, 20, 32)
    ffmod._check_prepared(x, ff.kernel_ops, "layernorm")
    with torch.no_grad():
        ff.proj.weight.add_(1e-3)
    with pytest.raises(RuntimeError, match="FFConvM.*prepare_kernels"):
        ffmod._check_prepared(x, ff.kernel_ops, "layernorm")
    prepare_kernels(ff)
    ffmod._check_prepared(x, ff.kernel_ops, "layernorm")

    fsmn = torch.nn.Module()
    fsmn.ddn = DilatedDenseFsmnNet(16, lorder=3)
    prepare_kernels(fsmn)
    taps = fsmn.ddn.conv_taps[0]
    check_fresh(taps)
    with torch.no_grad():
        fsmn.ddn.conv_kernels[0].add_(1.0)
    with pytest.raises(RuntimeError, match=r"ddn\.conv_kernels\.0"):
        check_fresh(taps)
    # the launch path's predicate takes the check (before any CUDA call)
    with pytest.raises(RuntimeError, match="prepare_kernels"):
        dwmod._launch(torch.zeros(1, 30, 16), taps, 1, 2, 2)
    prepare_kernels(fsmn)
    check_fresh(fsmn.ddn.conv_taps[0])
