"""The port's runtime layer names (`targetdiarization_tpu_torch.runtime`)
against the JAX package's on seeded inputs: `pad_to` (numpy and tensors,
any axis and pad value), `pad_to_bucket`, `BucketLadder.from_seconds` and
`split_plan`, `length_mask`, `masked_mean`, `param_count`, `tree_cast`,
`register_model` / `list_models`, the layer converters of
`runtime/convert.py` (`to_numpy` ... `ConversionRules`,
`verify_tree_shapes`); and every public name of the JAX runtime package and
of its buckets, params and registry modules resolves in the port's, but the
three that have no counterpart (ROADMAP.md)."""

import ast
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import targetdiarization_tpu.runtime as jax_runtime
import targetdiarization_tpu_torch.runtime as runtime
from targetdiarization_tpu.runtime import buckets as jax_buckets
from targetdiarization_tpu.runtime import convert as jax_convert
from targetdiarization_tpu.runtime import params as jax_params
from targetdiarization_tpu.runtime import registry as jax_registry
from targetdiarization_tpu_torch.runtime import buckets, convert, params, registry

torch.set_num_threads(2)  # beside the other test workers' threads

NO_COUNTERPART = {"fast_init", "save_checkpoint_orbax", "upgrade_scan_layout"}


@pytest.mark.parametrize("axis,value", [(-1, 0.0), (0, 0.0), (1, -3.5), (-2, 1.0)])
def test_pad_to_matches_jax(axis, value):
    rng = np.random.default_rng(10 + axis)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    n = x.shape[axis] + 4
    want = np.asarray(jax_buckets.pad_to(jnp.asarray(x), n, axis=axis, value=value))
    np.testing.assert_array_equal(runtime.pad_to(x, n, axis=axis, value=value), want)
    got = runtime.pad_to(torch.from_numpy(x), n, axis=axis, value=value)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert runtime.pad_to(x, x.shape[axis], axis=axis) is x
    with pytest.raises(ValueError):
        runtime.pad_to(x, x.shape[axis] - 1, axis=axis)


def test_ladder_and_pad_to_bucket_match_jax():
    ours, theirs = (runtime.BucketLadder.from_seconds(sr=100),
                    jax_buckets.BucketLadder.from_seconds(sr=100))
    assert ours.rungs == theirs.rungs
    assert runtime.DEFAULT_AUDIO_LADDER == jax_buckets.DEFAULT_AUDIO_LADDER
    for n in (1, 99, 100, 101, 2999, 3000, 3001, 7777):
        assert ours.bucket(n) == theirs.bucket(n)
        assert ours.split_plan(n) == theirs.split_plan(n)
    x = np.random.default_rng(2).standard_normal((2, 333)).astype(np.float32)
    got, n = runtime.pad_to_bucket(x, ours)
    want, m = jax_buckets.pad_to_bucket(x, theirs)
    assert n == m == 333
    np.testing.assert_array_equal(got, np.asarray(want))


def test_length_mask_and_masked_mean_match_jax():
    rng = np.random.default_rng(3)
    lengths = np.array([5, 11, 1, 16])
    want = np.asarray(jax_buckets.length_mask(lengths, 16))
    got = runtime.length_mask(torch.from_numpy(lengths), 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(runtime.length_mask(7, 9).numpy(),
                                  np.asarray(jax_buckets.length_mask(7, 9)))
    x = rng.standard_normal((4, 16, 6)).astype(np.float32)
    mask = want[:, :, None].copy()
    theirs = np.asarray(jax_buckets.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=1))
    np.testing.assert_allclose(runtime.masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                                                   axis=1).numpy(), theirs, rtol=1e-5,
                               atol=1e-7)  # float32 sums in another order
    np.testing.assert_allclose(runtime.masked_mean(x, mask, axis=1), theirs, rtol=1e-5,
                               atol=1e-7)


def test_param_count_and_tree_cast_match_jax():
    rng = np.random.default_rng(4)
    tree = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": rng.standard_normal(4).astype(np.float32)},
            "b": rng.standard_normal((2, 2, 5)).astype(np.float32),
            "steps": np.arange(3)}
    assert runtime.param_count(tree) == jax_params.param_count(tree) == 12 + 4 + 20 + 3
    ours = runtime.tree_cast(tree, np.float16)
    theirs = jax_params.tree_cast(tree, jnp.float16)
    for key in ("kernel", "bias"):
        assert ours["a"][key].dtype == np.float16
        np.testing.assert_array_equal(ours["a"][key], np.asarray(theirs["a"][key]))
    assert ours["steps"].dtype == tree["steps"].dtype
    tensors = runtime.tree_cast({k: torch.from_numpy(v) for k, v in tree["a"].items()},
                                torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tensors.values())
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    assert runtime.param_count(model) == 4 * 3 + 3 + 3 + 3
    assert runtime.tree_cast(model, torch.bfloat16) is model
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_register_model_and_list_models():
    names = runtime.list_models()
    assert {"MossFormer2", "Apollo", "ConvTasNet", "TFGridNet"} <= set(names)

    @runtime.register_model(name="ProbeNet")
    class ProbeNet(torch.nn.Module):
        pass

    try:
        assert runtime.get_model_cls("ProbeNet") is ProbeNet
        assert runtime.list_models() == sorted(names + ["ProbeNet"])
        assert runtime.register_model(ProbeNet) is ProbeNet  # under its own name
        with pytest.raises(ValueError, match="duplicate"):
            runtime.register_model(type("Other", (torch.nn.Module,), {}), name="ProbeNet")
        with pytest.raises(ValueError, match="duplicate"):
            runtime.register_model(type("MossFormer2", (torch.nn.Module,), {}))
    finally:
        registry._REGISTRY.pop("ProbeNet", None)
    with pytest.raises(KeyError):
        runtime.get_model_cls("ProbeNet")


def _defined(module) -> set:
    return {name for name, obj in vars(module).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


def test_every_jax_runtime_name_resolves():
    with open(os.path.join(os.path.dirname(jax_runtime.__file__), "__init__.py")) as f:
        exported = {a.asname or a.name for node in ast.parse(f.read()).body
                    if isinstance(node, ast.ImportFrom) for a in node.names}
    assert exported and not exported & NO_COUNTERPART
    missing = sorted(n for n in exported if not hasattr(runtime, n))
    assert not missing, missing
    for theirs, ours in ((jax_buckets, buckets), (jax_params, params),
                         (jax_registry, registry)):
        names = _defined(theirs)
        missing = sorted(n for n in names - NO_COUNTERPART
                         if not hasattr(ours, n) and not hasattr(runtime, n))
        assert not missing, (theirs.__name__, missing)
    assert NO_COUNTERPART <= _defined(jax_params)


def _equal_trees(a, b) -> None:
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_layer_converters_match_jax():
    rng = np.random.default_rng(5)
    w2, w3, w4, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((6, 4), (6, 4, 3), (6, 4, 3, 2), (6,)))
    for name, args in (("convert_linear", (w2, b)), ("convert_conv1d", (w3, b)),
                       ("convert_conv2d", (w4, b)), ("convert_norm", (b, b)),
                       ("convert_embedding", (w2,)), ("convert_linear", (w2,))):
        _equal_trees(getattr(convert, name)(*args), getattr(jax_convert, name)(*args))
    np.testing.assert_array_equal(convert.to_numpy(w2.to(torch.bfloat16)),
                                  w2.to(torch.bfloat16).float().numpy())
    sd = {"encoder.0.weight": w2, "encoder.0.bias": b, "head.weight": w3, "head.bias": b,
          "bn.running_mean": b, "scale": b}
    rules = [(r"encoder\.(\d+)", "enc_{0}", "linear"), (r"head", "head", "conv1d"),
             (r"bn", "bn", "norm"), (r"scale", "scale", "raw")]
    ours = convert.ConversionRules(rules).convert(sd)
    _equal_trees(ours, jax_convert.ConversionRules(rules).convert(sd))
    for pkg in (convert, jax_convert):
        with pytest.raises(KeyError, match="no conversion rule"):
            pkg.ConversionRules(rules[:1]).convert(sd)
    template = {k: (dict(v) if isinstance(v, dict) else v) for k, v in ours.items()}
    assert convert.verify_tree_shapes(ours, template) == \
        jax_convert.verify_tree_shapes(ours, template)
    template["enc_0"] = dict(template["enc_0"], kernel=np.zeros((5, 5)))
    for pkg in (convert, jax_convert):
        with pytest.raises(ValueError, match="shape mismatch"):
            pkg.verify_tree_shapes(ours, template)
        with pytest.raises(KeyError, match="missing"):
            pkg.verify_tree_shapes({}, template)
