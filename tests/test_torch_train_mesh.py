"""`SeparationTrainer` over a mesh of CPU slots against the JAX trainer on
as many of the 8 virtual CPU devices that tests/conftest.py makes, and
against the port's one slot on the whole batch.

tests/test_train.py's small MossFormer2 from one seeded parameter tree in
both packages (`runtime/convert.py`), 3 steps of 4 mixes of 0.1 s (the
data of tests/test_torch_train.py), on n = 2 and 4 slots (2 and 1 rows a
slot). The JAX side runs at full float32 matmul precision. Held:
- each step's loss and gradient norm within 1e-4 of the JAX trainer's
  and within 1e-5 of one slot's on the whole batch;
- the parameters after the steps within 1e-5 of one slot's and within
  1e-4 of the JAX trainer's, and the held-out loss they give within 1e-4
  of the JAX parameters';
- an indivisible batch raises in both packages, naming both sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models.separation import MossFormer2 as JaxMossFormer2
from targetdiarization_tpu.parallel.mesh import replicated as jax_replicated
from targetdiarization_tpu.runtime.params import upgrade_scan_layout
from targetdiarization_tpu.train import SeparationTrainer as JaxTrainer
from targetdiarization_tpu.train import TrainConfig as JaxConfig
from targetdiarization_tpu.train import data as jdata
from targetdiarization_tpu_torch.models.separation import MossFormer2
from targetdiarization_tpu_torch.runtime.convert import INVERSE_CONVERTERS, mossformer2_state_dict
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import SeparationTrainer, TrainConfig
from targetdiarization_tpu_torch.train import data as tdata
from targetdiarization_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)  # beside the other test workers' threads

SMALL = dict(dim=16, enc_channels=16, num_blocks=1, group_size=32, qk_dim=16, kernel_size=8,
             fsmn_inner=8)  # tests/test_train.py's MossFormer2
SECONDS = 0.1
BATCH = 4
STEPS = 3
NS = (2, 4)


def _files(seed=0, n=32000):
    rng = np.random.default_rng(seed)
    return {"a": [(rng.standard_normal(n) * 0.3).astype(np.float32)],
            "b": [(np.sin(np.linspace(0, 700, n)) * 0.3).astype(np.float32)]}


def _batches(seed=0, steps=STEPS):
    return list(tdata.DynamicMixDataset(_files(seed), tdata.MixConfig(
        segment_seconds=SECONDS), seed=seed).batches(BATCH, steps))


def _port(params, n):
    return SeparationTrainer(MossFormer2(**SMALL), params=params, cfg=TrainConfig(
        learning_rate=1e-3, save_every=0, n_devices=n), device="cpu")


@pytest.fixture(scope="module")
def init():
    return init_params(MossFormer2(**SMALL), seed=0)


@pytest.fixture(scope="module")
def single(init):
    """The port's one slot on the whole batches: history and parameters."""
    trainer = _port(init, 1)
    history = trainer.fit(_batches(), log_every=1, log_fn=lambda *_: None)
    return history, {k: p.detach().clone() for k, p in trainer.params.items()}


def _jax_run(init, n):
    flat = INVERSE_CONVERTERS["MossFormer2"](init)
    tree = upgrade_scan_layout("MossFormer2", unflatten({k: jnp.asarray(v)
                                                         for k, v in flat.items()}))
    batches = list(jdata.DynamicMixDataset(_files(), jdata.MixConfig(
        segment_seconds=SECONDS), seed=0).batches(BATCH, STEPS))
    with jax.default_matmul_precision("highest"):
        trainer = JaxTrainer(JaxMossFormer2(**SMALL), params=tree, cfg=JaxConfig(
            learning_rate=1e-3, save_every=0, n_devices=n), example_seconds=SECONDS)
        assert trainer.n_devices == n
        # placed as the step's jit places it, so that the step compiles once
        trainer.state = jax.device_put(trainer.state, jax_replicated(trainer.mesh))
        history = trainer.fit(batches, log_every=1, log_fn=lambda *_: None)
    after = mossformer2_state_dict(jax.tree_util.tree_map(np.asarray, trainer.state["params"]))
    return history, after


@pytest.mark.parametrize("n", NS)
def test_trainer_on_a_mesh_matches_jax_and_one_slot(init, single, n):
    want, jax_after = _jax_run(init, n)
    trainer = _port(init, n)
    assert trainer.n_devices == n and len(trainer.replicas) == n
    history = trainer.fit(_batches(), log_every=1, log_fn=lambda *_: None)
    one, one_after = single
    for got, jax_step, alone in zip(history, want, one):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - jax_step[key]) <= 1e-4 * abs(jax_step[key]), key
            assert abs(got[key] - alone[key]) <= 1e-5 * abs(alone[key]), key
    for k, p in trainer.params.items():
        assert float((p.detach() - one_after[k]).abs().max()) <= 1e-5, k
    assert max(float((jax_after[k] - init[k]).abs().max()) for k in jax_after) > 1e-3
    for k, p in trainer.params.items():
        assert float((p.detach() - jax_after[k]).abs().max()) <= 1e-4, k
    held = _batches(seed=9, steps=1)
    ref = _port(jax_after, 1).evaluate(held)
    assert abs(trainer.evaluate(held) - ref) <= 1e-4 * abs(ref)
    # every replica holds slot 0's parameters, its kernel operands remade
    for replica in trainer.replicas[1:]:
        for p, q in zip(replica.parameters(), trainer.params.values()):
            assert torch.equal(p, q)


def test_indivisible_batch_raises_in_both_packages(init):
    batch = _batches(steps=1)[0]
    odd = {k: v[:3] for k, v in batch.items()}
    with pytest.raises(ValueError, match="batch size 3 not divisible by mesh size 2"):
        _port(init, 2).train_step(odd)
    theirs = JaxTrainer(JaxMossFormer2(**SMALL), cfg=JaxConfig(save_every=0, n_devices=2),
                        params={"params": {}})
    with pytest.raises(ValueError, match="batch size 3 not divisible by mesh size 2"):
        theirs._place(odd)


def test_save_restore_and_export_on_a_mesh(init, tmp_path):
    """save, restore and the inference export keep their formats and write
    slot 0's state; a restore reaches every replica."""
    ck = str(tmp_path / "ck")
    trainer = SeparationTrainer(MossFormer2(**SMALL), params=init, cfg=TrainConfig(
        save_every=0, n_devices=2, checkpoint_dir=ck), device="cpu")
    trainer.fit(_batches(steps=2), log_every=100, log_fn=lambda *_: None)
    trainer.save()
    other = _port(init, 1)
    other.cfg.checkpoint_dir = ck
    assert other.restore() == 2
    for k, p in trainer.params.items():
        assert torch.equal(p, other.params[k]), k
    meshed = SeparationTrainer(MossFormer2(**SMALL), params=init, cfg=TrainConfig(
        save_every=0, n_devices=2, checkpoint_dir=ck), device="cpu")
    meshed.restore()
    for p, q in zip(meshed.replicas[1].parameters(), trainer.params.values()):
        assert torch.equal(p, q)
    path = trainer.export_inference_checkpoint(str(tmp_path / "export"))
    loaded = from_pretrained(path)
    for k, p in loaded.state_dict().items():
        assert torch.equal(p, trainer.model.state_dict()[k]), k
