"""Data-parallel separation trainer over a mesh of cards.

Counterpart of targetdiarization_tpu/train/trainer.py (the reference's
Lightning module rebuilt on optax): train and eval steps with the PIT
SI-SDR loss (or MixIT), global-norm clipping and an optimizer with
optax's rules (`train/optim.py`), checkpoint save and resume, and an
inference export that the engines' `from_pretrained` loads. The JAX
trainer takes `jax.value_and_grad` of the separator under jit over a
device mesh; here autograd runs through the kernels' Functions
(`ops/kernels`): FFConvM and gated FLASH launch their kernels forward and
recompute their plain versions backward, dwconv launches its kernel for
dx too.

Over a mesh (`parallel/mesh.py`; `n_devices`, all visible cards by
default) the model is slot 0 and every other slot holds a replica. A step
splits the batch into equal row shards; each slot takes its shard's loss
and gradient in its worker thread; the gradients are averaged onto slot 0
(the losses are means over rows, so this is the whole batch's gradient,
as XLA's all-reduce gives it); the optimizer steps there; the parameters
are copied into every replica. The reported loss is the mean of the
shards' losses, the gradient norm that of the averaged gradient.

The separator trains in float32, the JAX trainer's type. The kernels'
operands are made again (`prepare_kernels`) on every slot after the model
is placed and after every optimizer step, since the step changes the
weights in place.
"""

from __future__ import annotations

import inspect
import json
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.kernels import prepare_kernels
from ..parallel.mesh import make_mesh, replicated, shard_batch
from ..runtime.convert import CONVERTERS, flat_params
from ..runtime.params import restore_pytree, save_pytree, unflatten
from ..runtime.registry import save_checkpoint
from .losses import mixit_loss, pit_si_sdr_loss
from .optim import apply_updates, global_norm, make_optimizer


@dataclass
class TrainConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    n_devices: int | None = None  # None = every visible card; one slot on the CPU
    checkpoint_dir: str = "checkpoints/separation"
    save_every: int = 1000
    loss: str = "pit_si_sdr"  # or "mixit"
    extra: dict = field(default_factory=dict)


# flax's initializers by the JAX leaf name (the JAX models' `self.param`
# calls and flax's Dense, Conv, LayerNorm); every other leaf is a weight
# drawn by lecun_normal. A JAX leaf named `weight` is always a norm's
# (Dense and Conv name theirs `kernel`)
_ZEROS = re.compile(r"^(bias|b|beta|os_beta|in_b\d*|out_b|\w+_b[ih]|(uni|tail)_(bn|out)_b)$")
_ONES = re.compile(r"^(scale|g|weight|gamma|pos_scale|in_w\d+|(uni|tail)_norm_w)$")
_QUARTER = re.compile(r"^(alpha|prelu\d*)$")
_NORMAL_002 = ("os_gamma", "tag_queries", "dec_pos")
# flax's truncated normal keeps the draws within two standard deviations,
# and scales by this to keep the variance asked for
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (two sigma) with variance
    1 / fan_in, fan_in the product of all but the last axis."""
    std = (1.0 / max(int(np.prod(shape[:-1])), 1)) ** 0.5 / _TRUNCATED_STD
    lo, hi = (1 + torch.erf(torch.tensor([-2.0, 2.0], dtype=torch.float64) / 2 ** 0.5)) / 2
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    return (torch.erfinv(2 * u - 1) * 2 ** 0.5 * std).float()


def _flax_leaf(name: str, shape: tuple, gen: torch.Generator) -> torch.Tensor:
    leaf = name.rsplit("/", 1)[-1]
    if name.startswith("batch_stats/"):  # flax BatchNorm's running mean 0, variance 1
        return torch.zeros(shape) if leaf == "mean" else torch.ones(shape)
    if leaf == "embedding":  # nn.Embed: a plain normal, variance 1 / features (the last axis)
        return torch.randn(shape, generator=gen, dtype=torch.float64).float() * shape[-1] ** -0.5
    if _ZEROS.match(leaf):
        return torch.zeros(shape)
    if _ONES.match(leaf) or leaf == "w" and len(shape) == 1:
        return torch.ones(shape)
    if _QUARTER.match(leaf):
        return torch.full(shape, 0.25)
    if leaf in _NORMAL_002:
        return torch.randn(shape, generator=gen, dtype=torch.float64).float() * 0.02
    return _lecun_normal(shape, gen)


def init_params(model: torch.nn.Module, seed: int = 0) -> dict:
    """A state dict for `model` drawn at flax's initializer scales from a
    torch.Generator seeded by `seed`: each leaf in the JAX package's name
    and layout (`runtime/convert.py::flat_params`), in sorted name order,
    then converted back; BatchNorm statistics start at flax's mean 0 and
    variance 1. The draws are not jax.random's (another generator), their
    distributions are. The trainer and the recipes (`train/recipes.py`)
    both draw here."""
    name = type(model).__name__
    flat = flat_params(name, model)
    gen = torch.Generator().manual_seed(seed)
    drawn = {k: _flax_leaf(k, v.shape, gen).numpy() for k, v in sorted(flat.items())}
    return CONVERTERS[name](unflatten(drawn))


class SeparationTrainer:
    """model: a separator module with (B, T) -> (B, S, T) forward (MossFormer2
    or a zoo class). `params`: its state dict (`runtime/convert.py` makes
    one from a JAX tree), or None for a seeded draw at flax's scales. The
    mesh is `mesh` if given, else `make_mesh(cfg.n_devices, device)`: the
    first n visible cards (raising when fewer are visible), or n CPU slots
    on the CPU; the model lives on slot 0."""

    def __init__(self, model, params=None, cfg: TrainConfig | None = None, seed: int = 0,
                 example_seconds: float = 1.0, device: str | torch.device = "cuda", mesh=None):
        # example_seconds sized the JAX trainer's init; the modules here know their shapes
        self.cfg = cfg or TrainConfig()
        self.mesh = mesh if mesh is not None else make_mesh(self.cfg.n_devices, device)
        self.device = self.mesh[0]
        self.step = 0
        if params is None:
            params = init_params(model, seed)
        model.load_state_dict(params, strict=True)
        # no dropout or batch statistics: the JAX trainer's deterministic apply
        self.model = model.to(device=self.device, dtype=torch.float32).eval()
        prepare_kernels(self.model)
        self.replicas = replicated(self.mesh, self.model)
        self.params = dict(self.model.named_parameters())
        self.opt = make_optimizer(self.cfg.optimizer, self.cfg.learning_rate,
                                  self.cfg.weight_decay, self.cfg.grad_clip)
        self.state = {"params": self.params, "opt": self.opt.init(list(self.params.values()))}

    # ---------------- steps ----------------

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    def _place(self, batch: dict) -> list:
        """`batch` as one shard a slot, each on its slot; raises when the
        mesh size does not divide the batch."""
        return shard_batch(self.mesh, {k: np.asarray(v, np.float32) for k, v in batch.items()})

    def _on_slots(self, fn, shards: list) -> list:
        """[fn(i, shard_i)]: in the caller's thread on one slot, else in the
        slots' workers."""
        if len(self.mesh) == 1:
            return [fn(0, shards[0])]
        return self.mesh.map(fn, shards)

    def _loss(self, est, src):
        if self.cfg.loss == "mixit":
            return mixit_loss(est, src)
        return pit_si_sdr_loss(est, src)

    def _slot_loss_and_grads(self, i: int, shard: dict) -> tuple[torch.Tensor, list]:
        model = self.replicas[i]
        params = list(model.parameters())
        loss = self._loss(model(shard["mix"]), shard["src"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def loss_and_grads(self, batch: dict) -> tuple[torch.Tensor, list]:
        """The loss of `batch` and its gradient for every parameter, in
        `self.params`' order (zeros for a parameter the forward leaves out),
        on slot 0: over several slots the means of the shards' losses and
        gradients."""
        out = self._on_slots(self._slot_loss_and_grads, self._place(batch))
        if len(out) == 1:
            return out[0]
        loss = torch.stack([loss.to(self.device) for loss, _ in out]).mean()
        return loss, self.mesh.reduce_mean([grads for _, grads in out])

    def _sync(self) -> None:
        """Slot 0's parameters into every replica, then every slot's kernel
        operands made again."""
        with torch.no_grad():
            for replica in self.replicas[1:]:
                for p, q in zip(replica.parameters(), self.params.values()):
                    p.copy_(q)
        for replica in self.replicas:
            prepare_kernels(replica)

    def train_step(self, batch: dict) -> dict:
        """One optimizer step; returns the loss and the unclipped gradient's
        global norm (device tensors)."""
        return self.apply_gradients(*self.loss_and_grads(batch))

    def apply_gradients(self, loss: torch.Tensor, grads: list) -> dict:
        """The optimizer step for `grads` (in `self.params`' order, on slot
        0), the parameters copied into every replica; returns `loss` and
        the gradient's global norm."""
        params = list(self.params.values())
        with torch.no_grad():
            updates, self.state["opt"] = self.opt.update(grads, self.state["opt"], params)
            apply_updates(params, updates)
            gnorm = global_norm(grads)
        self._sync()
        return {"loss": loss, "grad_norm": gnorm}

    def fit(self, batches, steps: int | None = None, log_every: int = 10,
            log_fn=print) -> list:
        history = []
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            metrics = self.train_step(batch)
            self.step += 1
            if self.step % log_every == 0:
                entry = {"step": self.step, **{k: float(v) for k, v in metrics.items()}}
                history.append(entry)
                log_fn(f"step {entry['step']}: loss={entry['loss']:.3f} "
                       f"grad_norm={entry['grad_norm']:.3f}")
            if self.cfg.save_every and self.step % self.cfg.save_every == 0:
                self.save()
        return history

    def evaluate(self, batches) -> float:
        """The mean over `batches` of the PIT SI-SDR loss, each batch's the
        mean over the slots' shards."""
        def shard_loss(i, b):
            return float(pit_si_sdr_loss(self.replicas[i](b["mix"]), b["src"]))

        losses = []
        with torch.no_grad():
            for batch in batches:
                losses.append(float(np.mean(self._on_slots(shard_loss, self._place(batch)))))
        return float(np.mean(losses)) if losses else float("nan")

    # ---------------- checkpoint / resume ----------------

    def save(self, path: str | None = None) -> str:
        path = path or self.cfg.checkpoint_dir
        os.makedirs(path, exist_ok=True)
        save_pytree(path, self.state)  # parameters and optimizer state, by leaf order
        with open(os.path.join(path, "trainer.json"), "w") as f:
            json.dump({"step": self.step, "model_name": type(self.model).__name__,
                       "model_args": self._model_args()}, f)
        return path

    def restore(self, path: str | None = None) -> int:
        path = path or self.cfg.checkpoint_dir
        restored = restore_pytree(path, self.state)
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(restored["params"][name])
        self.state["opt"] = restored["opt"]
        self._sync()
        with open(os.path.join(path, "trainer.json")) as f:
            self.step = json.load(f)["step"]
        return self.step

    def _model_args(self) -> dict:
        """The constructor arguments the model keeps as scalar attributes."""
        names = inspect.signature(type(self.model).__init__).parameters
        return {k: getattr(self.model, k) for k in names
                if isinstance(getattr(self.model, k, None), (int, float, str, bool))}

    def export_inference_checkpoint(self, path: str) -> str:
        """A params-only checkpoint in the JAX package's layout, which both
        packages' `from_pretrained` load."""
        save_checkpoint(path, self.model, type(self.model).__name__, self._model_args())
        return path
