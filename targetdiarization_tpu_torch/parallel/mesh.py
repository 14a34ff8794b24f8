"""Data parallelism over cards: the mesh, its replicas and row shards.

Counterpart of targetdiarization_tpu/parallel/mesh.py. There one SPMD
program runs on a 1-D `data` mesh and XLA splits its rows over the
devices. Here one process keeps a replica of the model on every slot of
the mesh and runs each slot's rows in a worker thread of its own:

- inference: the rows are split into equal contiguous shards in slot
  order, each shard runs on its slot's replica, and the outputs are joined
  in row order (`pjit_forward`). No collective is needed.
- training: each slot takes the loss and gradient of its shard, and the
  shards' gradients are averaged onto slot 0 (`Mesh.reduce_mean`): for a
  loss that is a mean over rows, the whole batch's gradient, as XLA's
  all-reduce gives it. The reference trains through Lightning's DDP.

A mesh is an ordered tuple of `torch.device` slots. `make_mesh` takes the
first n visible cards and never falls back to the CPU; a mesh of n CPU
slots is asked for explicitly (`make_mesh(n, device="cpu")`), as the JAX
tests use 8 virtual CPU devices. A slot may repeat a card only where the
caller lists the slots itself (`Mesh(["cuda:0", "cuda:0"])`): two
replicas on one card run the sharding, the row padding and the gradient
reduction without copies between cards.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from ..ops.kernels import prepare_kernels

_SLOT = threading.local()  # the slot a mesh worker thread runs, if any


def _card(device) -> torch.device:
    """`device` with the index a bare "cuda" means: the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh(tuple):
    """An ordered tuple of `torch.device` slots, all of one type, with one
    worker thread per slot (started at its first call)."""

    def __new__(cls, slots):
        slots = tuple(_card(s) for s in slots)
        if not slots:
            raise ValueError("a mesh needs at least one slot")
        if len({s.type for s in slots}) > 1:
            raise ValueError(f"a mesh's slots are of one device type, got {slots}")
        mesh = super().__new__(cls, slots)
        mesh._workers = [None] * len(slots)
        mesh._lock = threading.Lock()
        return mesh

    @property
    def size(self) -> int:
        return len(self)

    def _worker(self, i: int) -> ThreadPoolExecutor:
        with self._lock:
            if self._workers[i] is None:
                self._workers[i] = ThreadPoolExecutor(1, thread_name_prefix=f"mesh-slot{i}")
            return self._workers[i]

    def close(self) -> None:
        """Stops the slots' worker threads; a later call starts them again."""
        with self._lock:
            workers, self._workers = self._workers, [None] * len(self)
        for w in workers:
            if w is not None:
                w.shutdown(wait=True)

    def map(self, fn, *per_slot) -> list:
        """[fn(i, *args_i) for each slot i], where args_i takes the i-th item
        of each of `per_slot`. Each call runs in its slot's worker thread, as
        the caller's thread would run it: under the caller's grad and
        inference modes and, on a card, with the slot's card current (and
        so its current stream). Waits for every slot, then raises the
        first slot's error, if any."""
        if getattr(_SLOT, "index", None) is not None:
            raise RuntimeError("a mesh call from inside a mesh slot would wait on its own worker")
        inference, grad = torch.is_inference_mode_enabled(), torch.is_grad_enabled()

        def run(i, args):
            _SLOT.index = i
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                        (torch.cuda.device(self[i]) if self[i].type == "cuda"
                         else contextlib.nullcontext()):
                    return fn(i, *args)
            finally:
                _SLOT.index = None

        futures = [self._worker(i).submit(run, i, tuple(a[i] for a in per_slot))
                   for i in range(len(self))]
        wait(futures)
        return [f.result() for f in futures]

    def reduce_mean(self, per_slot: list) -> list:
        """The mean over slots of lists of tensors (one list a slot, alike in
        shapes), on slot 0's device: the slots of each card summed there,
        then the cards' sums reduced onto slot 0's card (`torch.cuda.comm`'s
        coalesced reduce when there are several cards), then divided by the
        slot count."""
        by_card: dict = {}
        for dev, tensors in zip(self, per_slot):
            part = by_card.get(dev)
            by_card[dev] = list(tensors) if part is None else [a + b for a, b in
                                                                zip(part, tensors)]
        sums = [by_card[d] for d in dict.fromkeys(self)]  # slot order; slot 0's card first
        if len(sums) == 1:
            total = sums[0]
        else:
            total = torch.cuda.comm.reduce_add_coalesced(sums, destination=self[0].index)
        return [t / len(self) for t in total]


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A mesh of the first `n_devices` visible cards (all of them by
    default); raises when fewer are visible. With `device="cpu"`, a mesh
    of `n_devices` CPU slots (one by default)."""
    device = torch.device(device)
    if device.type == "cpu":
        return Mesh([device] * (1 if n_devices is None else n_devices))
    if device.type != "cuda":
        raise ValueError(f"a mesh is of cuda or cpu slots, not {device.type}")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n < 1 or n > visible:
        raise ValueError(f"a mesh of {n} cards was asked for, and {visible} are visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


# ---------------- trees of tensors ----------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _split(mesh: Mesh, batch) -> list:
    """Every leaf of `batch` cut into the slots' row ranges, one tree a slot."""
    rows = {len(x) for x in _leaves(batch)}
    if len(rows) != 1:
        raise ValueError(f"the leaves of a batch differ in their row counts: {sorted(rows)}")
    return [_tree_map(lambda x, r=r: x[r], batch) for _, r in batch_sharding(mesh, rows.pop())]


def _place(tree, device: torch.device):
    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return _tree_map(put, tree)


def _join(outputs: list, device: torch.device):
    """The slots' outputs (trees alike in structure) as one tree, each leaf
    the slots' leaves concatenated in slot order on `device`."""
    flat = [_leaves(o) for o in outputs]
    joined = iter([torch.cat([f[j].to(device) for f in flat]) for j in range(len(flat[0]))])
    return _tree_map(lambda _: next(joined), outputs[0])


# ---------------- the JAX package's names ----------------


def batch_sharding(mesh: Mesh, rows: int) -> list:
    """Where the rows of a batch of `rows` rows go: (slot device, row slice)
    a slot, equal contiguous ranges in slot order. Raises when the mesh
    size does not divide `rows`."""
    if rows % len(mesh):
        raise ValueError(f"batch size {rows} not divisible by mesh size {len(mesh)}")
    per = rows // len(mesh)
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(mesh)]


def replicated(mesh: Mesh, obj) -> tuple:
    """`obj` on every slot of the mesh: slot 0 gets `obj` itself, which must
    be on slot 0's device; every other slot a copy placed on its slot with
    kernel operands of its own (`prepare_kernels`). `obj` is a module, or
    an engine (an object with `model` and `device`), which is copied
    shallowly with its model replicated, its tensors moved and no
    micro-batcher of its own (the replicas are run by the mesh)."""
    module = obj if isinstance(obj, torch.nn.Module) else obj.model
    here = obj.device if module is not obj else next(
        (p.device for p in module.parameters()), mesh[0])
    if _card(here) != mesh[0]:
        raise ValueError(f"slot 0 is {mesh[0]}, and the model to replicate is on {here}")
    replicas = [obj]
    for dev in mesh[1:]:
        model = copy.deepcopy(module).to(dev)
        prepare_kernels(model)
        if module is obj:
            replicas.append(model)
            continue
        rep = copy.copy(obj)
        rep.device, rep.model = dev, model
        for name, value in vars(obj).items():
            if isinstance(value, torch.Tensor) or (
                    isinstance(value, tuple) and value
                    and all(isinstance(v, torch.Tensor) for v in value)):
                setattr(rep, name, _place(value, dev))
        if getattr(rep, "_mb", None) is not None:
            rep._mb = None
        replicas.append(rep)
    return tuple(replicas)


def shard_batch(mesh: Mesh, batch) -> list:
    """`batch` (a tensor or array, or a dict, list or tuple of them, all with
    the same leading dimension) as equal contiguous row shards in slot
    order, each placed on its slot: one shard a slot. The leading dimension
    must be divisible by the mesh size; callers pad first
    (`SeparationEngine._pad_rows`)."""
    return [_place(shard, dev) for shard, dev in zip(_split(mesh, batch), mesh)]


def pjit_forward(fn, mesh: Mesh):
    """A row-sharded forward: for fn(replica, *batch) -> out (a tensor, or a
    dict, list or tuple of tensors, rows first), returns run(replicas,
    *batch), where `replicas` is `replicated(mesh, model)`. Shard i of the
    batch runs fn(replicas[i], *shard_i) in slot i's worker, on slot i's
    device; the outputs are joined in row order on slot 0's device."""

    def run(replicas, *batch):
        outs = mesh.map(lambda i, shard: fn(replicas[i], *_place(shard, mesh[i])),
                        _split(mesh, batch))
        return _join(outs, mesh[0])

    return run


def data_parallel_step(loss_fn, update_fn, mesh: Mesh):
    """A training step over the mesh, as the JAX `data_parallel_step` wraps a
    (state, batch) -> (state, metrics) step: returns run(state, batch) ->
    (state, metrics). `state` is a tree (dict, list, tuple) of tensors on
    slot 0; every slot gets a copy of it (its floating tensors as leaves
    that record gradients) and the shard of `batch` in its slot order, and
    takes loss_fn(state_i, shard_i), a scalar that is a mean over the
    shard's rows, and its gradient for every floating tensor of the state.
    The shards' gradients are averaged onto slot 0 (`Mesh.reduce_mean`) into
    a tree like `state` (None at the tensors that are not floating), and
    update_fn(state, grads) -> state runs there without grad. metrics:
    {"loss": the mean of the shards' losses}."""

    def slot_grads(i, state, shard):
        dev = mesh[i]

        def leaf(t):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                return t.detach().to(dev).requires_grad_()
            return t.to(dev) if isinstance(t, torch.Tensor) else t

        local = _tree_map(leaf, state)
        wanted = [t for t in _leaves(local) if isinstance(t, torch.Tensor) and t.requires_grad]
        loss = loss_fn(local, _place(shard, dev))
        grads = torch.autograd.grad(loss, wanted, allow_unused=True)
        return loss.detach(), [torch.zeros_like(w) if g is None else g
                               for w, g in zip(wanted, grads)]

    def run(state, batch):
        with torch.enable_grad():
            out = mesh.map(slot_grads, [state] * len(mesh), _split(mesh, batch))
        mean = iter(mesh.reduce_mean([g for _, g in out]))
        grads = _tree_map(lambda t: next(mean) if isinstance(t, torch.Tensor)
                          and t.is_floating_point() else None, state)
        with torch.no_grad():
            new_state = update_fn(state, grads)
        return new_state, {"loss": torch.stack([loss.to(mesh[0]) for loss, _ in out]).mean()}

    return run
