"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper dispatches by device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its kernel launches in its `launches` attribute. Where autograd records a
call (grad mode on and an input needing a gradient) the wrapper goes
through its `torch.autograd.Function`, whose forward is that same call and
whose backward follows the JAX package's custom VJP: FFConvM and FLASH
recompute their plain versions (`grads_by_recompute`), dwconv launches its
kernel again for dx.
"""

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Adds one to `wrapper.<counter>` under a lock. The slots of a mesh
    (`parallel/mesh.py`) launch from several threads at once, and `+=` on
    an attribute is a read and a write that two threads can interleave."""
    with _COUNT_LOCK:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def prepare_kernels(model) -> None:
    """Has every module of `model` that owns a kernel's weights make the
    kernel's operands once (`prepare_kernel`), in the type and on the card
    the module has now; an engine calls it after placing its model, a
    trainer after every optimizer step. The operands are copies or
    addresses of the weights as they are then, and record each weight's
    version: on the card a call after a weight changed in place (an
    optimizer step, `load_state_dict`) raises, naming the module, and a
    model loaded, moved or cast afterwards raises on a type or device that
    no longer matches. Either needs this call again."""
    for name, module in model.named_modules():
        prepare = getattr(module, "prepare_kernel", None)
        if prepare is not None:
            prepare(name or type(module).__name__)


def check_fresh(ops) -> None:
    """Raises if a tensor that the kernel operands `ops` were made from has
    changed in place since (`ops.tracked()`: (tensor, version) pairs)."""
    for source, version in ops.tracked():
        if source._version != version:
            raise RuntimeError(
                f"the kernel operands of {ops.owner or 'a module'} were made from a "
                f"{tuple(source.shape)} weight that has changed in place since; call "
                "ops.kernels.prepare_kernels(model) again after changing weights")


def grads_by_recompute(plain, saved, needs, grad_outputs):
    """The gradients of `plain(*saved)` for the inputs whose `needs` is
    True (None for the others), by running the plain version again under
    autograd: the JAX package's backward of its fused kernels (`jax.vjp`
    of the reference formulation)."""
    import torch

    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*inputs)
    wanted = [t for t, n in zip(inputs, needs) if n]
    grads = iter(torch.autograd.grad(out, wanted, grad_outputs) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)
