"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper dispatches by device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its kernel launches in its `launches` attribute.
"""


def prepare_kernels(model) -> None:
    """Has every module of `model` that owns a kernel's weights make the
    kernel's operands once (`prepare_kernel`), in the type and on the card
    the module has now; an engine calls it after placing its model. The
    operands are copies or addresses of the weights as they are then: the
    model's weights are frozen from here on, and a model loaded, moved or
    cast afterwards needs this call again (on the card a type or device
    that no longer matches raises; new values in place go unseen)."""
    for module in model.modules():
        prepare = getattr(module, "prepare_kernel", None)
        if prepare is not None:
            prepare()
