"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper dispatches by device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its kernel launches in its `launches` attribute.
"""
