"""Constant tables made on the host (windows, filterbanks, filter
responses), each uploaded once per device.

A front-end call otherwise uploads the same tables on every call, and
each upload from pageable memory waits for the copy.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=128)
def device_table(make, args: tuple, device: torch.device) -> torch.Tensor:
    """`make(*args)` (a numpy array) as a tensor on `device`; `make` and
    `args` must be hashable and `make` deterministic."""
    return torch.as_tensor(make(*args)).to(device)
