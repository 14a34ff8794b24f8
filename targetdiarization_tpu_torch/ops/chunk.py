"""Fixed-shape windowed chunking and overlap-add reconstruction.

Copy of targetdiarization_tpu/ops/chunk.py in PyTorch: a signal is padded
to a whole number of windows and sliced into one batch of chunks, and the
chunks' outputs are added back with a window and divided by the summed
window.
"""

from __future__ import annotations

import numpy as np
import torch


def _starts(n_chunks: int, window: int, hop: int, device) -> torch.Tensor:
    return (torch.arange(window, device=device)[None, :]
            + hop * torch.arange(n_chunks, device=device)[:, None])


def chunk_signal(x: torch.Tensor, window: int, hop: int | None = None) -> tuple[torch.Tensor, int]:
    """(..., T) -> ((..., n_chunks, window), T), chunks every `hop` samples;
    n_chunks = max(1, ceil((T - window) / hop) + 1), zero padding at the end."""
    hop = hop or window
    n = x.shape[-1]
    n_chunks = max(1, -(-max(n - window, 0) // hop) + 1)
    padded_len = (n_chunks - 1) * hop + window
    x = torch.nn.functional.pad(x, (0, padded_len - n))
    return x[..., _starts(n_chunks, window, hop, x.device)], n


def merge_chunks(chunks: torch.Tensor, length: int, hop: int | None = None,
                 window_fn: str = "rect") -> torch.Tensor:
    """Overlap-add (..., n_chunks, window) back to (..., length). window_fn:
    "rect" (the plain mean where chunks overlap) or "tri" (a triangular
    cross-fade)."""
    n_chunks, window = chunks.shape[-2], chunks.shape[-1]
    hop = hop or window
    out_len = (n_chunks - 1) * hop + window
    if window_fn == "tri":
        w = np.minimum(np.arange(1, window + 1), np.arange(window, 0, -1)).astype(np.float32)
        w /= w.max()
    else:
        w = np.ones(window, dtype=np.float32)
    wt = torch.from_numpy(w).to(chunks.device)
    idx = _starts(n_chunks, window, hop, chunks.device).reshape(-1)
    lead = chunks.shape[:-2]
    num = torch.zeros(lead + (out_len,), dtype=chunks.dtype, device=chunks.device)
    num.index_add_(-1, idx, (chunks * wt).reshape(lead + (-1,)))
    den = torch.zeros(out_len, dtype=torch.float32, device=chunks.device)
    den.index_add_(0, idx, wt.repeat(n_chunks))
    return (num / torch.clamp_min(den, 1e-8))[..., :length]
