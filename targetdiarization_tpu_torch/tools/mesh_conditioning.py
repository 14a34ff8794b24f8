"""Where the mesh's training gradient parts from one slot's.

A batch's gradient on one slot against the mean of its halves' gradients,
both through the kernels (`SeparationTrainer.loss_and_grads`, float32, no
TF32), for the separator checkpoint `sep-bootstrap-512`, on 8 mixes of 1 s
(the training check of `tools/dryrun_multichip.py`):

- `repeat`: the whole batch twice on one slot (run to run);
- `halves`: the two halves one after the other on one slot, their mean;
- `mesh`: the same halves on a mesh of two slots of the card, each in its
  worker thread (`Mesh.reduce_mean`), against `halves` and against the
  whole batch;
- `plain_halves`: `halves` against the whole batch with every kernel
  wrapper of the separator patched to its plain PyTorch version;
- the forward, with the kernels and plain: the estimates of the whole
  batch against those of its halves (is a row's forward the same whatever
  rows are beside it);
- the parameters whose gradients part the most, and each one's share of
  the whole gradient's squared norm.

Each comparison prints the loss and gradient-norm gaps (relative) and the
gradients' cosine. On the card, from the repository root
(`--cudnn-deterministic`: cuDNN's deterministic algorithms, as the
recipes and the mesh's training check run):

    python3 -m targetdiarization_tpu_torch.tools.mesh_conditioning [--cudnn-deterministic]
"""

from __future__ import annotations

import argparse
import json
from contextlib import ExitStack
from unittest import mock

import numpy as np


def plain_forwards() -> ExitStack:
    """The separator's kernel wrappers patched to their plain versions."""
    from ..models import separation
    from ..ops import dwconv as dwconv_op
    from ..ops.kernels.dwconv import dwconv_plain
    from ..ops.kernels.ffconvm import ffconvm_plain
    from ..ops.kernels.flash import flash_gated_plain

    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        separation, "ffconvm", lambda *a, prepared=None: ffconvm_plain(*a)))
    stack.enter_context(mock.patch.object(separation, "flash_gated", flash_gated_plain))
    stack.enter_context(mock.patch.object(
        dwconv_op, "dwconv", lambda x, k, d, pad_l, pad_r, taps=None:
        dwconv_plain(x, k, d, pad_l, pad_r)))
    return stack


def main(separator: str = "", device: str = "cuda", rows: int = 8,
         seconds: float = 1.0, deterministic: bool = False) -> None:
    import torch

    torch.backends.cudnn.deterministic = deterministic
    from ..parallel.mesh import Mesh
    from ..runtime.registry import from_pretrained
    from ..train import SeparationTrainer, TrainConfig
    from ..train.data import DynamicMixDataset, MixConfig
    from .dryrun_multichip import checkpoint, voices

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    n = int(seconds * 16000)
    pools = {"a": list(voices(3, 2 * n, 1)), "b": list(voices(3, 2 * n, 2))}
    batch = next(DynamicMixDataset(pools, MixConfig(segment_seconds=seconds),
                                   seed=0).batches(rows, 1))
    halves = [{k: v[i * rows // 2:(i + 1) * rows // 2] for k, v in batch.items()}
              for i in range(2)]
    separator = separator or checkpoint("sep-bootstrap-512")
    model = from_pretrained(separator)
    trainer = SeparationTrainer(model, params=model.state_dict(), cfg=TrainConfig(save_every=0),
                                mesh=Mesh([device]))
    names = list(trainer.params)

    def flat(grads):
        return [g.detach().double().reshape(-1) for g in grads]

    def step(b):
        loss, grads = trainer.loss_and_grads(b)
        return float(loss), flat(grads)

    def mean_of(parts):
        return (float(np.mean([p[0] for p in parts])),
                [sum(gs) / len(parts) for gs in zip(*(p[1] for p in parts))])

    def gap(a, b):
        ga, gb = torch.cat(a[1]), torch.cat(b[1])
        na, nb = float(ga.norm()), float(gb.norm())
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]), "grad_norm_rel": abs(na - nb) / nb,
                "grad_cosine": float(torch.dot(ga, gb) / (na * nb))}

    whole = step(batch)
    out = {"repeat": gap(step(batch), whole)}
    seq = mean_of([step(h) for h in halves])
    out["halves"] = gap(seq, whole)
    mesh = Mesh([device, device])
    meshed = SeparationTrainer(from_pretrained(separator),
                               params=model.state_dict(), cfg=TrainConfig(save_every=0),
                               mesh=mesh)
    loss, grads = meshed.loss_and_grads(batch)
    via_mesh = (float(loss), flat(grads))
    out["mesh_vs_halves"] = gap(via_mesh, seq)
    out["mesh_vs_whole"] = gap(via_mesh, whole)
    del meshed, grads
    mesh.close()
    with plain_forwards():
        plain_whole = step(batch)
        out["plain_halves"] = gap(mean_of([step(h) for h in halves]), plain_whole)
    mix = torch.from_numpy(batch["mix"]).to(trainer.device)

    def forward_rel():
        with torch.no_grad():
            est = trainer.model(mix)
            est_h = torch.cat([trainer.model(mix[: rows // 2]), trainer.model(mix[rows // 2:])])
        return float((est - est_h).abs().max() / est.abs().max())

    out["forward_rel"] = forward_rel()
    with plain_forwards():
        out["plain_forward_rel"] = forward_rel()
    total = float(sum(float(g.square().sum()) for g in whole[1]))
    parted = sorted(((float((a - b).norm()), name, float(b.square().sum()) / total)
                     for a, b, name in zip(seq[1], whole[1], names)), reverse=True)[:8]
    out["top_parted"] = [{"param": name, "diff_norm": d, "share_of_norm2": share}
                         for d, name, share in parted]
    out["top_share"] = sorted(({"param": name, "share_of_norm2": float(g.square().sum()) / total}
                               for g, name in zip(whole[1], names)),
                              key=lambda r: -r["share_of_norm2"])[:5]
    out["device"] = torch.cuda.get_device_name(0) if device == "cuda" else device
    out["cudnn_deterministic"] = deterministic
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cudnn-deterministic", action="store_true")
    main(deterministic=parser.parse_args().cudnn_deterministic)
