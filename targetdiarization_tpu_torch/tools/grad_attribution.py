"""Where step 1's gradient of the 512/24 separator departs from plain.

chip_smoke.py's train phase holds step 1's gradient with the kernels
against the plain path. This script splits the departure: the same step
with each kernel's forward alone on the card (the others plain, all
backwards the card's), with the Functions on plain forwards (the backward
alone), and the plain path with the mix scaled by 1 + eps for eps 1e-7,
1e-6 and 1e-5 (how far float32 noise at the input moves this
checkpoint's gradient). Each line gives the loss's and the grad norm's
relative departure and the flattened gradients' cosine. Run from the
repository root on a machine with one card:

    python3 -m targetdiarization_tpu_torch.tools.grad_attribution

It sets up the trainer as chip_smoke.py does (`sep-bootstrap-512`,
float32, the bootstrap recipe's settings, batch 8 of 1 s, seed 0).
"""

from __future__ import annotations

import json

import numpy as np

KERNELS = ("ffconvm", "flash_gated", "dwconv")


def main() -> None:
    import chip_smoke
    from ..runtime.registry import from_pretrained
    from ..train import SeparationTrainer, TrainConfig
    from ..train.data import DynamicMixDataset, MixConfig

    torch = chip_smoke.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.environment()["nvidia_smi"], flush=True)
    model = from_pretrained(chip_smoke.CHECKPOINT)
    trainer = SeparationTrainer(model, params=model.state_dict(), device="cuda",
                                cfg=TrainConfig(**chip_smoke.TRAIN_SETTINGS))
    batch = next(DynamicMixDataset(chip_smoke.training_speakers(), MixConfig(
        segment_seconds=1.0), seed=0).batches(8, 1))

    def step(ctx, b=batch):
        with ctx:  # a patch context takes effect when it is made: make it just before
            loss, grads = trainer.loss_and_grads(b)
        return float(loss), chip_smoke.flat_grads(grads)

    plain = step(chip_smoke.plain_kernels())
    runs = {"kernels": (), "backward alone (plain forwards)": KERNELS,
            **{f"{name} forward alone": tuple(k for k in KERNELS if k != name)
               for name in KERNELS}}
    for label, plain_ones in runs.items():
        agree = chip_smoke.grad_agreement(step(chip_smoke.plain_forwards(plain_ones)), plain)
        print(json.dumps({"run": label, **agree}), flush=True)
    for eps in (1e-7, 1e-6, 1e-5):
        scaled = {"mix": (np.asarray(batch["mix"], np.float64) * (1 + eps)).astype(np.float32),
                  "src": batch["src"]}
        print(json.dumps({"run": f"plain, mix x (1 + {eps:g})", **chip_smoke.grad_agreement(
            step(chip_smoke.plain_kernels(), scaled), plain)}), flush=True)


if __name__ == "__main__":
    main()
