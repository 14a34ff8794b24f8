"""Training stack: losses, data mixing, optimizers, the trainer, metrics.

Counterpart of targetdiarization_tpu/train (the reference's look2hear
training system: the Lightning module, PIT and MixIT losses, the
dynamic-mixing data module, the optimizer and scheduler factories), on
torch and one card.
"""

from .losses import (  # noqa: F401
    si_sdr,
    sd_sdr,
    snr,
    pairwise_neg_si_sdr,
    freq_mae_wav_l1,
    pit_loss,
    mixit_loss,
)
from .trainer import SeparationTrainer, TrainConfig  # noqa: F401
