"""Separation evaluation metrics and the CSV report.

Counterpart of targetdiarization_tpu/train/metrics.py: per-example
SI-SNR(i), SDR(i), STOI and PESQ (`train/perceptual.py`) and a CSV
report (the reference's metrics wrapper). With `asr_engine` set (any
object with the `asr_detection(audio, sr)` contract) each row also logs
the transcripts of the estimate and of the reference; with
`mos_estimator` / `sigmos_estimator` set (objects with the JAX package's
`train/mos.py` call contracts) the DNSMOS and SigMOS columns. The legacy
band-correlation `stoi_proxy` stays for recorded CSVs.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from .losses import si_sdr, snr
from .perceptual import pesq as _pesq, stoi as _stoi


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def sdr(est, ref) -> float:
    """Plain SDR (SNR of the residual against the reference)."""
    return float(torch.mean(snr(_t(est), _t(ref))))


def si_snr(est, ref) -> float:
    return float(torch.mean(si_sdr(_t(est), _t(ref))))


def si_snr_i(est, ref, mix) -> float:
    """SI-SNR improvement over the unprocessed mixture."""
    base = si_snr(np.broadcast_to(np.asarray(mix), np.asarray(ref).shape), ref)
    return si_snr(est, ref) - base


def sdr_i(est, ref, mix) -> float:
    base = sdr(np.broadcast_to(np.asarray(mix), np.asarray(ref).shape), ref)
    return sdr(est, ref) - base


def stoi_proxy(est, ref, sr: int = 16000) -> float:
    """Short-time octave-band envelope correlation in [0, 1] — an
    intelligibility proxy in the spirit of STOI (not the licensed
    reference implementation)."""
    from ..ops.stft import stft

    n_fft, hop = 512, 128
    e = torch.abs(stft(_t(est), n_fft, hop)).numpy()
    r = torch.abs(stft(_t(ref), n_fft, hop)).numpy()
    # 15 one-third-octave-ish log-spaced bands from 150 Hz
    edges = np.unique(
        (np.geomspace(150, sr / 2 * 0.9, 16) / (sr / 2) * (n_fft // 2)).astype(int)
    )
    cors = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi <= lo:
            continue
        eb = e[lo:hi].sum(axis=0)
        rb = r[lo:hi].sum(axis=0)
        if eb.std() < 1e-9 or rb.std() < 1e-9:
            continue
        cors.append(np.corrcoef(eb, rb)[0, 1])
    if not cors:
        return 0.0
    return float(np.clip(np.mean(cors), 0.0, 1.0))


class MetricsTracker:
    """Accumulate per-example metrics and write a CSV report.

    With `asr_engine` set (any object with the ASREngine
    `asr_detection(audio, sr)` contract), each row also logs the transcript
    of the estimate and of the reference. With `mos_estimator` (called as
    `est(audio, sr)`, returning "OVRL", "SIG", "BAK" and "P808_MOS") or
    `sigmos_estimator` (`.run(audio, sr=)`, returning the SigMOS scores)
    set, each row also logs the DNSMOS P.835 and SigMOS P.804 scores of the
    estimate: the JAX package's `train/mos.py` estimators fit, duck-typed."""

    FIELDS = ("key", "si_snr", "si_snr_i", "sdr", "sdr_i", "stoi", "pesq")
    ASR_FIELDS = ("transcript_est", "transcript_ref")
    MOS_FIELDS = ("dnsmos_ovrl", "dnsmos_sig", "dnsmos_bak", "dnsmos_p808")
    SIGMOS_FIELDS = ("mos_col", "mos_disc", "mos_loud", "mos_noise",
                     "mos_reverb", "mos_sig", "mos_ovrl")

    def __init__(self, save_path: str | None = None, asr_engine=None,
                 sample_rate: int = 16000, mos_estimator=None,
                 sigmos_estimator=None):
        self.rows: list = []
        self.save_path = save_path
        self.asr_engine = asr_engine
        self.sample_rate = sample_rate
        self.mos_estimator = mos_estimator
        self.sigmos_estimator = sigmos_estimator

    def _transcribe(self, audio) -> str:
        try:
            res = self.asr_engine.asr_detection(
                np.asarray(audio, np.float32).ravel(), self.sample_rate)
            return "".join(r.get("text", "") for r in res)
        except Exception:
            return ""

    def update(self, key: str, est, ref, mix):
        row = {
            "key": key,
            "si_snr": round(si_snr(est, ref), 3),
            "si_snr_i": round(si_snr_i(est, ref, mix), 3),
            "sdr": round(sdr(est, ref), 3),
            "sdr_i": round(sdr_i(est, ref, mix), 3),
            "stoi": round(_stoi(np.asarray(ref).ravel(),
                               np.asarray(est).ravel()), 3),
            "pesq": round(_pesq(np.asarray(ref).ravel(),
                               np.asarray(est).ravel()), 3),
        }
        if self.asr_engine is not None:
            row["transcript_est"] = self._transcribe(est)
            row["transcript_ref"] = self._transcribe(ref)
        if self.mos_estimator is not None:
            d = self.mos_estimator(np.asarray(est, np.float32).ravel(),
                                   self.sample_rate)
            row["dnsmos_ovrl"] = round(d["OVRL"], 3)
            row["dnsmos_sig"] = round(d["SIG"], 3)
            row["dnsmos_bak"] = round(d["BAK"], 3)
            row["dnsmos_p808"] = round(d["P808_MOS"], 3)
        if self.sigmos_estimator is not None:
            s = self.sigmos_estimator.run(
                np.asarray(est, np.float32).ravel(), sr=self.sample_rate)
            for k, v in s.items():
                row[k.lower()] = round(v, 3)
        self.rows.append(row)
        return row

    def _fields(self):
        return (self.FIELDS
                + (self.MOS_FIELDS if self.mos_estimator is not None else ())
                + (self.SIGMOS_FIELDS
                   if self.sigmos_estimator is not None else ())
                + (self.ASR_FIELDS if self.asr_engine is not None else ()))

    def summary(self) -> dict:
        if not self.rows:
            return {}
        return {
            f: round(float(np.mean([r[f] for r in self.rows])), 3)
            for f in self._fields()
            if f != "key" and f not in self.ASR_FIELDS
        }

    def write_csv(self, path: str | None = None) -> str:
        path = path or self.save_path
        if not path:
            raise ValueError("no CSV path given")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fields = self._fields()
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            writer.writerows(self.rows)
            summary = {"key": "mean", **self.summary()}
            writer.writerow(summary)
        return path
