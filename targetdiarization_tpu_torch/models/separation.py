"""MossFormer2 speech separation and the windowed separation engine, in PyTorch.

Counterpart of targetdiarization_tpu/models/separation.py. The layout is
time-major (B, T, C) throughout, as in the JAX package. The two Pallas
kernels of the JAX model become the port's CUDA kernels: every FFConvM
runs `ops.kernels.ffconvm` (five per FLASH + FSMN layer pair) and every
FlashBlock runs `ops.kernels.flash_gated` once. The 24 scanned layer
pairs of the JAX model are a Python loop over an `nn.ModuleList`.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dwconv import dw_conv1d
from ..ops.kernels import prepare_kernels
from ..ops.kernels.dwconv import prepare_taps
from ..ops.kernels.ffconvm import TAPS, ffconvm, prepare_ffconvm, scale_norm
from ..ops.kernels.flash import flash_gated
from ..ops.resample import resample_poly_np
from ..parallel.mesh import pjit_forward, replicated
from ..runtime import microbatch
from ..runtime.buckets import BucketLadder
from ..runtime.precision import promote_after, resolve_compute_dtype
from ..runtime.trace import trace
from ..utils.native import integrated_loudness_native


# ---------------- small pieces ----------------


class ScaleNorm(nn.Module):
    """x / max(||x|| d^-1/2, eps) * g."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return scale_norm(x, self.g, self.eps)


def masked_global_layer_norm(x, mask, weight, bias, eps: float = 1e-8):
    """Normalise over (T, C) jointly, counting only mask == 1 frames. Op
    for op the JAX model's formula, so each op computes in the type of its
    operands as there: a bf16 stream with a bf16 mask rounds every step to
    bf16 (as XLA does), a float32 stream with a bf16 mask counts frames in
    bf16 and computes the statistics in float32."""
    m = mask[..., None]
    denom = torch.clamp_min(m.sum(dim=(1, 2), keepdim=True) * x.shape[-1], 1.0)
    mean = (x * m).sum(dim=(1, 2), keepdim=True) / denom
    var = ((x - mean).square() * m).sum(dim=(1, 2), keepdim=True) / denom
    return (weight * (x - mean) / torch.sqrt(var + eps) + bias) * m


class GlobalLayerNorm(nn.Module):
    """gLN over time and channels with affine parameters."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        return masked_global_layer_norm(x, mask, self.weight, self.bias, self.eps)


class FFConvM(nn.Module):
    """norm -> Linear -> SiLU -> h + depthwise 17-tap conv of h, in one
    kernel (`ops.kernels.ffconvm`). `norm` is "scalenorm" (FLASH blocks)
    or "layernorm" (the gated FSMN's to_u / to_v). The depthwise kernel
    keeps the JAX layout (17, 1, dim_out). `prepare_kernel` makes the
    kernel's operands once, for the type and card the module has then."""

    def __init__(self, dim_in: int, dim_out: int, norm: str = "scalenorm"):
        super().__init__()
        self.norm_kind = norm
        self.norm = ScaleNorm() if norm == "scalenorm" else nn.LayerNorm(dim_in, eps=1e-5)
        self.proj = nn.Linear(dim_in, dim_out)
        self.dwk = nn.Parameter(torch.zeros(TAPS, 1, dim_out))
        self.kernel_ops = None

    def _norm_params(self):
        if self.norm_kind == "scalenorm":
            return self.norm.g, self.norm.g.new_zeros(1)
        return self.norm.weight, self.norm.bias

    def prepare_kernel(self, owner: str = ""):
        self.kernel_ops = prepare_ffconvm(*self._norm_params(), self.proj.weight, self.proj.bias,
                                          self.dwk, self.norm_kind, self.proj.weight.dtype,
                                          owner=owner)

    def forward(self, x):
        return ffconvm(x, *self._norm_params(), self.proj.weight, self.proj.bias, self.dwk,
                       self.norm_kind, prepared=self.kernel_ops)


def rope_rotate(x, rot_dims: int = 32):
    """Rotary embedding on the first `rot_dims` dims (GPT-J partial RoPE).
    The float32 tables promote a reduced-type x to float32, as in JAX."""
    t = x.shape[-2]
    d = min(rot_dims, x.shape[-1])
    d -= d % 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    angles = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :d].float(), x[..., d:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.reshape(x_rot.shape), x_pass.to(rot.dtype)], dim=-1)


# ---------------- FLASH shared-A gated attention ----------------


class FlashBlock(nn.Module):
    """Gated single-head attention with joint local-quadratic and
    global-linear terms sharing one A matrix (FLASH ShareA)."""

    def __init__(self, dim: int, group_size: int = 256, qk_dim: int = 128,
                 expansion_factor: float = 4.0):
        super().__init__()
        hidden = int(dim * expansion_factor)
        self.group_size = group_size
        self.to_hidden = FFConvM(dim, hidden)
        self.to_qk = FFConvM(dim, qk_dim)
        # stored as in the JAX checkpoints: gamma is applied as os_gamma + 1
        self.os_gamma = nn.Parameter(torch.zeros(4, qk_dim))
        self.os_beta = nn.Parameter(torch.zeros(4, qk_dim))
        self.to_out = FFConvM(hidden // 2, dim)

    def forward(self, x, mask):
        b, t, d = x.shape
        half = d // 2
        # token shift: first half of the channels delayed by one frame
        x_shift = F.pad(x[..., :half], (0, 0, 1, 0))[:, :-1]
        shifted = torch.cat([x_shift, x[..., half:]], dim=-1)

        v, u = self.to_hidden(shifted).chunk(2, dim=-1)
        qk = self.to_qk(shifted)
        qk4 = qk[..., None, :] * (self.os_gamma + 1.0) + self.os_beta  # (B, T, 4, d)
        quad_q, lin_q, quad_k, lin_k = map(rope_rotate, qk4.unbind(dim=-2))
        lin_k = lin_k * mask[..., None]

        g = self.group_size
        n_groups = t // g  # t is padded to a multiple of g by the caller
        e = v.shape[-1]
        # the attention in the promoted type of q and v: float32 for a
        # reduced-type stream (its q and k come float32 from the rotary
        # tables), the output back in v's type, as in JAX
        dt = torch.promote_types(quad_q.dtype, v.dtype)

        def group(z):
            return z.to(dt).reshape(b, n_groups, g, z.shape[-1]).contiguous()

        qq, qk_, lq, lk = group(quad_q), group(quad_k), group(lin_q), group(lin_k)
        vg, ug = group(v), group(u)
        mg = mask.reshape(b, n_groups, 1, g).to(dt).contiguous()
        # global linear-attention summaries over the valid frames (lin_k is
        # masked), shared by all groups; small, so plain matmuls
        n_valid = torch.clamp_min(mask.sum(dim=-1), 1.0)[:, None, None]
        lin_kv = (torch.einsum("bgnd,bgne->bde", lk, vg) / n_valid).contiguous()
        lin_ku = (torch.einsum("bgnd,bgne->bde", lk, ug) / n_valid).contiguous()
        out = flash_gated(qq, qk_, vg, ug, mg, lq, lin_kv, lin_ku).to(v.dtype).reshape(b, t, e)
        out = self.to_out(out)
        return x + out * mask[..., None]


# ---------------- gated FSMN ----------------


class DilatedDenseFsmnNet(nn.Module):
    """Dense-dilated depthwise memory stack (depth 2): conv i sees the
    concatenation of all earlier outputs, then a masked instance norm over
    time and a per-channel PReLU."""

    def __init__(self, channels: int, lorder: int = 20, depth: int = 2):
        super().__init__()
        k = lorder * 2 - 1
        self.conv_kernels = nn.ParameterList(
            [nn.Parameter(torch.zeros(k, i + 1, channels)) for i in range(depth)])
        self.in_w = nn.ParameterList([nn.Parameter(torch.ones(channels)) for _ in range(depth)])
        self.in_b = nn.ParameterList([nn.Parameter(torch.zeros(channels)) for _ in range(depth)])
        self.prelu = nn.ParameterList(
            [nn.Parameter(torch.full((channels,), 0.25)) for _ in range(depth)])
        self.conv_taps = [None] * depth

    def prepare_kernel(self, owner: str = ""):
        self.conv_taps = [prepare_taps(k, f"{owner}.conv_kernels.{i}")
                          for i, k in enumerate(self.conv_kernels)]

    def forward(self, x, mask):
        parts = [x]
        out = x
        m = mask.float()[..., None]
        # the frame count in the mask's type, as the JAX model counts
        denom = torch.clamp_min(mask.sum(dim=1)[:, None, None], 1.0).float()
        for i, kernel in enumerate(self.conv_kernels):
            inp = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            y = dw_conv1d(inp, kernel, dilation=2 ** i, taps=self.conv_taps[i]).float()
            mean = (y * m).sum(dim=1, keepdim=True) / denom
            var = ((y - mean).square() * m).sum(dim=1, keepdim=True) / denom
            y = (y - mean) / torch.sqrt(var + 1e-5) * self.in_w[i].float() + self.in_b[i].float()
            y = torch.where(y >= 0, y, self.prelu[i].float() * y)
            out = y.to(x.dtype)
            parts = [out] + parts
        return out


class DilatedFsmn(nn.Module):
    """Linear -> ReLU -> project -> dense-dilated memory -> residual."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear = nn.Linear(dim, hidden)
        self.project = nn.Linear(hidden, dim, bias=False)
        self.ddn = DilatedDenseFsmnNet(dim)

    def forward(self, x, mask):
        p = self.project(torch.relu(self.linear(x)))
        return x + self.ddn(p, mask)


class GatedFsmnBlock(nn.Module):
    """conv1x1 -> PReLU -> LayerNorm -> gated FSMN (v * fsmn(u) + x) ->
    LayerNorm -> conv1x1 -> residual."""

    def __init__(self, dim: int, inner: int = 256):
        super().__init__()
        self.conv1 = nn.Linear(dim, inner)
        self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.norm1 = nn.LayerNorm(inner, eps=1e-5)
        self.to_u = FFConvM(inner, inner, norm="layernorm")
        self.to_v = FFConvM(inner, inner, norm="layernorm")
        self.fsmn = DilatedFsmn(inner, inner)
        self.norm2 = nn.LayerNorm(inner, eps=1e-5)
        self.conv2 = nn.Linear(inner, dim)

    def forward(self, x, mask):
        h = self.conv1(x)
        h = torch.where(h >= 0, h, self.prelu * h)
        h = self.norm1(h)
        u = self.fsmn(self.to_u(h), mask)
        h = self.to_v(h) * u + h
        h = self.conv2(self.norm2(h))
        return (x + h) * mask[..., None]


# ---------------- mask net + top model ----------------


class MossLayer(nn.Module):
    """One FlashBlock -> GatedFsmnBlock pair."""

    def __init__(self, dim: int, group_size: int, qk_dim: int, fsmn_inner: int):
        super().__init__()
        self.flash = FlashBlock(dim, group_size=group_size, qk_dim=qk_dim)
        self.fsmn = GatedFsmnBlock(dim, inner=fsmn_inner)

    def forward(self, h, mask):
        return self.fsmn(self.flash(h, mask), mask)


class MaskNet(nn.Module):
    def __init__(self, enc_channels: int, dim: int, num_blocks: int = 24, num_spks: int = 2,
                 group_size: int = 256, qk_dim: int = 128, fsmn_inner: int = 256):
        super().__init__()
        self.dim = dim
        self.num_spks = num_spks
        self.in_norm = GlobalLayerNorm(enc_channels)
        self.bottleneck = nn.Linear(enc_channels, dim, bias=False)
        self.pos_scale = nn.Parameter(torch.ones(1))
        self.layers = nn.ModuleList(
            [MossLayer(dim, group_size, qk_dim, fsmn_inner) for _ in range(num_blocks)])
        self.out_ln = nn.LayerNorm(dim, eps=1e-6)
        self.intra_norm = GlobalLayerNorm(dim)
        self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.spk_expand = nn.Linear(dim, dim * num_spks)
        self.out_tanh = nn.Linear(dim, dim)
        self.out_sig = nn.Linear(dim, dim)
        self.mask_proj = nn.Linear(dim, enc_channels, bias=False)

    def forward(self, x, mask):
        # x: (B, T, N) encoder output -> masks (B, T, spk, N)
        b, t, _ = x.shape
        h = self.bottleneck(self.in_norm(x, mask))
        # scaled sinusoidal global position encoding
        inv_freq = 1.0 / (10000.0 ** (
            torch.arange(0, self.dim, 2, device=x.device, dtype=torch.float32) / self.dim))
        ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv_freq[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) * self.pos_scale.float()
        h = h + pe  # float32: promotes a reduced-type stream, as in the JAX model
        h_in = h
        for layer in self.layers:
            h = layer(h, mask)
        h = self.intra_norm(self.out_ln(h), mask) + h_in
        h = torch.where(h >= 0, h, self.prelu * h)
        h = self.spk_expand(h).reshape(b, t, self.num_spks, self.dim)
        h = torch.tanh(self.out_tanh(h)) * torch.sigmoid(self.out_sig(h))
        return torch.relu(self.mask_proj(h)) * mask[..., None, None]


class MossFormer2(nn.Module):
    """2-speaker time-domain masking separator at 16 kHz. Its arguments stay
    attributes, as the JAX module's fields (a checkpoint's `model_args`);
    `scan_unroll` is the JAX model's scan setting, which the layer loop
    here does not read."""

    def __init__(self, dim: int = 512, enc_channels: int = 512, num_blocks: int = 24,
                 kernel_size: int = 16, num_spks: int = 2, group_size: int = 256,
                 qk_dim: int = 128, fsmn_inner: int = 256, sample_rate: int = 16000,
                 scan_unroll: int = 0):
        super().__init__()
        self.dim, self.enc_channels, self.num_blocks = dim, enc_channels, num_blocks
        self.qk_dim, self.fsmn_inner, self.scan_unroll = qk_dim, fsmn_inner, scan_unroll
        self.kernel_size = kernel_size
        self.num_spks = num_spks
        self.group_size = group_size
        self.sample_rate = sample_rate
        stride = kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_channels, kernel_size, stride=stride, bias=False)
        self.mask_net = MaskNet(enc_channels, dim, num_blocks, num_spks, group_size, qk_dim,
                                fsmn_inner)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size, stride=stride,
                                          bias=False)

    def reduced_modules(self) -> tuple:
        """The modules that compute in a reduced type: those before the
        float32 position table, which promotes the stream."""
        return self.encoder, self.mask_net.in_norm, self.mask_net.bottleneck

    def forward(self, wav, lengths=None):
        """wav (B, T) in [-1, 1], lengths (B,) valid samples -> (B, spk, T)."""
        b, t_in = wav.shape
        if lengths is None:
            lengths = torch.full((b,), t_in, device=wav.device, dtype=torch.long)
        stride = self.kernel_size // 2
        x = torch.relu(self.encoder(wav[:, None, :])).transpose(1, 2)  # (B, T_enc, N)
        t_enc = x.shape[1]
        pad = (-t_enc) % self.group_size
        x = F.pad(x, (0, 0, 0, pad))
        enc_lengths = torch.clamp((lengths - self.kernel_size) // stride + 1, 1, t_enc)
        mask = (torch.arange(t_enc + pad, device=wav.device)[None, :]
                < enc_lengths[:, None]).to(x.dtype)
        masks = self.mask_net(x, mask)
        sep = (x[:, :, None, :] * masks)[:, :t_enc]  # (B, T_enc, spk, N)
        est = torch.stack([self.decoder(sep[:, :, s, :].transpose(1, 2))[:, 0]
                           for s in range(self.num_spks)], dim=1)
        t_out = est.shape[-1]
        if t_out >= t_in:
            return est[..., :t_in]
        return F.pad(est, (0, t_in - t_out))


# ---------------- engine ----------------


class SeparationEngine:
    """Windowed separation with loudness-ordered outputs, for MossFormer2
    and every separator of the zoo (`models/zoo.py`).

    Processing at the model's rate in non-overlapping windows (`window`,
    10 s = 160 k samples by default); a clip that fits one window is
    padded only to the next rung of the ladder (32k/64k/96k below the
    window, then the window). All windows of a call go through the model
    in one synchronous batched forward; concurrent callers' forwards at one
    rung share one forward of ROW_LADDER rows (`_run_mb`). Outputs are
    loudest first.

    A class whose bucket-padded forward departs from its exact-length one
    (`zoo.pad_safe`) is never padded: a clip runs at its exact length,
    `separate_batch` goes clip by clip, and long audio runs its full
    windows in one batch and the remainder at its exact length.

    In a reduced compute type the modules the model names
    (`reduced_modules()`; for MossFormer2 the encoder, `in_norm` and the
    bottleneck, before the float32 position table) compute in it, and
    every later module in float32 from weights rounded to it
    (`promote_after`), as the JAX model's types do. The estimate is
    rounded to the compute type and returned in float32.

    With a `mesh` (`parallel/mesh.py`) the model sits on slot 0, whose
    device it takes, and a replica on every other slot; each forward's
    rows, padded to a multiple of the mesh size with rows of length 1, run
    as equal shards on the slots (`pjit_forward`)."""

    WINDOW = 160_000

    def __init__(self, model: nn.Module, device: str | torch.device = "cuda",
                 compute_dtype: str | None = None, window: int | None = None, mesh=None):
        from .zoo import pad_safe

        self.device = torch.device(device) if mesh is None else mesh[0]
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        self.model = promote_after(model.to(self.device), model.reduced_modules(),
                                   self.compute_dtype).eval()
        prepare_kernels(self.model)
        self.mesh = mesh
        self.mesh_size = 1 if mesh is None else len(mesh)
        if mesh is not None:
            self.replicas = replicated(mesh, self.model)
            self._sharded = pjit_forward(self._model_forward, mesh)
        self.sample_rate = model.sample_rate
        self.num_spks = model.num_spks
        self.window = window or self.WINDOW
        self.ladder = BucketLadder(tuple(b for b in (32_000, 64_000, 96_000) if b < self.window)
                                   + (self.window,))
        self.pad_safe = pad_safe(model)
        # concurrent sessions' forwards at one sample rung coalesce into one
        # batched forward (runtime/microbatch.py)
        self._mb = microbatch.MicroBatcher(self._run_mb) if microbatch.enabled() else None

    # row rungs of coalesced forwards; a call with more rows than the top
    # rung (a long clip's windows, already one batch) bypasses the batcher
    ROW_LADDER = (1, 2, 4, 8, 16)

    @classmethod
    def from_pretrained(cls, path: str, device: str | torch.device = "cuda",
                        compute_dtype: str | None = None, mesh=None) -> "SeparationEngine":
        """The engine of the checkpoint under `path`, whatever separator its
        `model_name` names."""
        from ..runtime.registry import from_pretrained

        return cls(from_pretrained(path), device=device, compute_dtype=compute_dtype, mesh=mesh)

    def _model_forward(self, model: nn.Module, wav: torch.Tensor, lens: torch.Tensor):
        """One replica's forward of float32 rows on its device."""
        return model(wav.to(self.compute_dtype), lens).to(self.compute_dtype)

    def _forward(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """(rows, bucket) float32 audio -> (rows, spk, bucket) float32. On a
        mesh the rows are padded to a multiple of its size first."""
        n = batch.shape[0]
        batch = np.ascontiguousarray(batch, np.float32)
        lengths = np.asarray(lengths, np.int64)
        with torch.inference_mode():
            if self.mesh is None:
                est = self._model_forward(self.model, torch.from_numpy(batch).to(self.device),
                                          torch.from_numpy(lengths).to(self.device))
            else:
                est = self._sharded(self.replicas, *self._pad_rows(batch, lengths, n))
            return est.float().cpu().numpy()[:n]

    def _dispatch(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """(rows, bucket) -> (rows, spk, bucket): through the batcher, where
        concurrent callers at the same rung share one forward, unless the
        call has more rows than the top rung."""
        if self._mb is None or batch.shape[0] > self.ROW_LADDER[-1]:
            return self._forward(batch, lengths)
        return self._mb.submit(batch.shape[1], (batch, lengths))

    def _run_mb(self, key: int, items: list) -> list:
        """The batcher's callback: consecutive items packed into groups of
        at most the top rung's rows, each group padded to a rung with rows
        of length 1 (always a rung, which `_pad_rows` rounds up to a
        multiple of the mesh size, so a forward's row count is one of
        five), one forward a group; each item gets its own rows back."""
        top = self.ROW_LADDER[-1]
        groups: list = [[]]
        rows_in = 0
        for idx, it in enumerate(items):
            r = it[0].shape[0]
            if rows_in + r > top and groups[-1]:
                groups.append([])
                rows_in = 0
            groups[-1].append((idx, it))
            rows_in += r
        out: list = [None] * len(items)
        for grp in groups:
            rows = sum(b.shape[0] for _, (b, _) in grp)
            nb = self.ROW_LADDER[min(bisect.bisect_left(self.ROW_LADDER, rows),
                                     len(self.ROW_LADDER) - 1)]
            batch, lengths = self._pad_rows(
                np.concatenate([b for _, (b, _) in grp]),
                np.concatenate([np.asarray(l, np.int64) for _, (_, l) in grp]), nb)
            with trace("audio/separate_dispatch"):
                est = self._forward(batch, lengths)
            r = 0
            for idx, (b, _) in grp:
                out[idx] = est[r: r + b.shape[0]]
                r += b.shape[0]
        return out

    def _pad_rows(self, batch: np.ndarray, lengths: np.ndarray, rows: int):
        """(batch, lengths) padded to `rows` rows, rounded up to a multiple
        of the mesh size, of zeros with length 1 (the masks leave a row's
        result to its own samples)."""
        n = batch.shape[0]
        rows += (-rows) % self.mesh_size
        if rows <= n:
            return batch, lengths
        batch = np.pad(batch, ((0, rows - n),) + ((0, 0),) * (batch.ndim - 1))
        return batch, np.concatenate([lengths, np.ones(rows - n, lengths.dtype)])

    def _order_and_fit(self, streams: np.ndarray, sr: int, t_orig: int) -> np.ndarray:
        """Loudest stream first, back to the input rate and length."""
        louds = [integrated_loudness_native(s, self.sample_rate) for s in streams]
        streams = streams[np.argsort(louds)[::-1]]
        if sr != self.sample_rate:
            streams = np.stack([resample_poly_np(s, sr, self.sample_rate) for s in streams])
        if streams.shape[-1] >= t_orig:
            return streams[..., :t_orig]
        return np.pad(streams, ((0, 0), (0, t_orig - streams.shape[-1])))

    def separate(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        """(spk, T) separated sources at the input rate, loudest first."""
        audio = np.asarray(audio, np.float32)
        t_orig = len(audio)
        work = resample_poly_np(audio, self.sample_rate, sr) if sr != self.sample_rate else audio
        n = len(work)
        if n == 0:
            return np.zeros((self.num_spks, t_orig), np.float32)
        win = self.window
        if n <= win:  # one window: a ladder rung, or the exact length
            win = self.ladder.bucket(n) if self.pad_safe else n
        n_win = -(-n // win)
        if self.pad_safe or n % win == 0:
            batch = np.pad(work, (0, n_win * win - n)).reshape(n_win, win)
            lengths = np.full(n_win, win, np.int64)
            lengths[-1] = n - (n_win - 1) * win
            est = self._dispatch(batch, lengths)
            # non-overlapping windows stitched back in order
            streams = est.transpose(1, 0, 2).reshape(self.num_spks, -1)[:, :n]
        else:
            # the full windows in one forward, the remainder at its length
            full = n // win
            est = self._dispatch(work[: full * win].reshape(full, win),
                                 np.full(full, win, np.int64))
            rem = self._dispatch(work[full * win:][None], np.array([n - full * win], np.int64))
            streams = np.concatenate([est.transpose(1, 0, 2).reshape(self.num_spks, -1),
                                      rem[0]], axis=-1)
        return self._order_and_fit(streams, sr, t_orig)

    def separate_batch(self, clips: list, sr: int = 16000) -> list:
        """Separate several clips in one forward, each padded to the ladder
        rung of the longest; clips longer than a window, and every clip of
        a class that is not pad-safe, go through `separate`. Returns a list
        of (spk, len(clip)) arrays."""
        clips = [np.asarray(c, np.float32) for c in clips]
        if not self.pad_safe:
            return [self.separate(c, sr=sr) for c in clips]
        work = [resample_poly_np(c, self.sample_rate, sr) for c in clips] \
            if sr != self.sample_rate else clips
        small = [i for i, c in enumerate(work) if 0 < len(c) <= self.window]
        out: list = [None] * len(clips)
        if small:
            bucket = self.ladder.bucket(max(len(work[i]) for i in small))
            batch = np.stack([np.pad(work[i], (0, bucket - len(work[i]))) for i in small])
            est = self._dispatch(batch, np.array([len(work[i]) for i in small]))
            for j, i in enumerate(small):
                out[i] = self._order_and_fit(est[j, :, :len(work[i])], sr, len(clips[i]))
        for i, c in enumerate(clips):
            if out[i] is None:
                out[i] = self.separate(c, sr=sr)
        return out
