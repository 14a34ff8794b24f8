"""Optimizers and schedules with optax's update rules, on torch tensors.

Counterpart of targetdiarization_tpu/train/optim.py: the same factory over
the same twelve names, global-norm clipping and the two schedules
(look2hear's optimizers.py and schedulers.py). Each optimizer is optax's
chain of transforms, written as plain tensor updates with optax's
defaults and its order of operations: torch.optim's rules differ (where
RMSprop's and Adagrad's eps sit, Adagrad's initial accumulator, AdamW's
default decay), and six of the names have no torch.optim class.

A transform is (init, update): `init(params)` gives its state, and
`update(updates, state, params)` the new updates and state, where params
and updates are lists of tensors. State is nested dicts and tuples of
tensors and Python ints, so `runtime/params.py::save_pytree` keeps it.
Scalars (decay powers, bias corrections) are float32, as optax's are.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    init: Callable
    update: Callable


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def apply_updates(params: list, updates: list) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


def global_norm(tensors: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _f32(x) -> float:
    """A float32 scalar as a Python float (torch casts it back exactly)."""
    return float(np.float32(x))


def _power(decay: float, count: int) -> float:
    return _f32(np.float32(decay) ** np.float32(count))


def _bias_correction(decay: float, count: int) -> float:
    return _f32(np.float32(1.0) - np.float32(_power(decay, count)))


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _moment(updates, moments, decay, order):
    return [(1 - decay) * (g ** order) + decay * t for g, t in zip(updates, moments)]


def _stateless(fn) -> Transform:
    return Transform(lambda params: {}, lambda u, s, p: (fn(u, p), s))


def clip_by_global_norm(max_norm: float) -> Transform:
    """g / ||g|| * c where the global norm ||g|| is c or above, g below."""
    def clip(updates, params):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return [torch.where(trigger, t, (t / g_norm) * max_norm) for t in updates]

    return _stateless(clip)


def scale_by_learning_rate(learning_rate) -> Transform:
    """-lr * updates; a callable lr is evaluated at its own step count."""
    if callable(learning_rate):
        def update(updates, state, params):
            step = _f32(-learning_rate(state["count"]))
            return [step * g for g in updates], {"count": state["count"] + 1}

        return Transform(lambda params: {"count": 0}, update)
    step = -learning_rate
    return _stateless(lambda updates, params: [step * g for g in updates])


def add_decayed_weights(weight_decay: float = 0.0) -> Transform:
    return _stateless(lambda updates, params: [g + weight_decay * p
                                               for g, p in zip(updates, params)])


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(updates, state, params):
        new = [g + decay * t for g, t in zip(updates, state["trace"])]
        out = [g + decay * t for g, t in zip(updates, new)] if nesterov else new
        return out, {"trace": new}

    return Transform(lambda params: {"trace": _zeros(params)}, update)


def _adam_like(second, b1, b2, eps, eps_root, nesterov, init_nu=0.0, init_mu=0.0,
               radam_threshold=None) -> Transform:
    """The Adam family: mu, nu by `second`, bias-corrected, m / (sqrt(v + eps_root) + eps)."""
    def init(params):
        return {"count": 0, "mu": [torch.full_like(p, init_mu) for p in params],
                "nu": [torch.full_like(p, init_nu) for p in params]}

    def update(updates, state, params):
        mu = _moment(updates, state["mu"], b1, 1)
        nu = second(updates, mu, state["nu"])
        count = state["count"] + 1
        c1 = _bias_correction(b1, count)
        if nesterov:
            c1_next = _bias_correction(b1, count + 1)
            mu_hat = [b1 * (m / c1_next) + (1 - b1) * (g / c1) for m, g in zip(mu, updates)]
        else:
            mu_hat = [m / c1 for m in mu]
        c2 = _bias_correction(b2, count)
        nu_hat = [v / c2 for v in nu]
        if radam_threshold is None:
            out = [m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(mu_hat, nu_hat)]
        else:
            ro_inf = np.float32(2.0 / (1.0 - b2) - 1.0)
            b2t = np.float32(_power(b2, count))
            ro = ro_inf - np.float32(2 * count) * b2t / (np.float32(1) - b2t)
            if ro >= radam_threshold:
                r = _f32(np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro)))
                out = [r * m / (torch.sqrt(v + eps_root) + eps) for m, v in zip(mu_hat, nu_hat)]
            else:
                out = mu_hat
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False) -> Transform:
    return _adam_like(lambda g, mu, nu: _moment(g, nu, b2, 2), b1, b2, eps, eps_root, nesterov)


def scale_by_belief(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, nesterov=False) -> Transform:
    def second(updates, mu, nu):
        err = [g - m for g, m in zip(updates, mu)]
        return [v + eps_root for v in _moment(err, nu, b2, 2)]

    return _adam_like(second, b1, b2, eps, 0.0, nesterov)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0,
                   nesterov=False) -> Transform:
    return _adam_like(lambda g, mu, nu: _moment(g, nu, b2, 2), b1, b2, eps, eps_root, nesterov,
                      radam_threshold=threshold)


def scale_by_yogi(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0,
                  initial_accumulator_value=1e-6) -> Transform:
    def second(updates, mu, nu):
        return [v - (1 - b2) * torch.sign(v - g * g) * (g * g) for g, v in zip(updates, nu)]

    return _adam_like(second, b1, b2, eps, eps_root, False, init_nu=initial_accumulator_value,
                      init_mu=initial_accumulator_value)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7) -> Transform:
    def update(updates, state, params):
        ss = [g * g + t for g, t in zip(updates, state["sum_of_squares"])]
        out = [torch.where(t > 0, torch.rsqrt(t + eps), 0.0) * g for g, t in zip(updates, ss)]
        return out, {"sum_of_squares": ss}

    return Transform(lambda params: {"sum_of_squares": [torch.full_like(p, initial_accumulator_value)
                                                        for p in params]}, update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                 bias_correction=False, centered=False) -> Transform:
    """RMSprop's scaling (optax's scale_by_rms, or scale_by_stddev when centered)."""
    def init(params):
        state = {"count": 0, "nu": [torch.full_like(p, initial_scale) for p in params]}
        if centered:
            state["mu"] = _zeros(params)
        return state

    def update(updates, state, params):
        nu = _moment(updates, state["nu"], decay, 2)
        mu = _moment(updates, state["mu"], decay, 1) if centered else None
        count = state["count"] + 1 if bias_correction else 0
        nu_hat, mu_hat = nu, mu
        if bias_correction:
            c = _bias_correction(decay, count)
            nu_hat = [v / c for v in nu]
            mu_hat = [m / c for m in mu] if centered else None
        if centered:
            nu_hat = [v - m * m for v, m in zip(nu_hat, mu_hat)]
        if eps_in_sqrt:
            out = [torch.rsqrt(v + eps) * g for g, v in zip(updates, nu_hat)]
        else:
            out = [1 / (torch.sqrt(v) + eps) * g for g, v in zip(updates, nu_hat)]
        new = {"count": count, "nu": nu}
        if centered:
            new["mu"] = mu
        return out, new

    return Transform(init, update)


def scale_by_trust_ratio(trust_coefficient=1.0, eps=0.0) -> Transform:
    def scale(updates, params):
        out = []
        for u, p in zip(updates, params):
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = trust_coefficient * p_norm / (u_norm + eps)
            zero = (p_norm == 0.0) | (u_norm == 0.0)
            out.append(u * torch.where(zero, torch.ones_like(ratio), ratio))
        return out

    return _stateless(scale)


def scale_by_novograd(b1=0.9, b2=0.25, eps=1e-8, eps_root=0.0, weight_decay=0.0) -> Transform:
    def init(params):
        return {"count": 0, "mu": _zeros(params),
                "nu": [torch.zeros((), dtype=p.dtype, device=p.device) for p in params]}

    def update(updates, state, params):
        count = state["count"] + 1
        sq = [torch.linalg.vector_norm(g) ** 2 for g in updates]
        nu = sq if count == 1 else _moment(sq, state["nu"], b2, 1)
        step = [g / (torch.sqrt(n + eps_root) + eps) + weight_decay * p
                for g, p, n in zip(updates, params, nu)]
        mu = step if count == 1 else [b1 * m + u for m, u in zip(state["mu"], step)]
        return mu, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_lion(b1=0.9, b2=0.99) -> Transform:
    def update(updates, state, params):
        out = [torch.sign((1.0 - b1) * g + b1 * m) for g, m in zip(updates, state["mu"])]
        return out, {"count": state["count"] + 1,
                     "mu": _moment(updates, state["mu"], b2, 1)}

    return Transform(lambda params: {"count": 0, "mu": _zeros(params)}, update)


# ---------------- the twelve optimizers (optax's aliases) ----------------


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, *, nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4, *,
          nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, nesterov),
                 add_decayed_weights(weight_decay), scale_by_learning_rate(learning_rate))


def sgd(learning_rate, momentum=None, nesterov=False):
    first = () if momentum is None else (trace(momentum, nesterov),)
    return chain(*first, scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
            centered=False, momentum=None, nesterov=False, bias_correction=False):
    last = () if momentum is None else (trace(momentum, nesterov),)
    return chain(scale_by_rms(decay, eps, initial_scale, eps_in_sqrt, bias_correction, centered),
                 scale_by_learning_rate(learning_rate), *last)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(), scale_by_learning_rate(learning_rate))


def lars(learning_rate, weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9,
         nesterov=False):
    return chain(add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(trust_coefficient, eps),
                 scale_by_learning_rate(learning_rate), trace(momentum, nesterov))


def adabelief(learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *, nesterov=False):
    return chain(scale_by_belief(b1, b2, eps, eps_root, nesterov),
                 scale_by_learning_rate(learning_rate))


def radam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *,
          nesterov=False):
    return chain(scale_by_radam(b1, b2, eps, eps_root, threshold, nesterov),
                 scale_by_learning_rate(learning_rate))


def yogi(learning_rate, b1=0.9, b2=0.999, eps=1e-3):
    return chain(scale_by_yogi(b1, b2, eps), scale_by_learning_rate(learning_rate))


def novograd(learning_rate, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_novograd(b1, b2, eps, eps_root, weight_decay),
                 scale_by_learning_rate(learning_rate))


def lion(learning_rate, b1=0.9, b2=0.99, weight_decay=1e-3):
    return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


_OPTIMIZERS = {"adam": adam, "adamw": adamw, "sgd": sgd, "rmsprop": rmsprop,
               "adagrad": adagrad, "lamb": lamb, "lars": lars, "adabelief": adabelief,
               "radam": radam, "yogi": yogi, "novograd": novograd, "lion": lion}


def apply_if_finite(inner: Transform, max_consecutive_errors: int) -> Transform:
    """optax.apply_if_finite: an update holding a NaN or an infinity is
    skipped (zeros, `inner`'s state kept) until more than
    `max_consecutive_errors` come in a row, and then applied. The state is
    optax's: `notfinite_count`, `last_finite`, `total_notfinite` and
    `inner_state` (the check reads one flag back to the host a step)."""
    def init(params):
        return {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
                "inner_state": inner.init(params)}

    def update(updates, state, params):
        finite = bool(torch.stack([torch.isfinite(u).all() for u in updates]).all())
        count = 0 if finite else state["notfinite_count"] + 1
        if finite or count > max_consecutive_errors:
            updates, inner_state = inner.update(updates, state["inner_state"], params)
        else:
            updates, inner_state = [torch.zeros_like(u) for u in updates], state["inner_state"]
        return updates, {"notfinite_count": count, "last_finite": finite,
                         "total_notfinite": state["total_notfinite"] + (not finite),
                         "inner_state": inner_state}

    return Transform(init, update)


def make_optimizer(name: str = "adam", learning_rate=1e-3, weight_decay: float = 0.0,
                   grad_clip: float = 5.0, **kwargs) -> Transform:
    """Factory by name with optional global-norm clipping (the reference
    clips at 5.0 in its Lightning config). `weight_decay`, when nonzero,
    reaches adamw, lamb and lion; otherwise they keep optax's defaults."""
    name = name.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)}")
    kwargs = dict(kwargs)
    if weight_decay and name in ("adamw", "lamb", "lion"):
        kwargs["weight_decay"] = weight_decay
    opt = _OPTIMIZERS[name](learning_rate, **kwargs)
    if grad_clip and grad_clip > 0:
        return chain(clip_by_global_norm(grad_clip), opt)
    return opt


def dptnet_schedule(d_model: int, warmup_steps: int = 4000,
                    scale: float = 1.0) -> Callable[[int], float]:
    """DPTNet warmup: lr = scale d_model^-0.5 min(s^-0.5, s w^-1.5), s = step + 1."""
    def schedule(step):
        s = np.float32(step) + np.float32(1.0)
        return _f32(scale * (d_model ** -0.5) * np.minimum(
            s ** np.float32(-0.5), s * np.float32(warmup_steps ** -1.5)))

    return schedule


def halving_exponential(base_lr: float, decay_every: int,
                        factor: float = 0.5) -> Callable[[int], float]:
    """Step-halving exponential decay: base_lr factor^floor(step / decay_every)."""
    def schedule(step):
        if step <= 0:
            return _f32(base_lr)
        return _f32(base_lr * np.float32(factor) ** np.floor(np.float32(step) / decay_every))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule in float32: init_value x ((1 - alpha)
    (0.5 (1 + cos(pi min(step, decay_steps) / decay_steps)))^exponent + alpha);
    the decay part of `warmup_cosine_decay_schedule`, as in optax."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")
    f32 = np.float32

    def schedule(step):
        t = f32(min(step, decay_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        return _f32(f32(init_value) * (f32(1 - alpha) * decay ** f32(exponent) + f32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule in float32: linear from init_value to
    peak_value over warmup_steps, then cosine decay to end_value at
    decay_steps (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32

    def linear(count):
        if warmup_steps <= 0:
            return f32(init_value)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(step):
        return _f32(linear(step) if step < warmup_steps else cosine(step - warmup_steps))

    return schedule
