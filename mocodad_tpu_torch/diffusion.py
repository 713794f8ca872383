"""DDPM noise schedule and the reverse-step coefficients.

PyTorch-side counterpart of `mocodad_tpu/diffusion.py` (reference
utils/diffusion_utils.py: cosine schedule via squared-cosine alpha-bar,
`betas_for_alpha_bar` :8-14).  The tables are float32 NumPy arrays built
exactly as the JAX package builds them, so they are bit-equal; the reverse
chain itself lives in `models/mocodad.py`, the forward noising of training
here, with the DDIM sampler's timesteps and coefficients.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch


def betas_for_alpha_bar(num_steps: int, alpha_bar: Callable[[float], float],
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar curve into per-step betas
    (ref: utils/diffusion_utils.py:8-14)."""
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def cosine_beta_schedule(num_steps: int) -> np.ndarray:
    """Squared-cosine schedule (ref: utils/diffusion_utils.py:38-44)."""
    return betas_for_alpha_bar(
        num_steps,
        lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
    )


def linear_beta_schedule(num_steps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """Linear schedule (ref: utils/diffusion_utils.py:34-35)."""
    return np.linspace(beta_start, beta_end, num_steps)


class DiffusionSchedule(NamedTuple):
    """Constant noise-schedule tables (float32, host)."""
    beta: np.ndarray         # (noise_steps,)
    alpha: np.ndarray        # (noise_steps,)
    alpha_hat: np.ndarray    # (noise_steps,) cumulative product of alpha

    @property
    def noise_steps(self) -> int:
        return self.beta.shape[0]


def coef(table: np.ndarray, t: int) -> np.float32:
    """A schedule coefficient at integer timestep `t`."""
    return table[t]


def make_schedule(noise_steps: int, kind: str = 'cosine') -> DiffusionSchedule:
    if kind == 'cosine':
        beta = cosine_beta_schedule(noise_steps)
    elif kind == 'linear':
        beta = linear_beta_schedule(noise_steps)
    else:
        raise ValueError(f'unknown schedule kind {kind!r}')
    # float32 sequential ops, exactly as mocodad_tpu/diffusion.py:85-87
    beta = np.asarray(beta, dtype=np.float32)
    alpha = np.asarray(1.0 - beta, dtype=np.float32)
    alpha_hat = np.cumprod(alpha, dtype=np.float32)
    return DiffusionSchedule(beta=beta, alpha=alpha, alpha_hat=alpha_hat)


def ddpm_step_coefficients(schedule: DiffusionSchedule, t: int
                           ) -> Tuple[float, float, float]:
    """(c1, c2, c3) of the reverse DDPM update
        x <- c1 * (x - c2 * eps) + c3 * z
    at timestep t (ref models/mocodad.py:178), computed in float32 as the
    JAX chain computes them."""
    one = np.float32(1.0)
    a = coef(schedule.alpha, t)
    a_hat = coef(schedule.alpha_hat, t)
    c1 = one / np.sqrt(a)
    c2 = (one - a) / np.sqrt(one - a_hat)
    c3 = np.sqrt(coef(schedule.beta, t))
    return float(c1), float(c2), float(c3)


def sample_timesteps(n: int, noise_steps: int,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """(n,) int64 timesteps uniform in [1, noise_steps), on the generator's
    device (mocodad_tpu/diffusion.py:91-93)."""
    dev = generator.device if generator is not None else None
    return torch.randint(1, noise_steps, (n,), generator=generator,
                         device=dev)


def forward_noise(schedule: DiffusionSchedule, x: torch.Tensor,
                  t: torch.Tensor, eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q(x_t | x_0): x_t = sqrt(a-bar_t) x + sqrt(1 - a-bar_t) eps, for any
    rank of x with t (B,) along axis 0 (mocodad_tpu/diffusion.py:96-113).
    The table is a float32 constant on x's device; `eps` replaces the
    gaussian draw (tests inject another package's noise)."""
    a_hat = torch.as_tensor(schedule.alpha_hat, device=x.device)[t.long()]
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    sqrt_a = torch.sqrt(a_hat).reshape(shape)
    sqrt_1ma = torch.sqrt(1.0 - a_hat).reshape(shape)
    if eps is None:
        eps = torch.randn(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype)
    return sqrt_a * x + sqrt_1ma * eps, eps


def ddim_timesteps(noise_steps: int, n_steps: int) -> np.ndarray:
    """Descending timestep subsequence for DDIM sampling
    (mocodad_tpu/diffusion.py:116-131): `n_steps` (about) evenly spaced
    integers of [1, noise_steps-1], the top step always included;
    `n_steps >= noise_steps-1` gives the full DDPM sequence."""
    full = noise_steps - 1
    n = max(1, min(int(n_steps), full))
    if n == 1:
        ts = np.array([full], dtype=np.int64)
    else:
        ts = np.unique(np.round(np.linspace(1, full, n)).astype(np.int64))
    return ts[::-1].copy()


def ddim_plan(schedule: DiffusionSchedule, ts_desc: np.ndarray,
              eta: float = 0.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step coefficients (c_x, c_eps, c_z), float32, of the DDIM update
        x <- c_x * x + c_eps * eps_hat + c_z * z,      z ~ N(0, I)
    (Song et al. 2021, eq. 12), computed on the host in float64 as
    mocodad_tpu/diffusion.py:134-168 computes them.  Step i moves from
    ts_desc[i] to ts_desc[i+1], the last to the clean sample (alpha-bar 1,
    so its c_z is 0 for any eta); eta = 0 is the deterministic sampler."""
    ts_desc = np.asarray(ts_desc, dtype=np.int64)
    ah_t = schedule.alpha_hat[ts_desc].astype(np.float64)
    ah_prev = np.concatenate(
        [schedule.alpha_hat[ts_desc[1:]].astype(np.float64), [1.0]])
    sigma = eta * np.sqrt((1.0 - ah_prev) / (1.0 - ah_t)) \
        * np.sqrt(np.maximum(1.0 - ah_t / ah_prev, 0.0))
    c_x = np.sqrt(ah_prev / ah_t)
    c_eps = np.sqrt(np.maximum(1.0 - ah_prev - sigma ** 2, 0.0)) \
        - c_x * np.sqrt(1.0 - ah_t)
    return (c_x.astype(np.float32), c_eps.astype(np.float32),
            sigma.astype(np.float32))
