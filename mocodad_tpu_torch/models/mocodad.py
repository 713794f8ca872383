"""MoCoDAD: the network container and multi-sample generation.

PyTorch counterpart of `mocodad_tpu/models/mocodad.py` (reference
models/mocodad.py).  The port covers the inject family with the AE / E
condition encoders and the STSAEUnet denoiser: the training loss of
`loss` (at `train_dtype` float32 or bfloat16) and the DDPM chain of
`generate` (at `eval_dtype` float32 or bfloat16).  The other conditioning
strategies, the latent variant and the DDIM / antithetic samplers are not
ported yet and raise NotImplementedError, as does any other dtype.

Generation folds the sample axis S into the batch, b-major
(row = b*S + s), and runs the 9-step chain with the sampler state in the
denoiser's (C, T*V, N) layout, as `build_pallas_eval` does
(mocodad_tpu/models/mocodad.py:502-567): each step computes
silu(cond_emb + t_emb) once as (E, N) in float32, calls
`ops.pallas_unet.denoise` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor), and applies the DDPM update
c1 (x - c2 eps) + c3 z in float32, with z = 0 at t == 1.

`eval_dtype: bfloat16` follows `build_pallas_eval` (:516-565), which runs
the JAX package's kernel B1, and not the JAX `generate()` at bfloat16
(:401-407, :480-487), which is another function: it casts every variable
to bfloat16, the condition encoder's included, runs the XLA fast path,
and keeps the DDPM update in bfloat16.  Here, as in `build_pallas_eval`,
the condition encoder runs in float32; x is bfloat16 between steps
(:539, :557), and the denoiser computes in bfloat16 with float32
accumulation; each step's update is computed in float32 from the
float32 eps, with z drawn in float32 (:548-557), then rounded back to
bfloat16; the losses are float32 (:562-565).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mocodad_tpu_torch.config import Config, effective_n_generated_samples
from mocodad_tpu_torch.diffusion import (DiffusionSchedule,
                                         ddpm_step_coefficients,
                                         forward_noise, make_schedule,
                                         sample_timesteps)
from mocodad_tpu_torch.models import frames as F
from mocodad_tpu_torch.models.losses import aggregate, elementwise_loss
from mocodad_tpu_torch.nn import STSAE, STSE, STSAEUnet, sinusoidal_pos_encoding
from mocodad_tpu_torch.ops.pallas_unet import (FoldedDenoiser, denoise,
                                               fold_denoiser)

EVAL_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _dtype_key(cfg: Config, key: str) -> torch.dtype:
    name = str(cfg.extras.get(key, 'float32'))
    if name not in EVAL_DTYPES:
        raise NotImplementedError(
            f'{key} {name!r} is not ported (float32 or bfloat16)')
    return EVAL_DTYPES[name]


class MoCoDADNet(nn.Module):
    """The condition encoder and the main U-Net in one module, named as the
    reference's LightningModule (`condition_encoder`, `model`;
    ref `build_model`, models/mocodad.py:90-126), so a reference state dict
    loads with `strict=True`."""

    def __init__(self, num_coords: int, n_joints: int, embedding_dim: int,
                 dropout: float, strategy: str,
                 conditioning_architecture: Optional[str], h_dim: int,
                 latent_dim: int, channels, n_frames_condition: int,
                 input_n_frames: int):
        super().__init__()
        if strategy != 'inject':
            raise NotImplementedError(
                f'conditioning strategy {strategy!r} is not ported yet')
        if conditioning_architecture == 'AE':
            enc = STSAE
        elif conditioning_architecture == 'E':
            enc = STSE
        else:
            raise NotImplementedError(
                f'conditioning architecture {conditioning_architecture!r} is '
                'not ported yet')
        self.condition_encoder = enc(
            c_in=num_coords, h_dim=h_dim, latent_dim=latent_dim,
            n_frames=n_frames_condition, n_joints=n_joints,
            layer_channels=tuple(channels), dropout=dropout)
        self.model = STSAEUnet(c_in=num_coords, embedding_dim=embedding_dim,
                               n_frames=input_n_frames, n_joints=n_joints,
                               dropout=dropout, inject_condition=True)

    def encode_condition(self, cond: torch.Tensor) -> torch.Tensor:
        """The conditioning latent (ref `_encode_condition`,
        models/mocodad.py:546-560); the AE's reconstruction is not needed
        at eval time and is not computed."""
        return self.condition_encoder.encode(cond)

    def denoise(self, x: torch.Tensor, t: torch.Tensor,
                cond_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The module forward of the U-Net (the folded denoiser's oracle)."""
        pred, _ = self.model(x, t, cond_emb)
        return pred

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(eps prediction, the AE's reconstruction of `cond` or None)
        (mocodad_tpu/models/mocodad.py:123-125)."""
        latent, rec = self.condition_encoder(cond)
        pred, _ = self.model(x, t, latent)
        return pred, rec


class MoCoDADModel:
    """Holds the configuration; the network is passed to each call, as the
    JAX package passes its variables tree."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.strategy = cfg.strategy
        self.n_frames = cfg.seg_len
        self.num_coords = cfg.num_coords
        self.n_joints = cfg.n_joints
        (self.n_frames_condition, self.n_frames_corrupt,
         self.input_n_frames) = cfg.conditioning_split()
        cond_idxs, corrupt_idxs = cfg.cond_corrupt_indices()
        if cond_idxs is None:
            raise NotImplementedError('random_imp is not ported yet')
        self._static_order = F.static_order(cond_idxs, corrupt_idxs)
        self.loss_kind = cfg.loss_fn
        self.rec_weight = cfg.rec_weight
        self.aggregation_strategy = cfg.aggregation_strategy
        self.model_return_value = cfg.model_return_value
        self.schedule = make_schedule(cfg.noise_steps)
        self.eval_dtype = _dtype_key(cfg, 'eval_dtype')
        # the net's forward and backward in training; master params, grads,
        # BN running statistics, the noising and the loss stay float32
        self.train_dtype = _dtype_key(cfg, 'train_dtype')
        sampler = str(cfg.extras.get('sampler', 'ddpm'))
        if sampler != 'ddpm':
            raise NotImplementedError(
                f'sampler {sampler!r} is not ported yet (ddpm only)')
        if cfg.extras.get('antithetic', False):
            raise NotImplementedError('antithetic sampling is not ported yet')
        self.n_generated_samples = effective_n_generated_samples(cfg)
        self._device_tables = {}

    def tables(self, device: torch.device
               ) -> Tuple[torch.Tensor, DiffusionSchedule]:
        """The frame order and the schedule with its alpha-bar table, as
        tensors on `device`, copied there once: a copy from pageable host
        memory inside a step would stall the host until the card is idle."""
        out = self._device_tables.get(device)
        if out is None:
            out = (torch.as_tensor(self._static_order, device=device),
                   self.schedule._replace(alpha_hat=torch.as_tensor(
                       self.schedule.alpha_hat, device=device)))
            self._device_tables[device] = out
        return out

    def build_net(self) -> MoCoDADNet:
        cfg = self.cfg
        return MoCoDADNet(
            num_coords=self.num_coords, n_joints=self.n_joints,
            embedding_dim=cfg.embedding_dim, dropout=cfg.dropout,
            strategy=self.strategy,
            conditioning_architecture=cfg.conditioning_architecture,
            h_dim=cfg.h_dim, latent_dim=cfg.latent_dim,
            channels=tuple(cfg.channels),
            n_frames_condition=self.n_frames_condition,
            input_n_frames=self.input_n_frames)

    def fold(self, net: MoCoDADNet) -> FoldedDenoiser:
        """The denoiser's folded eval-mode constants; refold after the
        weights change."""
        return fold_denoiser(net.model)

    @staticmethod
    def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]
                     ) -> torch.Tensor:
        """Mean over all elements, each sample weighted by its mask entry
        (mocodad_tpu/models/mocodad.py:262-274)."""
        if sample_mask is None:
            return x.mean()
        m = sample_mask.reshape((-1,) + (1,) * (x.ndim - 1))
        per_sample = max(1, int(np.prod(x.shape[1:])))
        return (x * m).sum() / (sample_mask.sum() * per_sample)

    def loss(self, net: MoCoDADNet, data: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sample_mask: Optional[torch.Tensor] = None,
             noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
             = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Noise-prediction loss plus the AE reconstruction term, on `net`
        in its current mode (mocodad_tpu/models/mocodad.py:276-368).

        data: (B, C, T, V) on the device to run on; `generator`, on that
        device, draws t and the forward noise unless `noise_override =
        (t, eps)` is given.  In train mode the BatchNorm running statistics
        update in place on `net` (JAX returns them as `mutated`).  Returns
        (loss, metrics) with metrics 'loss_noise', 'loss_recons' (AE only)
        and 'loss', detached.
        """
        b = data.shape[0]
        order, schedule = self.tables(data.device)
        cond_data, corrupt_data = F.select_frames(data, order,
                                                  self.n_frames_condition)
        if noise_override is not None:
            t, eps = noise_override
            t = torch.as_tensor(t, device=data.device).long()
            eps = torch.as_tensor(eps, device=data.device,
                                  dtype=corrupt_data.dtype)
        else:
            t = sample_timesteps(b, self.schedule.noise_steps, generator)
            eps = None
        x_t, noise = forward_noise(schedule, corrupt_data, t, eps=eps,
                                   generator=generator)
        x_in = F.assemble_input(self.strategy, cond_data, x_t, order,
                                self.n_frames_condition)
        dt = self.train_dtype if net.training else torch.float32
        if dt == torch.float32:
            pred, rec = net(x_in, t, cond_data)
        else:
            # params cast inside the differentiated graph, so their grads
            # land on the float32 masters; the BN buffers are not passed,
            # so the module's own float32 accumulators update
            params = {k: p.to(dt) for k, p in net.named_parameters()}
            pred, rec = torch.func.functional_call(
                net, params, (x_in.to(dt), t, cond_data.to(dt)))
            pred = pred.float()
            rec = None if rec is None else rec.float()
        pred = F.extract_corrupt(self.strategy, pred, order,
                                 self.n_frames_condition)
        loss_noise = self._masked_mean(
            elementwise_loss(self.loss_kind, pred, noise), sample_mask)
        metrics = {'loss_noise': loss_noise.detach()}
        loss = loss_noise
        if rec is not None:
            loss_rec = self._masked_mean(torch.square(rec - cond_data),
                                         sample_mask)
            loss = loss_noise + self.rec_weight * loss_rec
            metrics['loss_recons'] = loss_rec.detach()
        metrics['loss'] = loss.detach()
        return loss, metrics

    @torch.no_grad()
    def generate(self, net: MoCoDADNet, data: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 aggr_strategy: Optional[str] = None,
                 n_samples: Optional[int] = None,
                 noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None,
                 folded: Optional[FoldedDenoiser] = None
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Sample S futures per window and aggregate
        (ref `forward`, models/mocodad.py:129-184).

        net: the network in eval mode (the JAX function's `variables`).
        data: (B, C, T, V) on the device to run on.  rng: a generator on
        that device, for every gaussian draw (and the 'random'
        aggregation).  Returns (selected_x, loss_of_selected_x);
        selected_x is None for loss-only aggregations.

        `noise_override`, when given, is `(x0, zs)`: the initial noise
        (S*B, C, Tc, V) and the per-step noise (noise_steps-1, S*B, C, Tc,
        V), both in the b-major fold (row = b*S + s); it replaces the
        gaussian draws so the chain can be compared step for step with the
        JAX package.  At bfloat16 x0 is rounded to bfloat16 (JAX draws it
        in bfloat16) and the per-step noise stays float32.  `folded` is
        `self.fold(net)`, passed in by callers that generate many batches
        with one set of weights.
        """
        aggr = aggr_strategy or self.aggregation_strategy
        s = n_samples or self.n_generated_samples
        b = data.shape[0]
        dev = data.device
        if folded is None:
            folded = self.fold(net)
        if noise_override is None and rng is None:
            raise ValueError('generate needs a torch.Generator (rng) unless '
                             'noise_override is given')
        cond_data, corrupt_data = F.select_frames(
            data, self.tables(dev)[0], self.n_frames_condition)
        cond_emb = net.encode_condition(cond_data)            # (B, E)
        # (E, S*B), b-major fold: row = b*S + s
        emb_t = cond_emb.repeat_interleave(s, dim=0).T.contiguous()

        c, tc, v = self.num_coords, self.n_frames_corrupt, self.n_joints
        n = b * s
        n_steps = self.schedule.noise_steps - 1
        dt = self.eval_dtype

        def to_ctn(z: torch.Tensor) -> torch.Tensor:
            # (N, C, Tc, V) -> (C, Tc*V, N)
            return z.to(dev, torch.float32).reshape(n, c, tc * v).permute(
                1, 2, 0).contiguous()

        if noise_override is not None:
            x0, zs = noise_override
            if tuple(x0.shape) != (n, c, tc, v) or \
                    tuple(zs.shape) != (n_steps, n, c, tc, v):
                raise ValueError(
                    f'noise_override must be ({n}, {c}, {tc}, {v}) and '
                    f'({n_steps}, {n}, {c}, {tc}, {v}); got '
                    f'{tuple(x0.shape)} and {tuple(zs.shape)}')
            x = to_ctn(torch.as_tensor(x0))
        else:
            x = torch.randn((c, tc * v, n), generator=rng, device=dev)
        x = x.to(dt)
        for i, t in enumerate(range(n_steps, 0, -1)):
            t_emb = sinusoidal_pos_encoding(
                torch.full((1,), t, device=dev), self.cfg.embedding_dim)
            silu_emb = torch.nn.functional.silu(emb_t + t_emb.T).contiguous()
            eps = denoise(x, silu_emb, folded).float()
            x32 = x.float()
            c1, c2, c3 = ddpm_step_coefficients(self.schedule, t)
            if t > 1:
                z = (to_ctn(torch.as_tensor(noise_override[1][i]))
                     if noise_override is not None else
                     torch.randn(x.shape, generator=rng, device=dev))
                x = (c1 * (x32 - c2 * eps) + c3 * z).to(dt)
            else:
                x = (c1 * (x32 - c2 * eps)).to(dt)
        # (C, Tc*V, B*S) -> (S, B, C, Tc, V) for aggregation
        xs = x.float().reshape(c, tc, v, b, s).permute(4, 3, 0, 1, 2)
        return aggregate(aggr, self.loss_kind, xs, corrupt_data,
                         generator=rng)


def build_model(cfg: Config) -> MoCoDADModel:
    """Model-class dispatch (ref: train_MoCoDAD.py:68); the latent variant
    is not ported yet."""
    if cfg.diffusion_on_latent is not None:
        raise NotImplementedError('the latent variant is not ported yet')
    return MoCoDADModel(cfg)


def seeded_state(net: MoCoDADNet, seed: int) -> MoCoDADNet:
    """Re-initialize `net` from `seed` (weights uniform as at init, BN
    running statistics set to non-trivial values), so folded BatchNorms
    are exercised.  Used by the smoke run and the tests."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            bound = 1.0 / np.sqrt(max(p.shape[1] if p.dim() > 1 else
                                      p.shape[0], 1))
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
            if name.endswith('prelu.weight'):
                p.copy_(0.25 + 0.1 * torch.rand(p.shape, generator=g))
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(
                    0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape,
                                                       generator=g))
    return net
