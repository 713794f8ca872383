"""The latent MoCoDAD variant: two stages, pretrain and diffusion.

PyTorch counterpart of `mocodad_tpu/models/mocodad_latent.py` (reference
models/mocodad_latent.py).  Stage 'pretrain' trains a bottlenecked
STSAEUnet to reconstruct the corrupted frames; stage 'diffusion' keeps the
pretrained down path (an STSEUnet with its linear head) and condition
encoder frozen, and learns a DDPM over their latent code with the MLP
`Denoiser`.  `build_model` selects this model when the config carries
`diffusion_on_latent` (ref: train_MoCoDAD.py:68).

Neither stage runs a kernel of the port: the JAX model refuses the Pallas
eval (`supports_pallas_eval`, :151-156), since its U-Nets are not the
pose-space STSAEUnet that B1 computes, and its latent chain is an MLP.
`fold` therefore returns None and `generate` ignores `folded`.

`generate` computes in float32 at any `eval_dtype`: the JAX latent
`generate` casts nothing (:241-338).  Training follows `train_dtype` as the
base model does (:84-97): the net's parameters cast to bfloat16 inside the
differentiated graph, the noising at the float32 coefficients, the pretrain
target the original float32 window.

On a data-parallel `mesh` both stages draw as the base model does: t,
eps and the latent chain's gaussians at the global batch's size, each
rank keeping its block of rows, the masked means over the global
denominator, the metrics summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.diffusion import ddpm_step_coefficients
from mocodad_tpu_torch.models import frames as F
from mocodad_tpu_torch.models.losses import aggregate, elementwise_loss
from mocodad_tpu_torch.models.mocodad import (MoCoDADModel, MoCoDADNet,
                                              _mirror_fold)
from mocodad_tpu_torch.nn import Denoiser, STSAEUnet, STSEUnet
from mocodad_tpu_torch.parallel.distributed import global_rows, local_rows

# the reference passes a constant t = -1 through the U-Net in both stages
# (mocodad_tpu/models/mocodad_latent.py:25-27)
_CONST_T = -1
# the diffusion stage's encoder (mocodad_latent.py:51-55); STSEUnet's own
# default ends in 6
DIFFUSION_DOWN_CHANNELS = (16, 32, 32, 64, 64, 128, 64)


class MoCoDADLatentNet(MoCoDADNet):
    """The condition encoder, the stage's main net (`model`) and, in stage
    'diffusion', the MLP `denoiser`, under the reference's names
    (mocodad_latent.py:30-61).

    `forward` is the training forward (`loss_forward`, :84-102), so that
    `torch.func.functional_call` can run it with cast parameters: it
    returns (prediction, target, the condition encoder's reconstruction or
    None)."""

    def __init__(self, stage: str, latent_embedding_dim: int,
                 hidden_sizes: Sequence[int], **kw):
        if stage == 'diffusion':
            main = STSEUnet(c_in=kw['num_coords'],
                            embedding_dim=kw['embedding_dim'],
                            latent_dim=latent_embedding_dim,
                            n_frames=kw['input_n_frames'],
                            n_joints=kw['n_joints'], dropout=kw['dropout'],
                            set_out_layer=True,
                            unet_down_channels=DIFFUSION_DOWN_CHANNELS)
        else:
            main = STSAEUnet(c_in=kw['num_coords'],
                             embedding_dim=kw['embedding_dim'],
                             latent_dim=latent_embedding_dim,
                             n_frames=kw['input_n_frames'],
                             n_joints=kw['n_joints'], dropout=kw['dropout'],
                             inject_condition=(kw['strategy'] == 'inject'),
                             use_bottleneck=True)
        super().__init__(**kw, model=main)
        self.stage = stage
        self.denoiser = (Denoiser(latent_embedding_dim, hidden_sizes,
                                  kw['embedding_dim'])
                         if stage == 'diffusion' else None)

    def encode_input(self, x: torch.Tensor,
                     cond_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The main net at t = -1: the latent code (diffusion) or the
        reconstructed window (pretrain) (:63-68)."""
        t = torch.full((x.shape[0],), _CONST_T, dtype=torch.long,
                       device=x.device)
        return self.model(x, t, cond_emb)[0]

    def denoise_latent(self, z: torch.Tensor, t: torch.Tensor,
                       cond_emb: Optional[torch.Tensor]) -> torch.Tensor:
        return self.denoiser(z, t, cond_emb)

    def forward(self, cond_data: torch.Tensor, corrupt_data: torch.Tensor,
                t: torch.Tensor, eps: torch.Tensor, sqrt_a: torch.Tensor,
                sqrt_1ma: torch.Tensor):
        emb, rec = self.condition(cond_data)
        if self.stage == 'diffusion':
            latent = self.encode_input(corrupt_data, emb)
            # the noising at the coefficients' float32, the denoiser then at
            # the net's dtype again (:90-97)
            z_t = (sqrt_a[:, None] * latent.to(sqrt_a.dtype)
                   + sqrt_1ma[:, None] * eps)
            pred = self.denoise_latent(z_t.to(latent.dtype), t, emb)
            return pred, eps, rec
        return self.encode_input(corrupt_data, emb), corrupt_data, rec


class MoCoDADLatentModel(MoCoDADModel):
    """(mocodad_latent.py:105-338)"""

    def __init__(self, cfg: Config):
        self.stage = cfg.stage
        self.latent_embedding_dim = int(cfg.latent_embedding_dim)
        self.hidden_sizes = tuple(int(h) for h in cfg.hidden_sizes)
        super().__init__(cfg)
        if self.strategy != 'inject':
            raise ValueError('Conditioning strategy must be inject for the '
                             'latent variant (ref: mocodad_latent.py:32)')
        if self.hidden_sizes[-1] != self.latent_embedding_dim:
            # the MLP's last layer is its output: the latent DDPM is
            # well-formed only when it has the latent's width
            raise ValueError(
                f'hidden_sizes[-1] ({self.hidden_sizes[-1]}) must equal '
                f'latent_embedding_dim ({self.latent_embedding_dim}): the '
                'denoiser MLP predicts the latent-space noise')
        if self.stage == 'pretrain':
            # the pretrain stage always returns poses (:123-125)
            self.model_return_value = 'pose'
        # the diffusion stage starts from the pretrain stage's checkpoint
        # (mocodad_tpu/training/loop.py:141-155); the pretrain stage has no
        # generative per-window loss to serve (mocodad_tpu/serve.py:178-186)
        self.needs_pretrained = self.servable = self.stage == 'diffusion'

    def noise_shape(self, window: Tuple[int, ...]) -> Tuple[int, ...]:
        """The latent noise's shape per window."""
        return (self.latent_embedding_dim,)

    def build_net(self) -> MoCoDADLatentNet:
        cfg = self.cfg
        return MoCoDADLatentNet(
            stage=self.stage, latent_embedding_dim=self.latent_embedding_dim,
            hidden_sizes=self.hidden_sizes,
            num_coords=self.num_coords, n_joints=self.n_joints,
            embedding_dim=cfg.embedding_dim, dropout=cfg.dropout,
            strategy=self.strategy,
            conditioning_architecture=cfg.conditioning_architecture,
            h_dim=cfg.h_dim, latent_dim=cfg.latent_dim,
            channels=tuple(cfg.channels),
            n_frames_condition=self.n_frames_condition,
            input_n_frames=self.n_frames_corrupt)

    def fold(self, net: MoCoDADLatentNet) -> None:
        """Nothing to fold: no kernel runs on the latent paths."""
        return None

    def trainable_mask(self, net: MoCoDADLatentNet) -> Dict[str, bool]:
        """Stage 'diffusion' trains the denoiser alone; the pretrained
        encoder and the condition encoder are frozen (:158-167).  They stay
        in train mode, so their BatchNorm running statistics move, as the
        JAX step's mutated `batch_stats` do (mocodad_tpu/training/
        loop.py:243-256)."""
        diffusion = self.stage == 'diffusion'
        return {k: not diffusion or k.startswith('denoiser.')
                for k, _ in net.named_parameters()}

    # -- training ---------------------------------------------------------

    def loss(self, net: MoCoDADLatentNet, data: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sample_mask: Optional[torch.Tensor] = None,
             noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
             = None, mesh=None, order: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The stage's loss on `net` in its current mode (:169-239).

        Stage 'pretrain': the reconstruction loss of the corrupted frames
        ('loss_unet') plus rec_weight x the AE term ('loss_recons');
        stage 'diffusion': the latent noise-prediction loss
        ('loss_noise').  `noise_override = (t (B,), eps (B,
        latent_embedding_dim))` replaces the draws of t and the latent
        noise (pretrain draws t and eps too, and uses neither).  `mesh`
        and `order` as for `MoCoDADModel.loss`."""
        b = data.shape[0]
        dev = data.device
        schedule = self.tables(dev)[1]
        if order is None:
            order = self.rank_frame_order(generator, b, dev, mesh)
        cond_data, corrupt_data = F.select_frames(data, order,
                                                  self.n_frames_condition)
        if noise_override is not None:
            t, eps = (local_rows(torch.as_tensor(a), mesh)
                      for a in noise_override)
            t = t.to(dev).long()
            eps = eps.to(dev, torch.float32)
        else:
            t, eps = self.draw_noise(generator, b, tuple(data.shape[1:]),
                                     dev, mesh)
        a_hat = schedule.alpha_hat[t]
        args = (t, eps, torch.sqrt(a_hat), torch.sqrt(1.0 - a_hat))
        dt = self.train_dtype if net.training else torch.float32
        if dt == torch.float32:
            pred, target, rec = net(cond_data, corrupt_data, *args)
        else:
            params = {k: p.to(dt) for k, p in net.named_parameters()}
            pred, target, rec = torch.func.functional_call(
                net, params, (cond_data.to(dt), corrupt_data.to(dt), *args))
            pred = pred.float()
            rec = None if rec is None else rec.float()
            if self.stage != 'diffusion':
                # the target is the original float32 window (:213-218)
                target = corrupt_data
        total = self._global_weight(sample_mask, b, dev, mesh)
        loss = self._masked_mean(
            elementwise_loss(self.loss_kind, pred, target), sample_mask,
            total)
        if self.stage == 'diffusion':
            metrics = {'loss_noise': loss.detach()}
        else:
            metrics = {'loss_unet': loss.detach()}
            if rec is not None:
                loss_rec = self._masked_mean(torch.square(rec - cond_data),
                                             sample_mask, total)
                loss = loss + self.rec_weight * loss_rec
                metrics['loss_recons'] = loss_rec.detach()
        metrics['loss'] = loss.detach()
        return loss, self._global_metrics(metrics, mesh)

    # -- generation ---------------------------------------------------------

    @torch.no_grad()
    def generate(self, net: MoCoDADLatentNet, data: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 aggr_strategy: Optional[str] = None,
                 n_samples: Optional[int] = None,
                 noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None, folded=None, mesh=None
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(mocodad_latent.py:241-338)

        Stage 'pretrain': (the reconstructed corrupted frames, None).
        Stage 'diffusion': the latent DDPM or DDIM chain over S samples per
        window in the b-major fold (row = b*S + s), aggregated against
        the window's encoded latent: (selected latent or None, loss).
        `noise_override = (z0 (S*B, D), zs (n_chain_steps, S*B, D))`
        replaces the gaussian draws (and turns antithetic draws off).
        `rng` draws the rest, 'random' aggregation included.  Float32
        throughout, whatever `eval_dtype` says; `folded` is unused.  On a
        `mesh`, as `MoCoDADModel.generate`.
        """
        aggr = aggr_strategy or self.aggregation_strategy
        s = n_samples or self.n_generated_samples
        b, dev = data.shape[0], data.device
        order = self.rank_frame_order(rng, b, dev, mesh)
        cond_data, corrupt_data = F.select_frames(data, order,
                                                  self.n_frames_condition)
        cond_emb = net.encode_condition(cond_data)
        if self.stage != 'diffusion':
            return net.encode_input(corrupt_data, cond_emb), None
        if noise_override is None and rng is None:
            raise ValueError('generate needs a torch.Generator (rng) unless '
                             'noise_override is given')
        latent = net.encode_input(corrupt_data, cond_emb)
        d, n = self.latent_embedding_dim, s * b
        bg = global_rows(b, mesh)
        ng = bg * s
        emb_tiled = cond_emb.repeat_interleave(s, dim=0)
        ts, ddim = self.chain_steps()
        antithetic = self.antithetic and s > 1 and noise_override is None

        def draw() -> torch.Tensor:
            if not antithetic:
                return local_rows(torch.randn((ng, d), generator=rng,
                                              device=dev), mesh)
            return _mirror_fold(local_rows(torch.randn(
                (bg, (s + 1) // 2, d), generator=rng, device=dev), mesh), s)

        def given(a) -> torch.Tensor:
            return local_rows(torch.as_tensor(a), mesh).to(dev, torch.float32)

        if noise_override is not None:
            z0, zs = noise_override
            if tuple(z0.shape) != (ng, d) or \
                    tuple(zs.shape) != (len(ts), ng, d):
                raise ValueError(
                    f'noise_override must be ({ng}, {d}) and '
                    f'({len(ts)}, {ng}, {d}); got {tuple(z0.shape)} and '
                    f'{tuple(zs.shape)}')
            z = given(z0)
        else:
            z = draw()

        def noise(i: int) -> torch.Tensor:
            if noise_override is None:
                return draw()
            return given(noise_override[1][i])

        for i, t in enumerate(ts.tolist()):
            tb = torch.full((n,), t, dtype=torch.long, device=dev)
            eps = net.denoise_latent(z, tb, emb_tiled)
            if ddim is not None:
                cx, ce, cz = (float(a[i]) for a in ddim)
                z = cx * z + ce * eps
                if self.ddim_eta != 0.0:
                    z = z + cz * noise(i)
            else:
                c1, c2, c3 = ddpm_step_coefficients(self.schedule, t)
                z = c1 * (z - c2 * eps)
                if t > 1:
                    z = z + c3 * noise(i)
        zs = z.reshape(b, s, d).permute(1, 0, 2)
        return aggregate(aggr, self.loss_kind, zs, latent, generator=rng,
                         mesh=mesh)

    def window_losses(self, net: MoCoDADLatentNet, data: torch.Tensor,
                      rng: Optional[torch.Generator] = None,
                      noise_override=None, folded=None, mesh=None
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Stage 'diffusion': `generate`'s.  Stage 'pretrain':
        `reconstruction_losses`, as the JAX eval step scores it
        (mocodad_tpu/training/loop.py:295-305); no noise is drawn."""
        if self.stage == 'pretrain':
            return self.reconstruction_losses(net, data, rng, mesh)
        return self.generate(net, data, rng, noise_override=noise_override,
                             mesh=mesh)

    def returns_pose(self) -> bool:
        """The pretrain stage's reconstruction is its pose, whatever the
        aggregation strategy."""
        return self.stage == 'pretrain' or super().returns_pose()

    @torch.no_grad()
    def reconstruction_losses(self, net: MoCoDADLatentNet,
                              data: torch.Tensor,
                              rng: Optional[torch.Generator] = None,
                              mesh=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 'pretrain''s eval route: (reconstruction, per-window mean of
        the elementwise loss against the corrupted frames)
        (mocodad_tpu/training/loop.py:295-305)."""
        order = self.rank_frame_order(rng, data.shape[0], data.device, mesh)
        _, corrupt = F.select_frames(data, order, self.n_frames_condition)
        pose, _ = self.generate(net, data, rng, mesh=mesh)
        per = elementwise_loss(self.loss_kind, pose, corrupt)
        return pose, per.reshape(per.shape[0], -1).mean(dim=-1)
