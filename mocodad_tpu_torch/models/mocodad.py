"""MoCoDAD: the network container and multi-sample generation.

PyTorch counterpart of `mocodad_tpu/models/mocodad.py` (reference
models/mocodad.py).  The port covers every conditioning strategy (inject
with the AE / E / E_unet condition encoders, concat, inbetween_imp,
random_imp, no_condition) and the STSAEUnet denoiser: the training loss of
`loss` (at `train_dtype` float32 or bfloat16) and the DDPM or DDIM chain of
`generate`, with antithetic draws on request (at `eval_dtype` float32 or
bfloat16); another dtype raises NotImplementedError.  The latent variant
subclasses this model in `models/mocodad_latent.py`, and `build_model`
dispatches to it.

Generation folds the sample axis S into the batch, b-major
(row = b*S + s), and runs the chain with the sampler state in the
denoiser's (C, T*V, N) layout, as `build_pallas_eval` does
(mocodad_tpu/models/mocodad.py:502-567): each step assembles the U-Net
input in that layout (the conditioning frames beside the chain's for
concat and the imputation strategies, `frames.assemble_ctn`), computes
silu(cond_emb + t_emb) for inject, or silu(t_emb) for the others, once as
(E, N) in float32, calls `ops.pallas_unet.denoise` (the CUDA kernel B1 on
a CUDA tensor, at every frame count the strategies give, its plain version
on a CPU tensor), keeps the corrupted frames' eps, and applies the DDPM
update c1 (x - c2 eps) + c3 z (z = 0 at t == 1) or the DDIM update
c_x x + c_eps eps (+ c_z z when eta != 0) in float32.  The JAX package runs
the non-inject strategies through its XLA forward (`_make_denoise_fn`,
:569-583); B1 computes the same function at any T when given silu(t_emb),
so here it is the denoiser of every strategy.

`eval_dtype: bfloat16` follows `build_pallas_eval` (:516-565), which runs
the JAX package's kernel B1, and not the JAX `generate()` at bfloat16
(:401-407, :480-487), which is another function: it casts every variable
to bfloat16, the condition encoder's included, runs the XLA fast path,
and keeps the DDPM update in bfloat16.  Here, as in `build_pallas_eval`,
the condition encoder runs in float32; x is bfloat16 between steps
(:539, :557), and the denoiser computes in bfloat16 with float32
accumulation; each step's update is computed in float32 from the
float32 eps, with z drawn in float32 (:548-557), then rounded back to
bfloat16; the losses are float32 (:562-565).  The conditioning frames of
an assembled input are rounded to bfloat16 as they enter the kernel.

Data parallelism (`mesh`, parallel/): a rank holds its block of the
global batch's rows.  Every random tensor (the frame orders, t, eps, the
chain's gaussians, the 'random' aggregation's choices) is drawn at the
global batch's size from the same generator state on every rank, and the
rank keeps its block (in the fold, b-major, a rank's windows are one
contiguous run of columns), so W ranks compute what one does.  The
loss's masked means divide the rank's sum by the global denominator, and
its metrics are summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mocodad_tpu_torch.config import Config, effective_n_generated_samples
from mocodad_tpu_torch.diffusion import (DiffusionSchedule, ddim_plan,
                                         ddim_timesteps,
                                         ddpm_step_coefficients,
                                         forward_noise, make_schedule,
                                         sample_timesteps)
from mocodad_tpu_torch.models import frames as F
from mocodad_tpu_torch.models.losses import (aggregate, elementwise_loss,
                                              selects_pose)
from mocodad_tpu_torch.nn import (STSAE, STSE, STSAEUnet, STSEUnet,
                                  sinusoidal_pos_encoding)
from mocodad_tpu_torch.ops.pallas_unet import (FoldedDenoiser, denoise,
                                               fold_denoiser)
from mocodad_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                    global_rows,
                                                    is_distributed,
                                                    local_rows)

EVAL_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _dtype_key(cfg: Config, key: str) -> torch.dtype:
    name = str(cfg.extras.get(key, 'float32'))
    if name not in EVAL_DTYPES:
        raise NotImplementedError(
            f'{key} {name!r} is not ported (float32 or bfloat16)')
    return EVAL_DTYPES[name]


def _mirror_fold(z_half: torch.Tensor, s: int) -> torch.Tensor:
    """(B, ceil(S/2), ...) independent gaussians -> the (S*B, ...) b-major
    sample fold where each window's samples are [z_0..z_{h-1},
    -z_0..-z_{s-h-1}], antithetic pairs (mocodad_tpu/models/mocodad.py
    :36-42)."""
    b, h = z_half.shape[:2]
    z = torch.cat([z_half, -z_half[:, :s - h]], dim=1)
    return z.reshape((s * b,) + tuple(z_half.shape[2:]))


class MoCoDADNet(nn.Module):
    """The condition encoder and the main U-Net in one module, named as the
    reference's LightningModule (`condition_encoder`, `model`;
    ref `build_model`, models/mocodad.py:90-126), so a reference state dict
    loads with `strict=True`.  `model` replaces the main U-Net (the latent
    variant's `make_main_net`, mocodad_tpu/models/mocodad.py:92)."""

    def __init__(self, num_coords: int, n_joints: int, embedding_dim: int,
                 dropout: float, strategy: str,
                 conditioning_architecture: Optional[str], h_dim: int,
                 latent_dim: int, channels, n_frames_condition: int,
                 input_n_frames: int, model: Optional[nn.Module] = None):
        super().__init__()
        self.condition_encoder = None
        if strategy == 'inject':
            if conditioning_architecture in ('AE', 'E'):
                enc = STSAE if conditioning_architecture == 'AE' else STSE
                self.condition_encoder = enc(
                    c_in=num_coords, h_dim=h_dim, latent_dim=latent_dim,
                    n_frames=n_frames_condition, n_joints=n_joints,
                    layer_channels=tuple(channels), dropout=dropout)
            elif conditioning_architecture == 'E_unet':
                self.condition_encoder = STSEUnet(
                    c_in=num_coords, embedding_dim=None,
                    latent_dim=latent_dim, n_frames=n_frames_condition,
                    n_joints=n_joints, dropout=dropout, set_out_layer=True)
            else:
                raise NotImplementedError(
                    f'Conditioning architecture {conditioning_architecture} '
                    'not implemented.')
        self.model = model if model is not None else STSAEUnet(
            c_in=num_coords, embedding_dim=embedding_dim,
            n_frames=input_n_frames, n_joints=n_joints, dropout=dropout,
            inject_condition=(strategy == 'inject'))

    def encode_condition(self, cond: Optional[torch.Tensor]
                         ) -> Optional[torch.Tensor]:
        """The conditioning latent (ref `_encode_condition`,
        models/mocodad.py:546-560), or None without an encoder or
        conditioning frames; the AE's reconstruction is not needed at eval
        time and is not computed."""
        enc = self.condition_encoder
        if enc is None or cond is None:
            return None
        if isinstance(enc, STSEUnet):
            return enc(cond)[0]
        return enc.encode(cond)

    def denoise(self, x: torch.Tensor, t: torch.Tensor,
                cond_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The module forward of the U-Net (the folded denoiser's oracle)."""
        pred, _ = self.model(x, t, cond_emb)
        return pred

    def condition(self, cond: Optional[torch.Tensor]
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(conditioning latent, the AE's reconstruction of `cond` or None)
        with the whole encoder in the net's mode, as training runs it
        (mocodad_tpu/models/mocodad.py:99-115): E_unet's hidden-state list
        is no reconstruction."""
        if self.condition_encoder is None or cond is None:
            return None, None
        latent, rec = self.condition_encoder(cond)
        return latent, (None if isinstance(rec, list) else rec)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(eps prediction, the AE's reconstruction of `cond` or None)
        (mocodad_tpu/models/mocodad.py:123-125)."""
        latent, rec = self.condition(cond)
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
        self._static_order = (None if cond_idxs is None else
                              F.static_order(cond_idxs, corrupt_idxs))
        self.loss_kind = cfg.loss_fn
        self.rec_weight = cfg.rec_weight
        self.aggregation_strategy = cfg.aggregation_strategy
        self.model_return_value = cfg.model_return_value
        self.schedule = make_schedule(cfg.noise_steps)
        self.eval_dtype = _dtype_key(cfg, 'eval_dtype')
        # the net's forward and backward in training; master params, grads,
        # BN running statistics, the noising and the loss stay float32
        self.train_dtype = _dtype_key(cfg, 'train_dtype')
        # the reverse sampler (mocodad_tpu/models/mocodad.py:199-218):
        # 'ddpm', the reference chain, or 'ddim' over `ddim_steps` timesteps
        # with noise scale `ddim_eta`; antithetic draws mirror half the
        # gaussians per window
        self.sampler = str(cfg.extras.get('sampler', 'ddpm'))
        if self.sampler not in ('ddpm', 'ddim'):
            raise ValueError(f"sampler must be 'ddpm' or 'ddim', "
                             f"got {self.sampler!r}")
        self.ddim_steps = int(cfg.extras.get('ddim_steps',
                                             cfg.noise_steps - 1))
        self.ddim_eta = float(cfg.extras.get('ddim_eta', 0.0))
        self.antithetic = bool(cfg.extras.get('antithetic', False))
        self.n_generated_samples = effective_n_generated_samples(cfg)
        self._device_tables = {}

    def tables(self, device: torch.device
               ) -> Tuple[Optional[torch.Tensor], DiffusionSchedule]:
        """The static frame order (None for random_imp) and the schedule
        with its alpha-bar table, as tensors on `device`, copied there
        once: a copy from pageable host memory inside a step would stall
        the host until the card is idle."""
        out = self._device_tables.get(device)
        if out is None:
            out = (None if self._static_order is None else
                   torch.as_tensor(self._static_order, device=device),
                   self.schedule._replace(alpha_hat=torch.as_tensor(
                       self.schedule.alpha_hat, device=device)))
            self._device_tables[device] = out
        return out

    def frame_order(self, generator: Optional[torch.Generator], batch: int,
                    device: Optional[torch.device] = None):
        """(T,) static or (B, T) random frame order on `device` (the
        generator's by default); see models/frames.py
        (mocodad_tpu/models/mocodad.py:253-258)."""
        if device is None:
            device = generator.device if generator is not None else 'cpu'
        if self._static_order is not None:
            return self.tables(torch.device(device))[0]
        return F.random_order(generator, batch, self.n_frames,
                              self.n_frames_condition, device=device)

    def rank_frame_order(self, generator: Optional[torch.Generator],
                         rows: int, device: torch.device, mesh):
        """`frame_order` for the rank's `rows` of a global batch on `mesh`:
        drawn for the global batch, the rank's block kept."""
        order = self.frame_order(generator, global_rows(rows, mesh), device)
        return order if order.dim() == 1 else local_rows(order, mesh)

    @property
    def draws_order(self) -> bool:
        """Whether `frame_order` draws (random_imp) rather than returning
        the static order."""
        return self._static_order is None

    def noise_shape(self, window: Tuple[int, ...]) -> Tuple[int, ...]:
        """The forward noise's shape per window of shape `window` (C, T,
        V): the corrupted frames'."""
        c, t, v = window
        return (c, t - self.n_frames_condition, v)

    def draw_noise(self, generator: Optional[torch.Generator], rows: int,
                   window: Tuple[int, ...], device: torch.device, mesh=None,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`loss`'s draws of t (rows,) and the forward noise (rows,
        *noise_shape(window)) for the rank's `rows` of a global batch:
        drawn at the global size, t first, the rank's block kept."""
        bg = global_rows(rows, mesh)
        t = local_rows(sample_timesteps(bg, self.schedule.noise_steps,
                                        generator), mesh)
        eps = local_rows(torch.randn((bg,) + self.noise_shape(window),
                                     generator=generator, device=device,
                                     dtype=dtype), mesh)
        return t, eps

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

    # Overridden by the latent variant's stages (models/mocodad_latent.py):
    # whether `Trainer` copies `pretrained_model_ckpt_path` in first, and
    # whether `StreamScorer` serves the model.
    needs_pretrained = False
    servable = True

    def window_losses(self, net: MoCoDADNet, data: torch.Tensor,
                      rng: Optional[torch.Generator] = None,
                      noise_override=None, folded=None, mesh=None
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(selected poses or None, per-window loss) of one batch of views:
        what `run_inference` and `StreamScorer` score a window by; here
        `generate` with the model's aggregation."""
        return self.generate(net, data, rng, noise_override=noise_override,
                             folded=folded, mesh=mesh)

    def returns_pose(self) -> bool:
        """Whether `window_losses` gives selected poses."""
        return selects_pose(str(self.aggregation_strategy))

    def trainable_mask(self, net: MoCoDADNet) -> Dict[str, bool]:
        """Which parameters train, by name: all of them
        (mocodad_tpu/training/loop.py:127-129 applies no mask here)."""
        return {k: True for k, _ in net.named_parameters()}

    @staticmethod
    def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor],
                     total: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean over all elements, each sample weighted by its mask entry
        (mocodad_tpu/models/mocodad.py:262-274).  `total`, on a mesh, is
        the global batch's sum of weights (`_global_weight`): the rank's
        weighted sum over the global denominator, its share of the global
        mean."""
        per_sample = max(1, int(np.prod(x.shape[1:])))
        if total is not None:
            if sample_mask is not None:
                x = x * sample_mask.reshape((-1,) + (1,) * (x.ndim - 1))
            return x.sum() / (total * per_sample)
        if sample_mask is None:
            return x.mean()
        m = sample_mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x * m).sum() / (sample_mask.sum() * per_sample)

    @staticmethod
    def _global_weight(sample_mask: Optional[torch.Tensor], rows: int,
                       device: torch.device, mesh) -> Optional[torch.Tensor]:
        """The global batch's sum of mask weights (its row count without a
        mask) on a mesh, for `_masked_mean`; None off a mesh."""
        if not is_distributed(mesh):
            return None
        w = (sample_mask.sum().float().reshape(1) if sample_mask is not None
             else torch.full((1,), float(rows), device=device))
        return all_reduce_sum(w, mesh)[0]

    @staticmethod
    def _global_metrics(metrics: Dict[str, torch.Tensor], mesh
                        ) -> Dict[str, torch.Tensor]:
        """Each metric summed over the ranks (each rank's is its share of
        the global mean): the global values, the same on every rank."""
        if not is_distributed(mesh):
            return metrics
        total = all_reduce_sum(torch.stack(list(metrics.values())), mesh)
        return dict(zip(metrics, total))

    def loss(self, net: MoCoDADNet, data: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sample_mask: Optional[torch.Tensor] = None,
             noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
             = None, mesh=None, order: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Noise-prediction loss plus the AE reconstruction term, on `net`
        in its current mode (mocodad_tpu/models/mocodad.py:276-368).

        data: (B, C, T, V) on the device to run on; `generator`, on that
        device, draws the frame order (random_imp), then t and the forward
        noise (`draw_noise`), unless `order` or `noise_override = (t,
        eps)` is given.  In train mode the BatchNorm running statistics
        update in place on `net` (JAX returns them as `mutated`).  Returns
        (loss, metrics) with metrics 'loss_noise', 'loss_recons' (AE only)
        and 'loss', detached.

        On a `mesh`, data and sample_mask are the rank's rows of the
        global batch, `noise_override` is global, the draws are the
        global batch's, the loss is the rank's share of the global loss
        (the ranks' gradients sum to the global gradient) and the metrics
        are global.
        """
        b = data.shape[0]
        dev = data.device
        schedule = self.tables(dev)[1]
        if order is None:
            order = self.rank_frame_order(generator, b, dev, mesh)
        cond_data, corrupt_data = F.select_frames(data, order,
                                                  self.n_frames_condition)
        inject_cond = cond_data if self.strategy == 'inject' else None
        if noise_override is not None:
            t, eps = (local_rows(torch.as_tensor(a), mesh)
                      for a in noise_override)
            t = t.to(dev).long()
            eps = eps.to(dev, corrupt_data.dtype)
        else:
            t, eps = self.draw_noise(generator, b, tuple(data.shape[1:]),
                                     dev, mesh, corrupt_data.dtype)
        x_t, noise = forward_noise(schedule, corrupt_data, t, eps=eps)
        x_in = F.assemble_input(self.strategy, cond_data, x_t, order,
                                self.n_frames_condition)
        dt = self.train_dtype if net.training else torch.float32
        if dt == torch.float32:
            pred, rec = net(x_in, t, inject_cond)
        else:
            # params cast inside the differentiated graph, so their grads
            # land on the float32 masters; the BN buffers are not passed,
            # so the module's own float32 accumulators update
            params = {k: p.to(dt) for k, p in net.named_parameters()}
            pred, rec = torch.func.functional_call(
                net, params, (x_in.to(dt), t,
                              None if inject_cond is None
                              else inject_cond.to(dt)))
            pred = pred.float()
            rec = None if rec is None else rec.float()
        pred = F.extract_corrupt(self.strategy, pred, order,
                                 self.n_frames_condition)
        total = self._global_weight(sample_mask, b, dev, mesh)
        loss_noise = self._masked_mean(
            elementwise_loss(self.loss_kind, pred, noise), sample_mask, total)
        metrics = {'loss_noise': loss_noise.detach()}
        loss = loss_noise
        if rec is not None:
            loss_rec = self._masked_mean(torch.square(rec - cond_data),
                                         sample_mask, total)
            loss = loss_noise + self.rec_weight * loss_rec
            metrics['loss_recons'] = loss_rec.detach()
        metrics['loss'] = loss.detach()
        return loss, self._global_metrics(metrics, mesh)

    def chain_steps(self) -> Tuple[np.ndarray, Optional[tuple]]:
        """The chain's timesteps, descending, and for DDIM its per-step
        (c_x, c_eps, c_z) (None for DDPM)."""
        if self.sampler == 'ddim':
            ts = ddim_timesteps(self.schedule.noise_steps, self.ddim_steps)
            return ts, ddim_plan(self.schedule, ts, self.ddim_eta)
        return np.arange(self.schedule.noise_steps - 1, 0, -1), None

    @torch.no_grad()
    def generate(self, net: MoCoDADNet, data: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 aggr_strategy: Optional[str] = None,
                 n_samples: Optional[int] = None,
                 noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None,
                 folded: Optional[FoldedDenoiser] = None, mesh=None
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Sample S futures per window and aggregate
        (ref `forward`, models/mocodad.py:129-184).

        net: the network in eval mode (the JAX function's `variables`).
        data: (B, C, T, V) on the device to run on.  rng: a generator on
        that device, for the random_imp frame orders and every gaussian
        draw (and the 'random' aggregation).  Returns (selected_x,
        loss_of_selected_x); selected_x is None for loss-only aggregations.

        `noise_override`, when given, is `(x0, zs)`: the initial noise
        (S*B, C, Tc, V) and the per-step noise (n_chain_steps, S*B, C, Tc,
        V), both in the b-major fold (row = b*S + s); n_chain_steps is
        noise_steps-1 for DDPM and the length of the DDIM timestep
        sequence for DDIM.  It replaces the gaussian draws (and turns
        antithetic draws off) so the chain can be compared step for step
        with the JAX package.  At bfloat16 x0 is rounded to bfloat16 (JAX
        draws it in bfloat16) and the per-step noise stays float32.
        `folded` is `self.fold(net)`, passed in by callers that generate
        many batches with one set of weights.  On a `mesh`, data is the
        rank's rows of the global batch and `noise_override` is global
        (its rows the global fold's); the rank's windows are scored.
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
        n_cond = self.n_frames_condition
        order = self.rank_frame_order(rng, b, dev, mesh)
        cond_data, corrupt_data = F.select_frames(data, order, n_cond)
        c, tc, v = self.num_coords, self.n_frames_corrupt, self.n_joints
        n, bg = b * s, global_rows(b, mesh)
        ng = bg * s
        dt = self.eval_dtype
        # (E, S*B), b-major fold: row = b*S + s
        cond_emb = net.encode_condition(
            cond_data if self.strategy == 'inject' else None)
        emb_t = (None if cond_emb is None else
                 cond_emb.repeat_interleave(s, dim=0).T.contiguous())
        # the conditioning frames in the chain's layout, at the chain's
        # dtype, for the strategies that put them beside its frames
        cond_ctn = None
        if self.strategy not in ('inject', 'no_condition'):
            cond_ctn = F.to_ctn(cond_data.repeat_interleave(s, dim=0)).to(dt)
        order_col = F.column_order(torch.as_tensor(order, device=dev), s)

        ts, ddim = self.chain_steps()
        antithetic = self.antithetic and s > 1 and noise_override is None

        def draw() -> torch.Tensor:
            # (C, Tc*V, N) float32 gaussians: the rank's columns of the
            # global fold's
            if not antithetic:
                return local_rows(torch.randn((c, tc * v, ng), generator=rng,
                                              device=dev), mesh, dim=2)
            half = local_rows(torch.randn((bg, (s + 1) // 2, c, tc * v),
                                          generator=rng, device=dev), mesh)
            return F.to_ctn(_mirror_fold(half, s))

        def given(a) -> torch.Tensor:
            # a global (N, C, Tc, V) draw -> the rank's (C, Tc*V, N)
            return F.to_ctn(local_rows(torch.as_tensor(a), mesh).to(
                dev, torch.float32))

        if noise_override is not None:
            x0, zs = noise_override
            if tuple(x0.shape) != (ng, c, tc, v) or \
                    tuple(zs.shape) != (len(ts), ng, c, tc, v):
                raise ValueError(
                    f'noise_override must be ({ng}, {c}, {tc}, {v}) and '
                    f'({len(ts)}, {ng}, {c}, {tc}, {v}); got '
                    f'{tuple(x0.shape)} and {tuple(zs.shape)}')
            x = given(x0)
        else:
            x = draw()
        x = x.to(dt)

        def noise(i: int) -> torch.Tensor:
            if noise_override is None:
                return draw()
            return given(noise_override[1][i])

        for i, t in enumerate(ts.tolist()):
            t_emb = sinusoidal_pos_encoding(
                torch.full((1,), t, device=dev), self.cfg.embedding_dim)
            if emb_t is None:
                silu_emb = torch.nn.functional.silu(t_emb).T.expand(
                    -1, n).contiguous()
            else:
                silu_emb = torch.nn.functional.silu(emb_t + t_emb.T)
            x_in = F.assemble_ctn(self.strategy, cond_ctn, x, order_col,
                                  n_cond, v)
            eps = F.extract_ctn(self.strategy, denoise(x_in, silu_emb, folded),
                                order_col, n_cond, v).float()
            x32 = x.float()
            if ddim is not None:
                cx, ce, cz = (float(a[i]) for a in ddim)
                x32 = cx * x32 + ce * eps
                if self.ddim_eta != 0.0:
                    x32 = x32 + cz * noise(i)
            else:
                c1, c2, c3 = ddpm_step_coefficients(self.schedule, t)
                x32 = c1 * (x32 - c2 * eps)
                if t > 1:
                    x32 = x32 + c3 * noise(i)
            x = x32.to(dt)
        # (C, Tc*V, B*S) -> (S, B, C, Tc, V) for aggregation
        xs = x.float().reshape(c, tc, v, b, s).permute(4, 3, 0, 1, 2)
        return aggregate(aggr, self.loss_kind, xs, corrupt_data,
                         generator=rng, mesh=mesh)


def build_model(cfg: Config) -> MoCoDADModel:
    """Model-class dispatch (ref: train_MoCoDAD.py:68): a config with
    `diffusion_on_latent` builds the latent variant
    (`models/mocodad_latent.py`)."""
    if cfg.diffusion_on_latent is not None:
        from mocodad_tpu_torch.models.mocodad_latent import \
            MoCoDADLatentModel
        return MoCoDADLatentModel(cfg)
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
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.running_mean.copy_(
                    0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape,
                                                       generator=g))
    return net
