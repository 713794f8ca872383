"""Train a MoCoDAD model with the PyTorch port (the counterpart of
train_MoCoDAD.py: same --config flag, same YAML contract, same monitored
metric and top-2 checkpoints).

    python train_MoCoDAD_torch.py -c config/UBnormal/mocodad_train.yaml
    python train_MoCoDAD_torch.py -c <config> --resume        # last.ckpt
    python train_MoCoDAD_torch.py -c <config> --device cpu

The latent variant trains in two runs: config/UBnormal/
mocodad-latent_train.yaml at `stage: pretrain` (monitoring the validation
reconstruction loss), then the same config at `stage: diffusion`, whose
`pretrained_model_ckpt_path` names the first run's best_weights.ckpt; the
second run trains the latent denoiser alone on the frozen encoders.

Checkpoints land in the config's ckpt_dir: last.ckpt, the top-2 by the
monitored metric (the validation AUC when `validation: true`),
best_weights.ckpt and topk.json, each a torch.save dict that
eval_MoCoDAD_torch.py reads.  The default device is the GPU; the script
exits with an error when CUDA is absent unless --device cpu is given.
Multi-GPU training is not ported.
"""

import argparse
import random

import numpy as np


def main():
    parser = argparse.ArgumentParser(description='Pose_AD_Experiment')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--resume', nargs='?', const='auto', default=None,
                        help='resume training from a checkpoint (bare flag '
                             '= ckpt_dir/last.ckpt)')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    cli = parser.parse_args()

    from mocodad_tpu_torch.device import resolve_device
    device = resolve_device(cli.device)

    from mocodad_tpu_torch.config import load_config
    cfg = load_config(cli.config)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)

    from mocodad_tpu_torch.data import build_dataset
    from mocodad_tpu_torch.training.loop import Trainer, monitored_metric_for

    monitor, mode = monitored_metric_for(cfg)
    print(f'checkpointing on {monitor} ({mode})')
    train_ds = build_dataset(cfg, split=cfg.split)
    val_ds = build_dataset(cfg, split='validation') if cfg.validation else None
    print(f'train windows: {train_ds.num_samples} '
          f'(x{train_ds.num_transform} transforms)')
    trainer = Trainer(cfg, device=device)
    trainer.fit(train_ds, val_ds, resume=cli.resume)
    print(f'done; checkpoints in {cfg.ckpt_dir}')


if __name__ == '__main__':
    main()
