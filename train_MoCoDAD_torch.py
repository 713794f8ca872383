"""Train a MoCoDAD model with the PyTorch port (the counterpart of
train_MoCoDAD.py: same --config flag, same YAML contract, same monitored
metric and top-2 checkpoints).

    python train_MoCoDAD_torch.py -c config/UBnormal/mocodad_train.yaml
    python train_MoCoDAD_torch.py -c <config> --resume        # last.ckpt
    python train_MoCoDAD_torch.py -c <config> --device cpu
    python train_MoCoDAD_torch.py -c <config> --n-devices 2   # 2 GPUs

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

Data parallelism: `--n-devices N` (default 1) starts N ranks, one process
and one GPU each (`--device cpu`: N CPU processes over gloo), and exits
non-zero if any rank fails; batch_size must be a multiple of N.  Under
MOCODAD_COORDINATOR / MOCODAD_NUM_PROCESSES / MOCODAD_PROCESS_ID, or
torchrun's variables, the process joins that group as one rank instead
(mocodad_tpu_torch/parallel/distributed.py).  The ranks train what one
process trains at the same batch size; rank 0 writes the files.
"""

import argparse
import random

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description='Pose_AD_Experiment')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--resume', nargs='?', const='auto', default=None,
                        help='resume training from a checkpoint (bare flag '
                             '= ckpt_dir/last.ckpt)')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    parser.add_argument('--n-devices', type=int, default=1,
                        help='data-parallel ranks, one device each')
    cli = parser.parse_args(argv)

    from mocodad_tpu_torch.ops.pallas_unet import build_main_kernels
    from mocodad_tpu_torch.parallel import launch
    return launch(run, (cli,), cli.n_devices, cli.device,
                  prepare=build_main_kernels if cli.device == 'cuda'
                  else None)


def run(cli) -> None:
    """One rank's (or the only process's) training run."""
    from mocodad_tpu_torch.config import load_config
    from mocodad_tpu_torch.data import build_dataset
    from mocodad_tpu_torch.parallel import is_main_process, make_mesh
    from mocodad_tpu_torch.training.loop import Trainer, monitored_metric_for

    mesh = make_mesh(None if cli.n_devices == 1 else cli.n_devices,
                     device=cli.device)
    cfg = load_config(cli.config)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    main = is_main_process()
    monitor, mode = monitored_metric_for(cfg)
    if main:
        print(f'checkpointing on {monitor} ({mode})')
    train_ds = build_dataset(cfg, split=cfg.split)
    val_ds = build_dataset(cfg, split='validation') if cfg.validation else None
    if main:
        print(f'train windows: {train_ds.num_samples} '
              f'(x{train_ds.num_transform} transforms)')
    trainer = Trainer(cfg, mesh=mesh)
    trainer.fit(train_ds, val_ds, resume=cli.resume)
    if main:
        print(f'done; checkpoints in {cfg.ckpt_dir}')


if __name__ == '__main__':
    main()
