"""Run inference with the PyTorch port and save the prediction tensors for
later replay (the counterpart of predict_MoCoDAD.py: prediction, gt_data,
trans, metadata and frames under
ckpt_dir/saved_tensors_{split}_{aggregation}_{n_generated_samples}/).

    python predict_MoCoDAD_torch.py -c config/UBnormal/mocodad_test.yaml
    python predict_MoCoDAD_torch.py -c <config> --device cpu

eval_MoCoDAD_torch.py replays the saved tensors with `load_tensors: true`.
The checkpoint (ckpt_dir/load_ckpt) is a `torch.save` file or a
JAX-package msgpack checkpoint.  The default device is the GPU, and the
script exits with an error when CUDA is absent unless --device cpu is
given.  `--n-devices N` (default 1) runs the pass on N ranks, one process
and one GPU each, as eval_MoCoDAD_torch.py does (or joins the group that
MOCODAD_* or torchrun's variables name); rank 0 saves the tensors, which
do not depend on N.
"""

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description='MoCoDAD (PyTorch)')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    parser.add_argument('--n-devices', type=int, default=1,
                        help='data-parallel ranks, one device each')
    from mocodad_tpu_torch.config import add_eval_profile_arg
    add_eval_profile_arg(parser)
    cli = parser.parse_args(argv)

    from mocodad_tpu_torch.ops.pallas_unet import build_main_kernels
    from mocodad_tpu_torch.parallel import launch
    return launch(run, (cli,), cli.n_devices, cli.device,
                  prepare=build_main_kernels if cli.device == 'cuda'
                  else None)


def run(cli):
    """One rank's (or the only process's) pass; rank 0 returns the saved
    tensors' directory, the others None."""
    from mocodad_tpu_torch.config import apply_eval_profile, load_config
    from mocodad_tpu_torch.parallel import is_main_process
    from mocodad_tpu_torch.training.inference import (
        export_prediction_tensors, restore_and_infer)

    cfg = load_config(cli.config)
    apply_eval_profile(cfg, cli.eval_profile)
    cfg.save_tensors = True
    cfg.load_tensors = False
    model, ds, res = restore_and_infer(
        cfg, device=cli.device,
        n_devices=None if cli.n_devices == 1 else cli.n_devices)
    if not is_main_process():
        return None
    path = export_prediction_tensors(model, ds, res, cfg)
    print(f'saved tensors to {path}')
    return path


if __name__ == '__main__':
    main()
