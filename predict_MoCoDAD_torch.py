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
given.  Multi-GPU inference (predict_MoCoDAD.py's --n-devices) is not
ported.
"""

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description='MoCoDAD (PyTorch)')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    from mocodad_tpu_torch.config import (add_eval_profile_arg,
                                          apply_eval_profile, load_config)
    add_eval_profile_arg(parser)
    cli = parser.parse_args(argv)
    cfg = load_config(cli.config)
    apply_eval_profile(cfg, cli.eval_profile)
    cfg.save_tensors = True
    cfg.load_tensors = False

    from mocodad_tpu_torch.training.inference import (
        export_prediction_tensors, restore_and_infer)
    model, ds, res = restore_and_infer(cfg, device=cli.device)
    path = export_prediction_tensors(model, ds, res, cfg)
    print(f'saved tensors to {path}')
    return path


if __name__ == '__main__':
    main()
