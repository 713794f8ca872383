"""Evaluate a MoCoDAD checkpoint with the PyTorch port: frame-level AUC-ROC
(the counterpart of eval_MoCoDAD.py, including the load_tensors replay).

    python eval_MoCoDAD_torch.py -c config/UBnormal/mocodad_test.yaml
    python eval_MoCoDAD_torch.py -c <config> --device cpu

The checkpoint (ckpt_dir/load_ckpt) is a reference-named state dict written
by torch.save, bare or as Lightning's {'state_dict': ...}, or a checkpoint
of train_MoCoDAD_torch.py.  The default device is the GPU; the script
exits with an error when CUDA is absent unless --device cpu is given.

With `eval_dtype: bfloat16` the port computes the function of the JAX
package's `build_pallas_eval` (the one its bfloat16 kernel computes: the
condition encoder and each DDPM update in float32, x rounded to bfloat16
between steps), not that of eval_MoCoDAD.py at bfloat16, whose
`generate()` also runs the encoder in bfloat16 and keeps the update in
bfloat16.  On the same weights and noise their per-window losses differ
by 0.3-0.6 % of the largest loss (tests/test_torch_generate_bf16_xla.py);
at float32 the two packages agree within 3.1e-7.
"""

import argparse


def main():
    parser = argparse.ArgumentParser(description='MoCoDAD (PyTorch)')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    from mocodad_tpu_torch.config import (add_eval_profile_arg,
                                          apply_eval_profile,
                                          effective_n_generated_samples,
                                          load_config)
    add_eval_profile_arg(parser)
    cli = parser.parse_args()
    cfg = load_config(cli.config)
    apply_eval_profile(cfg, cli.eval_profile)

    from mocodad_tpu_torch.eval.harness import post_processing_from_config

    if cfg.load_tensors:
        # scoring-only replay of cached predictions
        # (ref: models/mocodad.py:433-448)
        from mocodad_tpu_torch.utils.tensors import load_tensors
        t = load_tensors(cfg.ckpt_dir, cfg.split, cfg.aggregation_strategy,
                         effective_n_generated_samples(cfg))
        pred = t.get('loss', t['prediction'])
        auc = post_processing_from_config(
            pred, t['trans'], t['metadata'], t['frames'], cfg)
        print(f'AUC score: {auc:.6f}')
        return auc

    from mocodad_tpu_torch.training.inference import (
        export_prediction_tensors, restore_and_infer)
    model, ds, res = restore_and_infer(
        cfg, device=cli.device,
        with_pose=None if cfg.save_tensors else False)
    if cfg.save_tensors:
        export_prediction_tensors(model, ds, res, cfg)
    auc = post_processing_from_config(res['loss'], res['trans'], res['meta'],
                                      res['frames'], cfg)
    print(f'AUC score: {auc:.6f}')
    return auc


if __name__ == '__main__':
    main()
