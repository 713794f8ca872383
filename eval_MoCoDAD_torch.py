"""Evaluate a MoCoDAD checkpoint with the PyTorch port: frame-level AUC-ROC
(the counterpart of eval_MoCoDAD.py, including the load_tensors replay).

    python eval_MoCoDAD_torch.py -c config/UBnormal/mocodad_test.yaml
    python eval_MoCoDAD_torch.py -c <config> --device cpu
    python eval_MoCoDAD_torch.py -c <config> --report   # + report_{split}.html

Both stages of the latent variant (config/UBnormal/mocodad-latent_*.yaml)
run here too; they launch no kernel of the port and compute in float32
at any `eval_dtype`, as the JAX latent model does.  `--report` writes the
per-clip score-analysis HTML page (mocodad_tpu_torch/viz/report.py, which
needs matplotlib) into ckpt_dir next to the AUC, on the live and on the
load_tensors route, as eval_MoCoDAD.py does.

The checkpoint (ckpt_dir/load_ckpt) is a reference-named state dict written
by torch.save, bare or as Lightning's {'state_dict': ...}, or a checkpoint
of train_MoCoDAD_torch.py.  The default device is the GPU; the script
exits with an error when CUDA is absent unless --device cpu is given.

`--n-devices N` (default 1) scores the split on N ranks, one process and
one GPU each (`--device cpu`: N CPU processes), each rank its block of
every batch's rows, and exits non-zero if any rank fails; batch_size must
be a multiple of N.  Under MOCODAD_COORDINATOR / MOCODAD_NUM_PROCESSES /
MOCODAD_PROCESS_ID, or torchrun's variables, the process joins that group
as one rank instead.  Rank 0 prints the AUC and writes the files; the AUC
does not depend on N.

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
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description='MoCoDAD (PyTorch)')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    parser.add_argument('--n-devices', type=int, default=1,
                        help='data-parallel ranks, one device each')
    parser.add_argument('--report', action='store_true',
                        help='also write the per-clip score-analysis HTML '
                             'report (viz/report.py) next to the AUC')
    from mocodad_tpu_torch.config import add_eval_profile_arg
    add_eval_profile_arg(parser)
    cli = parser.parse_args(argv)

    from mocodad_tpu_torch.ops.pallas_unet import build_main_kernels
    from mocodad_tpu_torch.parallel import launch
    return launch(run, (cli,), cli.n_devices, cli.device,
                  prepare=build_main_kernels if cli.device == 'cuda'
                  else None)


def run(cli):
    """One rank's (or the only process's) evaluation; returns the AUC."""
    from mocodad_tpu_torch.config import (apply_eval_profile,
                                          effective_n_generated_samples,
                                          load_config)
    from mocodad_tpu_torch.eval.harness import post_processing_from_config
    from mocodad_tpu_torch.parallel import is_main_process

    cfg = load_config(cli.config)
    apply_eval_profile(cfg, cli.eval_profile)
    main = is_main_process()

    if cfg.load_tensors:
        # scoring-only replay of cached predictions
        # (ref: models/mocodad.py:433-448)
        from mocodad_tpu_torch.utils.tensors import load_tensors
        t = load_tensors(cfg.ckpt_dir, cfg.split, cfg.aggregation_strategy,
                         effective_n_generated_samples(cfg))
        pred = t.get('loss', t['prediction'])
        auc = post_processing_from_config(
            pred, t['trans'], t['metadata'], t['frames'], cfg)
        if not main:
            return auc
        print(f'AUC score: {auc:.6f}')
        if cli.report:
            _write_report(pred, t['trans'], t['metadata'], t['frames'], cfg,
                          auc)
        return auc

    from mocodad_tpu_torch.training.inference import (
        export_prediction_tensors, restore_and_infer)
    model, ds, res = restore_and_infer(
        cfg, device=cli.device,
        n_devices=None if cli.n_devices == 1 else cli.n_devices,
        with_pose=None if cfg.save_tensors else False)
    if cfg.save_tensors and main:
        export_prediction_tensors(model, ds, res, cfg)
    auc = post_processing_from_config(res['loss'], res['trans'], res['meta'],
                                      res['frames'], cfg)
    if not main:
        return auc
    print(f'AUC score: {auc:.6f}')
    if cli.report:
        _write_report(res['loss'], res['trans'], res['meta'], res['frames'],
                      cfg, auc)
    return auc


def _write_report(out, trans, meta, frames, cfg, auc):
    from mocodad_tpu_torch.viz import html_report
    path = os.path.join(cfg.ckpt_dir, f'report_{cfg.split}.html')
    html_report(out, trans, meta, frames, cfg.gt_path, path,
                frames_shift=cfg.frames_shift,
                kernel_size=cfg.filter_kernel_size, auc=auc)
    print(f'report written to {path}')


if __name__ == '__main__':
    main()
