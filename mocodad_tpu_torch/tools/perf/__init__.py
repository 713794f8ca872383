"""Probe scripts of the port's denoiser kernels, run on the card as
`python -m mocodad_tpu_torch.tools.perf.<name>`."""
