"""Typed experiment configuration.

Consumes the reference's YAML configs verbatim (same key names and
semantics as the reference's config/*/*.yaml, parsed by
the reference's train_MoCoDAD.py:29-31 into an argparse.Namespace) and
reproduces the derived-path logic of the reference's utils/argparser.py:4-43.

Unlike the reference (schema-less Namespace), the config here is a
dataclass with defaults, so partial YAMLs are valid; unknown keys are
preserved in `extras` and accessible as attributes.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

# Alias map for conditioning strategies, mirroring
# the reference's models/mocodad.py:25-29.
CONDITIONING_STRATEGIES = {
    'cat': 'concat', 'concat': 'concat',
    'add2layers': 'inject', 'inject': 'inject',
    'inbetween_imp': 'inbetween_imp', 'interleave': 'inbetween_imp',
    'random_indices': 'random_imp', 'random_imp': 'random_imp',
    'no_condition': 'no_condition', 'none': 'no_condition',
}


@dataclass
class Config:
    """All reference YAML keys, with the reference's effective defaults."""

    # -- General settings
    split: str = 'train'
    debug: bool = False
    seed: int = 999
    validation: bool = False
    use_hr: bool = True

    # -- Computational resources (reference: accelerator/devices for
    # Lightning; read by no code of this package, which takes an explicit
    # `device` argument instead)
    accelerator: str = 'gpu'
    devices: List[int] = field(default_factory=lambda: [0])

    # -- Paths
    dir_name: str = 'experiment'
    data_dir: str = './data/UBnormal/'
    exp_dir: str = './checkpoints'
    test_path: str = ''
    load_ckpt: str = ''
    create_experiment_dir: bool = True
    pretrained_model_ckpt_path: str = ''

    # -- Logging
    use_wandb: bool = False
    project_name: str = 'project_name'
    wandb_entity: str = 'entity_name'
    group_name: str = 'group_name'
    use_ema: bool = False

    # -- U-Net configuration
    embedding_dim: int = 16
    dropout: float = 0.0
    conditioning_strategy: str = 'inject'

    # -- Conditioning network configuration
    conditioning_architecture: str = 'AE'
    conditioning_indices: Union[int, List[int]] = field(
        default_factory=lambda: [0, 1, 2])
    h_dim: int = 32
    latent_dim: int = 16
    channels: List[int] = field(default_factory=lambda: [32, 16, 32])

    # -- Latent-variant configuration (mocodad-latent_*.yaml)
    diffusion_on_latent: Optional[bool] = None
    stage: str = 'pretrain'
    latent_embedding_dim: int = 64
    hidden_sizes: List[int] = field(default_factory=lambda: [64, 128, 128, 64])

    # -- Diffusion configuration
    noise_steps: int = 10

    # -- Optimizer / scheduler
    n_epochs: int = 100
    ae_epochs: int = 100
    opt_lr: float = 0.001

    # -- Losses
    loss_fn: str = 'smooth_l1'
    rec_weight: float = 0.01

    # -- Inference
    n_generated_samples: int = 5
    model_return_value: str = 'loss'
    aggregation_strategy: str = 'best'
    filter_kernel_size: float = 30
    frames_shift: int = 18
    save_tensors: bool = False
    load_tensors: bool = False

    # -- Dataset
    dataset_choice: str = 'UBnormal'
    seg_len: int = 6
    vid_res: List[int] = field(default_factory=lambda: [1080, 720])
    batch_size: int = 1024
    pad_size: int = -1
    headless: bool = False
    hip_center: bool = False
    kp18_format: bool = False
    normalization_strategy: str = 'robust'
    num_coords: int = 2
    num_transform: int = 5
    num_workers: int = 8
    seg_stride: int = 1
    seg_th: int = 0
    start_offset: int = 0
    symm_range: bool = True
    use_fitted_scaler: bool = False

    # -- Derived (filled by init_args)
    gt_path: str = ''
    pose_path: Dict[str, str] = field(default_factory=dict)
    ckpt_dir: str = ''

    # Unknown YAML keys, preserved round-trip.
    extras: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name):
        # Only called when normal lookup fails; surface extras as attributes.
        extras = object.__getattribute__(self, '__dict__').get('extras')
        if extras and name in extras:
            return extras[name]
        raise AttributeError(name)

    # ----- Derived model quantities -----

    @property
    def strategy(self) -> str:
        """Canonical conditioning strategy (alias-resolved)."""
        return CONDITIONING_STRATEGIES[self.conditioning_strategy]

    @property
    def n_joints(self) -> int:
        """Joint count inferred from dataset flags
        (ref: models/mocodad.py:563-580)."""
        if self.headless:
            return 14
        if self.kp18_format:
            return 18
        return 17

    def conditioning_split(self):
        """(n_frames_cond, n_frames_corrupt, input_n_frames), mirroring
        models/mocodad.py:753-796 (`_set_conditioning_strategy`)."""
        n_frames = self.seg_len
        strategy = self.strategy
        input_n_frames = n_frames
        ci = self.conditioning_indices
        if strategy == 'no_condition':
            n_cond = 0
        elif strategy == 'random_imp':
            if not isinstance(ci, int):
                raise ValueError(
                    'Random imputation requires an integer number of frames '
                    'to condition on, not a list of indices')
            n_cond = ci
        elif strategy == 'inbetween_imp':
            if isinstance(ci, int):
                # count what _select_frames actually selects:
                # arange(0, n_frames, step=ci) — the reference counts
                # n_frames // ci here (models/mocodad.py:776) which
                # disagrees with its own selection whenever ci does not
                # divide seg_len and crashes in a reshape; quirk fix
                n_cond = len(range(0, n_frames, ci))
            else:
                n_cond = len(ci)
        elif strategy in ('concat', 'inject'):
            if isinstance(ci, int):
                n_cond = n_frames // ci
            else:
                if ci != list(range(min(ci), max(ci) + 1)):
                    raise ValueError(
                        'Conditioning indices must be a list of consecutive '
                        'integers')
                if not (min(ci) == 0 or max(ci) == n_frames - 1):
                    raise ValueError(
                        'Conditioning indices must start from 0 or end at the '
                        'last frame')
                n_cond = len(ci)
            if strategy == 'inject':
                input_n_frames = n_frames - n_cond
        else:
            raise NotImplementedError(
                f'Conditioning strategy {strategy} not implemented')
        return n_cond, n_frames - n_cond, input_n_frames

    def cond_corrupt_indices(self):
        """Static (cond_idxs, corrupt_idxs) frame-index tuples for the
        non-random strategies, mirroring models/mocodad.py:708-750
        (`_select_frames`).  For 'random_imp' returns (None, None): indices
        are drawn per batch element at run time."""
        n_frames = self.seg_len
        strategy = self.strategy
        ci = self.conditioning_indices
        if strategy == 'random_imp':
            return None, None
        if strategy == 'no_condition':
            return (), tuple(range(n_frames))
        if isinstance(ci, int):
            if strategy == 'inbetween_imp':
                cond = tuple(range(0, n_frames, ci))
            else:
                cond = tuple(range(0, n_frames // ci))
        else:
            cond = tuple(ci)
        corrupt = tuple(i for i in range(n_frames) if i not in cond)
        return cond, corrupt

    def to_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != 'extras'}
        d.update(self.extras)
        return d


_FIELDS = {f.name for f in dataclasses.fields(Config)}


def load_config(path: str, finalize: bool = True) -> Config:
    """Load a reference-format YAML config file.

    PyYAML is imported here and nowhere else: code that builds its
    `Config` in Python (for example `chip_smoke.py`) runs without it."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = from_dict(raw)
    if finalize:
        cfg = init_args(cfg)
        copy_config_to_ckpt_dir(cfg, path)
    return cfg


def from_dict(raw: Dict[str, Any]) -> Config:
    known = {k: v for k, v in raw.items() if k in _FIELDS}
    extras = {k: v for k, v in raw.items() if k not in _FIELDS}
    cfg = Config(**known)
    cfg.extras = extras
    return cfg


def init_args(cfg: Config) -> Config:
    """Derived-path logic, mirroring utils/argparser.py:4-43."""
    if cfg.debug:
        cfg.ae_epochs = 10

    cfg.gt_path = cfg.test_path

    if cfg.dataset_choice in ('STC', 'HR-STC', 'HR-Avenue', 'UBnormal'):
        cfg.pose_path = {
            'train': os.path.join(cfg.data_dir, 'pose', 'training/tracked_person/'),
            'test': os.path.join(cfg.data_dir, 'pose', 'testing/tracked_person/'),
            'validation': os.path.join(cfg.data_dir, 'pose', 'validating/tracked_person/'),
        }
        if cfg.validation:
            cfg.gt_path = os.path.join(cfg.data_dir, 'validating', 'test_frame_mask')
    elif cfg.dataset_choice == 'Avenue':
        # The reference exits here ("Not usable yet", argparser.py:23-24);
        # we raise instead of exiting the interpreter.
        raise ValueError("dataset_choice 'Avenue' is not usable; use 'HR-Avenue'")

    cfg.ckpt_dir = create_experiment_dirs(cfg)
    return cfg


def create_experiment_dirs(cfg: Config) -> str:
    ckpt_dir = os.path.join(cfg.exp_dir, cfg.dataset_choice, cfg.dir_name)
    if cfg.create_experiment_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    return ckpt_dir


def copy_config_to_ckpt_dir(cfg: Config, config_path: str) -> None:
    """Copy the YAML into the experiment dir (ref: train_MoCoDAD.py:33)."""
    if cfg.ckpt_dir and os.path.isdir(cfg.ckpt_dir):
        dst = os.path.join(cfg.ckpt_dir, 'config.yaml')
        if os.path.abspath(config_path) != os.path.abspath(dst):
            shutil.copyfile(config_path, dst)


# Aggregation families whose AUC measurably moves when `eval_profile:
# fast` caps the sample count to ~10 (tools/perf/study_aggr.py: 7
# scalar aggregations x S{50,26,10} x 3 seeds x 4 synthetic operating
# points; decision rule |AUC(S=10) - AUC(S=50)| > max(2 x seed spread,
# 0.005) at any operating point — the JAX package's PERF_NOTES.md "Fast-profile
# aggregation frontier").  Keyed by family (the part before ':').
FAST_PROFILE_UNSAFE_AGGREGATIONS = frozenset()


def add_eval_profile_arg(parser) -> None:
    """Attach the shared `--eval-profile` option to a CLI parser.

    One definition keeps the three CLIs (eval/predict/serve) in lockstep
    with `apply_eval_profile`'s accepted values."""
    parser.add_argument(
        '--eval-profile', choices=('fast', 'full'), default=None,
        help="override the config's eval profile: 'fast' caps the "
             'Monte-Carlo sample count (measured AUC-free, PERF_NOTES.md '
             "'Fast-eval frontier'; names saved_tensors_* caches by the "
             "capped count), 'full' strips a config-set profile to force "
             'the unmodified reference protocol')


def apply_eval_profile(cfg: Config, profile: Optional[str]) -> None:
    """Apply a CLI-level eval-profile override onto a loaded config.

    `'fast'` sets `extras['eval_profile'] = 'fast'` (the measured S-cap
    profile, see `effective_n_generated_samples`); `'full'` removes any
    profile so the unmodified reference protocol runs; `None` leaves the
    config untouched.  Validates eagerly so a bad combination fails at
    the CLI boundary, not mid-eval; on refusal the config is left
    unchanged (so a caller may catch and continue on the old profile)."""
    if profile is None:
        return
    had = 'eval_profile' in cfg.extras
    prior = cfg.extras.get('eval_profile')
    if profile == 'fast':
        cfg.extras['eval_profile'] = 'fast'
    elif profile == 'full':
        cfg.extras.pop('eval_profile', None)
    else:
        raise ValueError(f"eval profile must be 'fast' or 'full', "
                         f"got {profile!r}")
    try:
        effective_n_generated_samples(cfg)
    except Exception:
        if had:
            cfg.extras['eval_profile'] = prior
        else:
            cfg.extras.pop('eval_profile', None)
        raise


def effective_n_generated_samples(cfg: Config) -> int:
    """Monte-Carlo sample count after the `eval_profile: fast` cap
    (measured AUC-free at S~10 under the reference DDPM chain across
    four synthetic operating points — the JAX package's PERF_NOTES.md "Fast-eval
    frontier").  Single source of truth for the model and for artifact
    naming (saved_tensors_{split}_{aggr}_{n} replay directories)."""
    profile = cfg.extras.get('eval_profile')
    if profile not in (None, 'fast'):
        # validate HERE, not only in the model: replay/viz paths resolve
        # cache directories without ever building a model, and a typo'd
        # profile must not silently fall back to the uncapped count (it
        # would look up the wrong saved_tensors_* directory)
        raise ValueError(f"eval_profile must be 'fast' or unset, "
                         f"got {profile!r}")
    n = cfg.n_generated_samples
    if profile == 'fast':
        cap = int(cfg.extras.get('fast_profile_samples', 10))
        if cap < 1:
            raise ValueError(
                f'fast_profile_samples must be >= 1, got {cap}')
        family = cfg.aggregation_strategy.split(':')[0]
        if (cap < n and family in FAST_PROFILE_UNSAFE_AGGREGATIONS
                and not cfg.extras.get(
                    'fast_profile_allow_unsafe_aggregation', False)):
            # the "measured AUC-free" contract of the fast profile does
            # NOT hold for this family — refuse rather than silently
            # trade accuracy for speed under a feature sold as free
            raise ValueError(
                f"eval_profile: fast caps n_generated_samples to {cap}, "
                f"but aggregation_strategy "
                f"'{cfg.aggregation_strategy}' was measured S-cap-"
                f"UNSAFE at that count (AUC moves beyond sampling "
                f"noise; PERF_NOTES.md 'Fast-profile aggregation "
                f"frontier'). Use the full count, a safe aggregation, "
                f"or set extras fast_profile_allow_unsafe_aggregation: "
                f"true to accept the accuracy risk.")
        n = min(n, cap)
    return n


def flagship_config(**overrides) -> Config:
    """The flagship model architecture (UBnormal inject/AE — the paper's
    headline configuration, config/UBnormal/mocodad_train.yaml): one
    shared definition for `chip_smoke.py` and the tests, so they build the
    same network.  Scale knobs (batch size, sample count, transforms) come
    from Config defaults unless overridden."""
    base = dict(
        conditioning_strategy='inject', conditioning_indices=[0, 1, 2],
        conditioning_architecture='AE', channels=[32, 16, 32],
        embedding_dim=16, h_dim=32, latent_dim=16, dropout=0.0,
        seg_len=6, num_coords=2, noise_steps=10,
        aggregation_strategy='best', seed=0)
    base.update(overrides)
    return Config(**base)
