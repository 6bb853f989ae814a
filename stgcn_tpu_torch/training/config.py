"""Typed experiment configuration with CLI overrides (port of
``stgcn_tpu/training/config.py``).

The same four sections, fields and defaults as the JAX package, the same
flat ``--section.key value`` parser (booleans parse properly, tuples are
comma-separated, ``--config`` starts from a JSON file, ``@file`` reads
arguments from a file), so one command line means the same run in either
package and ``to_dict`` gives equal dictionaries.

What differs is what the settings reach:

* :func:`model_config_from` builds the port's ``STGCNConfig`` with torch
  dtypes (the mesh axes are read by the training CLI, which lays a
  :mod:`stgcn_tpu_torch.parallel` mesh over its ranks);
* :func:`apply_device` maps ``--train.device`` onto a ``torch.device``:
  ``auto`` and ``cuda`` are the GPU and raise without one (there is no
  quiet CPU fallback, unlike the JAX package's ``auto``), ``cpu`` the CPU,
  ``tpu`` is refused;
* :func:`precision_scope` applies ``--parallel.precision`` for the run:
  ``bfloat16`` is ``compute_dtype`` (set by :func:`model_config_from`),
  ``highest`` turns TF32 off for matmuls and cuDNN, ``default`` leaves
  torch's settings.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Any

import torch

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.graph.adjacency import Strategy

PRECISIONS = ("default", "highest", "bfloat16")


@dataclasses.dataclass
class ModelSection:
    c_in: int = 2
    num_classes: int = 6
    gamma: int = 9
    partitioning: int = int(Strategy.UNI_LABELING)
    d: int = 1
    norm_mode: str = "symmetric"      # or "reference" (dense-Lambda compat)
    adjacency_mode: str = "mask"      # "reference" | "mask" | "fixed"
    use_edge_importance: bool = False  # False -> adjacency_mode "fixed"
    max_mask_jitter: float = 0.001
    dropout_rate: float = 0.0
    residual: bool = False
    num_layers: int = 10              # 10 (code) or 9 (report variant)
    final_softmax: bool = False
    temporal_impl: str = "auto"       # auto | conv | conv_vt | shift_sum
                                      # | block | pallas (the port's
                                      # temporal-conv kernel)
    spatial_impl: str = "einsum"      # einsum | pallas (graph-conv kernel)
    block_impl: str = "ops"           # ops | fused | hybrid
    fused_blocks: str = ""            # hybrid only: comma-separated block
                                      # indices to run fused; empty =
                                      # STGCNConfig's fused_from default
    layout: str = "ntvc"              # ntvc | vntc (V-major conv kernels)


@dataclasses.dataclass
class DataSection:
    metadata_file: str = ""
    dataset_dir: str = ""
    distance_file: str = ""
    data_split: int = 0               # 0 subject, 1 scenario, 2 stratified
    train_scenarios: tuple[str, ...] = ("d1", "d2")
    val_scenarios: tuple[str, ...] = ("d3",)
    augment_data: bool = False
    augment_compat: bool = True       # reproduce the reference's quirks
    collate_mode: str = "bucket"      # "max" (parity) | "bucket" | "fixed"
    fixed_len: int = 256
    batch_size: int = 16
    sort_by_length: bool = True
    use_native_loader: bool = True    # C++ batch loader (data/native_loader)
    synthetic: bool = False           # generate synthetic data if paths empty
    synthetic_style: str = "marginal"  # or "relational"
    seed: int = 0


@dataclasses.dataclass
class TrainSection:
    lr: float = 1e-4
    optimizer: str = "adam"           # adam | flat_adam | adamw | sgd |
                                      # momentum
    weight_decay: float = 0.0         # adamw only
    momentum: float = 0.9             # momentum only
    grad_clip_norm: float = 0.0       # 0 = off
    lr_schedule: str = "constant"     # constant | cosine | step
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 10000       # cosine horizon / step interval
    lr_step_factor: float = 0.1       # step schedule decay factor
    epochs: int = 50
    min_epochs: int = 0
    use_early_stopping: bool = False
    early_stop_patience: int = 100
    early_stop_min_delta: float = 0.0
    checkpoint_dir: str = ""
    checkpoint_every_epochs: int = 10
    resume: bool = False
    log_dir: str = ""
    log_every_steps: int = 10
    eval_every_epochs: int = 1
    seed: int = 0
    device: str = "auto"              # auto | cuda | cpu (apply_device)
    debug_nans: bool = False          # autograd anomaly detection
    check_invariants: bool = False    # label-range / finite-loss /
                                      # finite-gradient checks each step
    profile_dir: str = ""             # write a torch.profiler trace here
                                      # (FLAG_HELP)


@dataclasses.dataclass
class ParallelSection:
    data_axis: int = 1                # mesh axes (stgcn_tpu_torch.parallel)
    time_axis: int = 1
    model_axis: int = 1
    shard_joints: bool = False
    precision: str = "default"        # "default" | "highest" | "bfloat16"
    remat: bool = False               # recompute each block in the
                                      # backward (op chain only)


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelSection = dataclasses.field(default_factory=ModelSection)
    data: DataSection = dataclasses.field(default_factory=DataSection)
    train: TrainSection = dataclasses.field(default_factory=TrainSection)
    parallel: ParallelSection = dataclasses.field(
        default_factory=ParallelSection)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        def build(section_cls, sub):
            fields = {f.name: f for f in dataclasses.fields(section_cls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(
                        f"unknown config key {section_cls.__name__}.{k}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return section_cls(**kwargs)

        return cls(
            model=build(ModelSection, d.get("model", {})),
            data=build(DataSection, d.get("data", {})),
            train=build(TrainSection, d.get("train", {})),
            parallel=build(ParallelSection, d.get("parallel", {})),
        )


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v!r}")


# what a flag's name does not say
FLAG_HELP = {
    "train.profile_dir": (
        "write a torch.profiler trace of three warm train steps to "
        "DIR/trace.json; it carries the step's phase marks (kernels named "
        "stgcn_phase_mark<stgcn_phase::KIND>, a phase running from its "
        "mark to the next) and the program's host spans (graph.capture); "
        "open it in Perfetto (ui.perfetto.dev)"),
}


def build_argument_parser() -> argparse.ArgumentParser:
    """Flat ``--section.key value`` CLI over the dataclass tree."""
    parser = argparse.ArgumentParser(
        description="stgcn_tpu_torch training",
        fromfile_prefix_chars="@",
    )
    parser.add_argument("--config", type=str, default="",
                        help="JSON config file to start from")
    cfg = ExperimentConfig()
    for section_name in ("model", "data", "train", "parallel"):
        section = getattr(cfg, section_name)
        for f in dataclasses.fields(section):
            default = getattr(section, f.name)
            arg = f"--{section_name}.{f.name}"
            if isinstance(default, bool):
                parser.add_argument(arg, type=_str2bool, default=None,
                                    metavar="BOOL")
            elif isinstance(default, tuple):
                parser.add_argument(arg, type=str, default=None,
                                    help="comma-separated list")
            else:
                parser.add_argument(
                    arg, type=type(default), default=None,
                    help=FLAG_HELP.get(f"{section_name}.{f.name}"))
    return parser


def parse_config(argv: list[str] | None = None) -> ExperimentConfig:
    args = build_argument_parser().parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_dict(json.load(f))
    else:
        cfg = ExperimentConfig()
    for key, value in vars(args).items():
        if key == "config" or value is None:
            continue
        section_name, field_name = key.split(".", 1)
        section = getattr(cfg, section_name)
        if isinstance(getattr(section, field_name), tuple):
            value = tuple(x for x in value.split(",") if x)
        setattr(section, field_name, value)
    return cfg


def apply_device(cfg: ExperimentConfig) -> torch.device:
    """The device ``--train.device`` names (module docstring)."""
    device = cfg.train.device
    if device in ("auto", "cuda"):
        return resolve_device("cuda")
    if device == "cpu":
        return torch.device("cpu")
    if device == "tpu":
        raise SystemExit("--train.device tpu: the PyTorch port runs on "
                         "'cuda' or 'cpu'")
    raise SystemExit(f"unknown --train.device {device!r}")


@contextlib.contextmanager
def precision_scope(cfg: ExperimentConfig):
    """``--parallel.precision`` for the duration of the block: ``highest``
    turns TF32 off for matmuls and cuDNN and restores the settings after;
    ``default`` and ``bfloat16`` change nothing here."""
    precision = cfg.parallel.precision
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision != "highest":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def model_config_from(cfg: ExperimentConfig) -> "Any":
    """Map the experiment config onto the port's :class:`STGCNConfig`."""
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, PLAN_9, STGCNConfig

    m = cfg.model
    if m.num_layers == 10:
        plan = DEFAULT_PLAN
    elif m.num_layers == 9:
        plan = PLAN_9
    else:
        raise ValueError("num_layers must be 9 or 10")
    adjacency_mode = m.adjacency_mode
    if not m.use_edge_importance and adjacency_mode == "mask":
        adjacency_mode = "fixed"
    if cfg.parallel.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {cfg.parallel.precision!r}")
    compute_dtype = (torch.bfloat16 if cfg.parallel.precision == "bfloat16"
                     else None)
    return STGCNConfig(
        c_in=m.c_in,
        num_classes=m.num_classes,
        gamma=m.gamma,
        strategy=Strategy(m.partitioning),
        d=m.d,
        norm_mode=m.norm_mode,
        adjacency_mode=adjacency_mode,
        mask_jitter=m.max_mask_jitter if m.use_edge_importance else 0.0,
        dropout_rate=m.dropout_rate,
        residual=m.residual,
        final_softmax=m.final_softmax,
        plan=plan,
        compute_dtype=compute_dtype,
        temporal_impl=m.temporal_impl,
        spatial_impl=m.spatial_impl,
        block_impl=m.block_impl,
        fused_blocks=(tuple(int(v) for v in m.fused_blocks.split(","))
                      if m.fused_blocks else None),
        layout=m.layout,
        remat=cfg.parallel.remat,
    )
