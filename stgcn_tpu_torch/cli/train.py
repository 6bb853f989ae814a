"""Training entry point of the port (port of ``stgcn_tpu/cli/train.py``).

Parse the config, build the datasets and splits, train, test, checkpoint::

    python -m stgcn_tpu_torch.cli.train --data.synthetic true --train.epochs 5

It takes the JAX CLI's ``--section.key value`` flags and prints what it
prints, in the same order: the config, the split sizes, the ``[perf]``
line, the last epochs, the test pass and its confusion matrix.  It runs on
the GPU, through the port's kernels where ``--model.block_impl`` (or
``layout``, ``spatial_impl``, ``temporal_impl``) puts them, unless
``--train.device cpu`` asks for the CPU; with no GPU and no
``--train.device cpu`` it raises.

With no dataset paths and ``--data.synthetic true``, a synthetic
KTH-format dataset is generated under ``tempfile.gettempdir()/stgcn_synth``
(``stgcn_synth_relational`` for that style): the JAX CLI's directory, which
holds the same bytes, so the two CLIs share it.  With
``--data.use_native_loader`` (default true) the batches come from the C++
loader, built at first use from ``native/npy_loader.cc`` into
``build/stgcn_tpu_torch/`` (:mod:`stgcn_tpu_torch.data.native_loader`),
and the datasets are not preloaded into RAM; where it does not build, the
CLI prints why and uses the numpy batches.  Either way one ``[data]`` line
says which loader ran.

With ``--parallel.{data,time,model}_axis`` above 1 it runs on a mesh of
that many processes, one a GPU, each started by ``torchrun``::

    torchrun --nproc_per_node 2 -m stgcn_tpu_torch.cli.train \
        --data.synthetic true --parallel.data_axis 2

Every process joins the world (``parallel.launcher``), prints the JAX
CLI's ``[dist]`` lines, lays the mesh over the ranks and runs the same
loop on the same batches, each on its slice; rank 0 writes the
checkpoints.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from stgcn_tpu_torch.data import (
    MetadataSplitter,
    SkeletonDataset,
    batches,
    calculate_distances,
    generate_dataset,
    make_augmenter,
    native_batches,
    prefetch,
)
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.models.stgcn import STGCN
from stgcn_tpu_torch.training.config import (
    ExperimentConfig,
    apply_device,
    model_config_from,
    parse_config,
    precision_scope,
)
from stgcn_tpu_torch.training.loop import EarlyStopping, Trainer
from stgcn_tpu_torch.training.optimizers import make_optimizer
from stgcn_tpu_torch.utils.logging import (
    CsvLogger,
    MultiLogger,
    TensorBoardLogger,
)
from stgcn_tpu_torch.utils.profiling import ModelFlops, trace


def build_datasets(cfg: ExperimentConfig):
    d = cfg.data
    meta_file, data_dir = d.metadata_file, d.dataset_dir
    if not meta_file:
        if not d.synthetic:
            raise SystemExit(
                "no --data.metadata_file given; pass --data.synthetic true "
                "to generate synthetic data")
        suffix = ("" if d.synthetic_style == "marginal"
                  else f"_{d.synthetic_style}")
        data_dir = os.path.join(tempfile.gettempdir(), f"stgcn_synth{suffix}")
        meta_file = os.path.join(data_dir, "metadata.csv")
        if not os.path.exists(meta_file):
            print(f"[data] generating synthetic KTH-format dataset in "
                  f"{data_dir}")
            generate_dataset(data_dir, seed=d.seed, style=d.synthetic_style)

    splitter = MetadataSplitter(meta_file)
    if d.data_split == 0:
        subjects = sorted(set(splitter.metadata["subject"]))
        n = len(subjects)
        tr_n = max(1, int(round(n * 0.6)))
        va_n = max(1, int(round(n * 0.2)))
        te_n = n - tr_n - va_n
        if n == 25:  # reference split (src/data/datasets.py:22)
            tr_n, va_n, te_n = 15, 5, 5
        train_idx, val_idx, test_idx = splitter.split_by_subject(
            train=tr_n, val=va_n, test=te_n)
    elif d.data_split == 1:
        train_idx, val_idx, test_idx = splitter.split_by_scenario(
            list(d.train_scenarios), list(d.val_scenarios))
    else:
        train_idx, val_idx, test_idx = splitter.split_stratified(seed=d.seed)

    transforms = (make_augmenter(compat=d.augment_compat)
                  if d.augment_data else None)
    # the C++ loader reads the files per batch, so preload only without it
    preload = not d.use_native_loader
    train_ds = SkeletonDataset(splitter.metadata, data_dir, train_idx,
                               transforms=transforms, seed=d.seed,
                               preload=preload)
    val_ds = SkeletonDataset(splitter.metadata, data_dir, val_idx,
                             preload=preload)
    test_ds = SkeletonDataset(splitter.metadata, data_dir, test_idx,
                              preload=preload)
    return train_ds, val_ds, test_ds


def resolve_distances(cfg: ExperimentConfig,
                      train_ds=None) -> np.ndarray | None:
    """Spatial-configuration partitioning needs gravity-center distances;
    compute them from the training set when no file is given
    (the reference requires a precomputed file, adjacency.py:99-100).
    Without ``train_ds`` the training split is built from the data flags
    when the distances are needed."""
    if Strategy(cfg.model.partitioning) != Strategy.SPATIAL_CONFIGURATION:
        return None
    if cfg.data.distance_file:
        return np.load(cfg.data.distance_file)
    if train_ds is None:
        train_ds = build_datasets(cfg)[0]
    print("[data] computing gravity-center distances from the training set")
    return calculate_distances(train_ds)


def choose_batches(use_native_loader: bool):
    """``native_batches`` if asked for and the C++ loader builds and
    loads, else the numpy ``batches``; prints which, and why."""
    if not use_native_loader:
        print("[data] numpy batches (--data.use_native_loader false)")
        return batches
    from stgcn_tpu_torch.data import native_loader

    try:
        native_loader.load_library()
    except (OSError, RuntimeError) as e:
        print(f"[data] numpy batches: the native C++ batch loader did not "
              f"build or load: {e}")
        return batches
    print("[data] using native C++ batch loader")
    return native_batches


def main(argv: list[str] | None = None) -> int:
    cfg = parse_config(argv)
    device = apply_device(cfg)
    print(cfg.to_json())
    with precision_scope(cfg):
        return _train(cfg, device)


def _train(cfg: ExperimentConfig, device: torch.device) -> int:
    train_ds, val_ds, test_ds = build_datasets(cfg)
    print(f"[data] splits: train={len(train_ds)} val={len(val_ds)} "
          f"test={len(test_ds)}")

    distances = resolve_distances(cfg, train_ds)
    model = STGCN(model_config_from(cfg), distances=distances)

    d = cfg.data
    collate_kwargs = dict(mode=d.collate_mode, fixed_len=d.fixed_len)
    batch_fn = choose_batches(d.use_native_loader)

    def train_stream(epoch: int):
        # background-thread prefetch: batch i+1 is collated (npy reads,
        # wrap-pad, augmentation) while the device runs step i
        return prefetch(batch_fn(
            train_ds, d.batch_size, shuffle=True,
            seed=d.seed + epoch, drop_remainder=False,
            sort_by_length=d.sort_by_length, **collate_kwargs))

    def val_stream():
        return prefetch(batch_fn(val_ds, d.batch_size, **collate_kwargs))

    t = cfg.train
    loggers = []
    if t.log_dir:
        loggers = [CsvLogger(t.log_dir), TensorBoardLogger(t.log_dir)]
    logger = MultiLogger(*loggers) if loggers else None

    mesh = None
    p = cfg.parallel
    if p.data_axis * p.time_axis * p.model_axis > 1:
        from stgcn_tpu_torch.parallel.launcher import initialize_distributed
        from stgcn_tpu_torch.parallel.mesh import (
            make_mesh,
            validate_joint_sharding,
        )

        info = initialize_distributed()
        print(f"[dist] {info}")
        mesh = make_mesh(p.data_axis, p.time_axis, p.model_axis,
                         device=device)
        if p.shard_joints:
            validate_joint_sharding(model.num_joints, p.model_axis)
        print(f"[dist] mesh data={p.data_axis} time={p.time_axis} "
              f"model={p.model_axis} shard_joints={p.shard_joints}")

    trainer = Trainer(
        model, optimizer=make_optimizer(t),
        lr=t.lr, logger=logger, mesh=mesh, shard_joints=p.shard_joints,
        checkpoint_dir=t.checkpoint_dir,
        checkpoint_every_epochs=t.checkpoint_every_epochs,
        log_every_steps=t.log_every_steps, seed=t.seed,
        debug_nans=t.debug_nans,
        check_invariants=t.check_invariants,
        device=device,
    )
    state = trainer.init_state()
    start_epoch = 0
    if t.resume and t.checkpoint_dir:
        state, start_epoch = trainer.maybe_resume(state)
        if start_epoch:
            print(f"[ckpt] resumed from epoch {start_epoch}")

    early = EarlyStopping(patience=t.early_stop_patience,
                          min_delta=t.early_stop_min_delta) \
        if t.use_early_stopping else None

    if t.profile_dir:
        # trace a handful of warm steps, then train
        x0, y0, _ = next(iter(train_stream(0)))
        batch = trainer._put_batch(x0, y0)
        trainer.train_step(state, *batch)
        with trace(t.profile_dir):
            for _ in range(3):
                trainer.train_step(state, *batch)
        print(f"[profile] wrote a torch.profiler trace to {t.profile_dir}")

    result = trainer.fit(
        state, train_stream, val_stream,
        epochs=t.epochs, min_epochs=t.min_epochs, start_epoch=start_epoch,
        early_stopping=early, eval_every_epochs=t.eval_every_epochs)

    if result.history:
        last = result.history[-1]
        acct = ModelFlops.of(model, d.batch_size, d.fixed_len)
        if last.get("epoch_time_s") and len(train_ds):
            steps = max(1, (len(train_ds) + d.batch_size - 1) // d.batch_size)
            step_time = last["epoch_time_s"] / steps
            print(f"[perf] ~{step_time*1e3:.1f} ms/step, "
                  f"{acct.edges_per_s(step_time):.3e} edges/s, "
                  f"{acct.tflops_per_s(step_time):.2f} TFLOP/s")

    for h in result.history[-3:]:
        print("[epoch]", h)

    test_metrics = trainer.evaluate(
        result.final_state, batches(test_ds, d.batch_size, **collate_kwargs))
    result.test_metrics = test_metrics
    print(f"[test] loss={test_metrics['loss']:.4f} "
          f"acc={test_metrics['acc']:.4f} n={test_metrics['count']}")
    print("[test] confusion matrix:\n", test_metrics["confusion_matrix"])
    if logger:
        logger.log("test_acc", result.epochs_run, test_metrics["acc"])
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
