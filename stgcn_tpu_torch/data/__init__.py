"""Data pipeline of the port (``stgcn_tpu/data`` without pandas): the
metadata table, splits and dataset, collation (numpy, or the C++ loader's
``native_batches``), augmentation, gravity-center distances, the synthetic
dataset, background prefetch and OpenPose ingestion
(:mod:`~stgcn_tpu_torch.data.openpose`)."""

from stgcn_tpu_torch.data.augmentation import (
    augment_sequence,
    make_augmenter,
    sample_transform,
)
from stgcn_tpu_torch.data.collate import (
    batches,
    bucket_length,
    collate,
    default_buckets,
    native_batches,
    wrap_pad,
)
from stgcn_tpu_torch.data.datasets import (
    MetadataSplitter,
    SkeletonDataset,
    read_metadata,
)
from stgcn_tpu_torch.data.distances import (
    calculate_distances,
    calculate_distances_from_dir,
)
from stgcn_tpu_torch.data.prefetch import prefetch
from stgcn_tpu_torch.data.synthetic import (
    generate_dataset,
    random_batch,
    synth_sequence,
)
