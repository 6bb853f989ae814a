"""Inference engine: batched predictions over variable-length sequences.

Port of ``stgcn_tpu/serving.py``'s ``Predictor``.  Sequences are grouped by
bucketed length, wrap-padded (the reference's padding), batched up to
``max_batch`` and run through the fused eval forward, one hand-written
kernel per block (:mod:`stgcn_tpu_torch.models.fused`).  With a bf16
compute dtype the inputs are cast to bf16 on the host, which halves the
bytes copied to the device.

Example::

    model = STGCN(STGCNConfig(...))
    model.load_state_dict(state_dict)
    predictor = Predictor(model)             # runs on the GPU
    out = predictor.predict(list_of_sequences)

``Predictor.from_checkpoint`` serves the weights and BN statistics of a
``.npz`` checkpoint, written by the port's or the JAX package's
``save_checkpoint``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.data.collate import (
    bucket_length,
    default_buckets,
    wrap_pad,
)
from stgcn_tpu_torch.graph.skeleton import label_number_to_name
from stgcn_tpu_torch.models.convert import state_dict_from_params
from stgcn_tpu_torch.models.fused import fused_eval_forward
from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig

BATCH_PADS = ("max", "pow2", "none")


@dataclasses.dataclass
class Prediction:
    probs: np.ndarray       # (N, classes)
    labels: np.ndarray      # (N,) argmax ids
    label_names: list[str]  # human-readable


class Predictor:
    """Batched inference of an :class:`STGCN` on one device.

    ``batch_pad`` pins how a partial chunk's batch is padded:

    * ``"max"`` (default): to ``max_batch``, so one batch shape exists per
      bucket length;
    * ``"pow2"``: to the next power of two, capped at ``max_batch``;
    * ``"none"``: not at all.

    ``use_fused`` (default) serves through the fused kernel forward; False
    serves through the op path (``STGCN.forward``).  ``device`` is
    ``"cuda"`` unless ``"cpu"`` is asked for.

    ``mesh`` (a ``(data, 1, 1)`` :class:`stgcn_tpu_torch.parallel.mesh.
    Mesh`, on its device) serves data parallel, as the JAX
    ``Predictor(mesh=...)`` does: each rank of every rank's identical call
    runs the fused forward on its slice of each batch and every rank
    returns the whole answer (``parallel/fused_dp.fused_eval_forward_dp``).
    ``max_batch`` must divide by the data axis and ``batch_pad`` must be
    ``"max"``, so every batch does.
    """

    def __init__(self, model: STGCN, buckets: tuple[int, ...] | None = None,
                 max_batch: int = 64, batch_pad: str = "max",
                 use_fused: bool = True,
                 device: str | torch.device | None = None, mesh=None):
        if batch_pad not in BATCH_PADS:
            raise ValueError(f"batch_pad must be max|pow2|none, "
                             f"got {batch_pad!r}")
        if mesh is not None:
            from stgcn_tpu_torch.parallel.fused_dp import check_dp_only

            check_dp_only(mesh, "Predictor(mesh=...)")
            dp = mesh.shape["data"]
            if max_batch % dp:
                raise ValueError(
                    f"max_batch {max_batch} must be divisible by the mesh's "
                    f"data axis {dp}")
            if batch_pad != "max":
                raise ValueError(
                    "Predictor(mesh=...) requires batch_pad='max' so every "
                    "compiled batch divides the data axis")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(buckets or default_buckets(1024))
        self.max_batch = max_batch
        self.batch_pad = batch_pad
        self.use_fused = use_fused
        cd = model.config.compute_dtype
        self._transfer_dtype = (torch.bfloat16 if cd == torch.bfloat16
                                else torch.float32)

    @classmethod
    def from_state_dict(cls, state_dict: dict, config: STGCNConfig,
                        distances: np.ndarray | None = None,
                        **kw) -> "Predictor":
        """A predictor from a reference-format state dict (tensors or numpy
        arrays).  BatchNorm's ``num_batches_tracked`` counters are not
        needed in eval and are dropped."""
        model = STGCN(config, distances=distances)
        sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
              for k, v in state_dict.items()
              if not k.endswith("num_batches_tracked")}
        model.load_state_dict(sd)
        return cls(model, **kw)

    @classmethod
    def from_checkpoint(cls, checkpoint_base: str, config: STGCNConfig,
                        distances: np.ndarray | None = None,
                        **kw) -> "Predictor":
        """A predictor from ``checkpoint_base.npz`` (port of the JAX
        ``Predictor.from_checkpoint``): the parameters and BN statistics
        only, so a checkpoint of any optimizer serves."""
        from stgcn_tpu_torch.training.checkpoint import restore_checkpoint

        model = STGCN(config, distances=distances)
        params, state = model.init_params(0)
        tree = restore_checkpoint(checkpoint_base,
                                  {"params": params, "model_state": state})
        model.load_state_dict(state_dict_from_params(
            tree["params"], tree["model_state"], residual=config.residual,
            adjacency=model.adjacency))
        return cls(model, **kw)

    def _padded_batch(self, n: int) -> int:
        if n >= self.max_batch or self.batch_pad == "none":
            return n
        if self.batch_pad == "max":
            return self.max_batch
        p = 1
        while p < n:
            p *= 2
        return min(p, self.max_batch)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self.use_fused and self.mesh is not None:
                from stgcn_tpu_torch.parallel.fused_dp import (
                    fused_eval_forward_dp,
                )

                dp = self.mesh.shape["data"]
                if x.shape[0] % dp:
                    raise ValueError(
                        f"batch {x.shape[0]} not divisible by data axis "
                        f"{dp}")
                local = x.chunk(dp)[self.mesh.index("data")]
                logits = fused_eval_forward_dp(
                    self.model, *self.model.params_and_state(), local,
                    self.mesh)
            elif self.use_fused:
                logits = fused_eval_forward(
                    self.model, *self.model.params_and_state(), x)
            else:
                logits = self.model(x)
            return torch.softmax(logits, dim=-1)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        host = host.to(self._transfer_dtype)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        """``(N, T, V, C)`` -> ``(N, classes)`` float32 probabilities."""
        return self._forward(self._to_device(x)).float().cpu().numpy()

    def predict_stream(self, batches: Iterable[np.ndarray],
                       depth: int = 2) -> Iterator[np.ndarray]:
        """Pipelined inference over an iterable of ``(N, T, V, C)`` batches.

        Keeps up to ``depth`` batches in flight: each batch is copied from
        pinned host memory and computed asynchronously on the current
        stream, and its result is copied back into pinned memory without
        blocking, so batch ``i+1``'s copy and compute overlap batch ``i``'s
        readback.  Yields float32 probability arrays in input order, the
        same values ``predict_batch`` gives.
        """
        inflight: deque = deque()
        for x in batches:
            if len(inflight) >= depth:
                yield _finish(inflight.popleft())
            probs = self._forward(self._to_device(x)).float()
            if self.device.type == "cuda":
                host = torch.empty(probs.shape, dtype=probs.dtype,
                                   pin_memory=True)
                host.copy_(probs, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                inflight.append((host, done))
            else:
                inflight.append((probs, None))
        while inflight:
            yield _finish(inflight.popleft())

    def predict(self, sequences: list[np.ndarray]) -> Prediction:
        """Variable-length ``(T, V, C)`` sequences -> class probabilities.

        Sequences are grouped by bucketed length, wrap-padded and run at
        most ``max_batch`` at a time.
        """
        n = len(sequences)
        num_classes = self.model.config.num_classes
        probs = np.zeros((n, num_classes), np.float32)
        by_bucket: dict[int, list[int]] = {}
        for i, seq in enumerate(sequences):
            b = bucket_length(seq.shape[0], self.buckets)
            by_bucket.setdefault(b, []).append(i)

        chunks: deque[list[int]] = deque()

        def batches():
            # a generator, so collating chunk i+1 overlaps chunk i's work
            for b, idxs in by_bucket.items():
                for s in range(0, len(idxs), self.max_batch):
                    chunk = idxs[s:s + self.max_batch]
                    chunks.append(chunk)
                    x = np.stack([
                        wrap_pad(np.asarray(sequences[i], np.float32), b)
                        for i in chunk])
                    pad_n = self._padded_batch(len(chunk)) - len(chunk)
                    if pad_n:
                        x = np.concatenate(
                            [x, np.zeros((pad_n, *x.shape[1:]), np.float32)])
                    yield x

        for out in self.predict_stream(batches()):
            chunk = chunks.popleft()
            probs[chunk] = out[:len(chunk)]

        labels = probs.argmax(axis=1)
        names = [label_number_to_name(int(lab))
                 if num_classes == 6 else str(int(lab)) for lab in labels]
        return Prediction(probs=probs, labels=labels, label_names=names)

    def warmup(self, batch: int | None = None) -> None:
        """Run every bucket once at ``batch`` (default ``max_batch``), which
        also builds the kernel library on its first use."""
        b = batch or self.max_batch
        c = self.model.config.c_in
        v = self.model.num_joints
        for t in self.buckets:
            self.predict_batch(np.zeros((b, t, v, c), np.float32))


def _finish(item) -> np.ndarray:
    out, done = item
    if done is not None:
        done.synchronize()
    return out.numpy()
