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

The forward is a :class:`~stgcn_tpu_torch.training.graphs.CapturedStep`:
on a CUDA device one CUDA graph per ``(padded batch, T)`` bucket, as the
JAX ``Predictor`` compiles one program per bucket, which ``warmup()``
captures ahead of the first request; eager on the CPU or with
``capture=False``.

While a profiler records, a request's host work shows in spans
(:func:`stgcn_tpu_torch.utils.profiling.span`): ``serve.bucket``,
``serve.collate`` (two a chunk), ``serve.forward``, ``serve.sync`` and
``serve.gather``.
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
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.utils.profiling import span

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

    ``capture``: the forward's graphs (module docstring; None captures on
    CUDA, False runs eagerly).
    """

    def __init__(self, model: STGCN, buckets: tuple[int, ...] | None = None,
                 max_batch: int = 64, batch_pad: str = "max",
                 use_fused: bool = True,
                 device: str | torch.device | None = None, mesh=None,
                 capture: bool | None = None):
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
        eager = None
        if mesh is not None and use_fused:
            from stgcn_tpu_torch.parallel.fused_dp import mesh_eager_reason

            eager = mesh_eager_reason(mesh)
        self._step = CapturedStep(
            _forward_body(use_fused, mesh),
            state_tensors=lambda m: [*m.parameters(), *m.buffers()],
            capture=capture, eager_reason=eager, name="serving forward")

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
        """Softmax probabilities of a batch on the device: a static
        tensor, overwritten by the next batch of the same bucket."""
        with torch.inference_mode():
            return self._step(self.model, x)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        host = host.to(self._transfer_dtype)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        """``(N, T, V, C)`` -> ``(N, classes)`` float32 probabilities."""
        probs = self._forward(self._to_device(x))
        # a copy: the forward's output is overwritten by its next call
        return probs.to("cpu", torch.float32, copy=True).numpy()

    def predict_stream(self, batches: Iterable[np.ndarray],
                       depth: int = 2) -> Iterator[np.ndarray]:
        """Pipelined inference over an iterable of ``(N, T, V, C)`` batches.

        Keeps up to ``depth`` batches in flight: each batch is copied from
        pinned host memory and computed asynchronously on the current
        stream, and its result is copied back into pinned memory without
        blocking, so batch ``i+1``'s copy and compute overlap batch ``i``'s
        readback.  The copy back is issued on the same stream right after
        the forward, so the next batch of the same bucket, which
        overwrites the forward's static output, runs after it.  Yields
        float32 probability arrays in input order, the same values
        ``predict_batch`` gives.
        """
        inflight: deque = deque()
        batches = iter(batches)
        while True:
            # the chunk's assembly (predict's generator), then its cast,
            # pinning and copy: two collate spans a chunk
            with span("serve.collate"):
                x = next(batches, None)
            if x is None:
                break
            if len(inflight) >= depth:
                yield _finish(inflight.popleft())
            with span("serve.collate"):
                x = self._to_device(x)
            with span("serve.forward"):
                inflight.append(self._issue(x))
        while inflight:
            yield _finish(inflight.popleft())

    def _issue(self, x: torch.Tensor) -> tuple:
        """The forward of a batch on the device and its result's copy
        back, issued without waiting: ``(result, event or None)``."""
        probs = self._forward(x).float()
        if self.device.type != "cuda":
            return probs.clone(), None
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def predict(self, sequences: list[np.ndarray]) -> Prediction:
        """Variable-length ``(T, V, C)`` sequences -> class probabilities.

        Sequences are grouped by bucketed length, wrap-padded and run at
        most ``max_batch`` at a time.
        """
        n = len(sequences)
        num_classes = self.model.config.num_classes
        probs = np.zeros((n, num_classes), np.float32)
        by_bucket: dict[int, list[int]] = {}
        with span("serve.bucket"):
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
            with span("serve.gather"):
                chunk = chunks.popleft()
                probs[chunk] = out[:len(chunk)]

        with span("serve.gather"):
            labels = probs.argmax(axis=1)
            names = [label_number_to_name(int(lab))
                     if num_classes == 6 else str(int(lab))
                     for lab in labels]
        return Prediction(probs=probs, labels=labels, label_names=names)

    def warmup(self, batch: int | None = None) -> None:
        """Run every bucket at ``batch`` (default ``max_batch``) until its
        graph is captured (twice on a CUDA device: the warm-up, which also
        builds the kernel library on its first use, then the capture;
        once where the forward runs eagerly)."""
        b = batch or self.max_batch
        c = self.model.config.c_in
        v = self.model.num_joints
        for t in self.buckets:
            x = np.zeros((b, t, v, c), np.float32)
            self.predict_batch(x)
            if self._step.captured:
                self.predict_batch(x)


def _forward_body(use_fused: bool, mesh):
    """The serving forward's device work: fused (per rank on a mesh) or
    the op path, then the softmax.  A function of its own, not a method,
    so that the captured step holds no reference back to its
    ``Predictor``."""
    def body(model: STGCN, x: torch.Tensor, *, generator=None
             ) -> torch.Tensor:
        if use_fused and mesh is not None:
            from stgcn_tpu_torch.parallel.fused_dp import (
                fused_eval_forward_dp,
            )

            dp = mesh.shape["data"]
            if x.shape[0] % dp:
                raise ValueError(
                    f"batch {x.shape[0]} not divisible by data axis {dp}")
            local = x.chunk(dp)[mesh.index("data")]
            logits = fused_eval_forward_dp(
                model, *model.params_and_state(), local, mesh)
        elif use_fused:
            logits = fused_eval_forward(model, *model.params_and_state(), x)
        else:
            logits = model(x)
        return torch.softmax(logits, dim=-1)
    return body


def _finish(item) -> np.ndarray:
    out, done = item
    with span("serve.sync"):
        if done is not None:
            done.synchronize()
        return out.numpy()
