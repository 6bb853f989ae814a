"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Which TPU kernel of the JAX package each one stands for (the Pallas entry
points are listed in PERF.md; every one of them has a counterpart here):

=====================  =====================================================
Port kernel            Replaces
=====================  =====================================================
``block_eval``         ``stgcn_tpu/kernels/block_fused.py``
(``csrc/block_eval.cu``)   ``fused_block_vm`` (``_mega_kernel``), and
                       ``stgcn_tpu/kernels/block_packed.py``
                       ``fused_block_packed_eval`` (``_mega_packed_kernel``):
                       both compute one whole eval block
``spatial_block``      ``stgcn_tpu/kernels/block_fused.py``
(``csrc/spatial_block.cu``, ``spatial_block_vm`` (``_spatial_fwd_kernel``,
forward and backward)  ``_spatial_bwd_kernel``), and
                       ``stgcn_tpu/kernels/block_packed.py``
                       ``spatial_block_packed`` (``_sp_fwd_kernel``,
                       ``_sp_bwd_kernel``): both compute the train path's
                       affine(+ReLU) + K-partition graph conv
``spatial_block_save`` ``stgcn_tpu/kernels/block_fused.py``
(``csrc/spatial_block.cu`` ``spatial_block_vm_save``
with SAVE, forward     (``_spatial_fwd_kernel_save``,
and backward)          ``_spatial_bwd_kernel_saved``): spatial_block's
                       function, the forward also saving the rounded
                       expansion y_k that the backward reads for dA
``temporal_block``     ``stgcn_tpu/kernels/block_fused.py``
(``csrc/temporal_block.cu``, ``temporal_block_vm`` (``_temporal_fwd_kernel``,
forward and backward)  ``_temporal_bwd_kernel``), and
                       ``stgcn_tpu/kernels/block_packed.py``
                       ``temporal_block_packed`` (``_tp_fwd_kernel``,
                       ``_tp_bwd_kernel``): both compute the train path's
                       affine(+ReLU) + gamma x 1 temporal conv
``spatial_conv``       ``stgcn_tpu/kernels/spatial_conv.py``
(``csrc/spatial_block.cu`` ``spatial_conv_fused`` (``_fwd_kernel``,
without the affine,    ``_bwd_kernel``) on ``(N, T, V, C)`` and
forward and backward)  ``spatial_conv_fused_vm`` (``_fwd_kernel_vm``,
                       ``_bwd_kernel_vm``) on V-major ``(V, M, C)``: both
                       compute the standalone K-partition graph conv
``temporal_conv``      ``stgcn_tpu/kernels/temporal_conv.py``
(``csrc/temporal_block.cu`` ``temporal_conv_fused`` (``_fwd_kernel``,
without the affine,    ``_make_dx_kernel``, ``_make_dw_kernel``) on
forward and backward)  ``(N, T, V, C)``, and
                       ``stgcn_tpu/kernels/temporal_conv_vm.py``
                       ``temporal_conv_fused_vm`` (``_shiftsum_kernel``,
                       ``_make_dw_kernel``) on V-major ``(V*N, T, C)``: both
                       compute the standalone gamma x 1 temporal conv
``bn_moments``         no Pallas kernel: XLA's fused reduction of the
(``csrc/bn_moments.cu``, ``jnp.mean`` calls in ``stgcn_tpu/models/fused.py``
forward and backward)  ``_bn_affine_train`` (and in ``stgcn_tpu/ops/
                       batchnorm.py`` ``batchnorm``): the per-channel mean
                       and mean of squares of a train BatchNorm
``adaptive_graph``     no Pallas kernel: the JAX package has no 2s-AGCN.
(``csrc/adaptive_graph. 2s-AGCN's adaptive graph (the theta/phi
cu``, two ops,         embeddings, the Gram over (t, c), the column
forward and backward)  softmax) and its aggregation through one adjacency
                       a sample, returning dA a sample
``affine_relu``        no Pallas kernel: 2s-AGCN's post-activation tail,
(``csrc/affine_relu.   ``relu(a sa + b sb + t)``, one pass each way
cu``)
``unit_tail``          no Pallas kernel: XLA's fusion of the ST-GCN unit's
(``csrc/unit_tail.cu``, tail in ``stgcn_tpu/models/fused.py``
forward and backward)  ``block_forward_fused_train``: the shortcut add,
                       ReLU and dropout on a given draw, one bit an
                       element saved for the backward
=====================  =====================================================

The bfloat16 kernels of every op run on Hopper's tensor cores:

* ``temporal_block`` and ``temporal_conv`` on warpgroup MMA (``wgmma``
  with A from registers, ``csrc/wgmma.cuh``): the taps as implicit GEMMs
  of 128 rows by the whole C_out, the weights through a TMA ring with
  mbarriers, dx split by input-frame parity at stride 2 (it also writes the
  post-activation ``zh`` for dWt), dWt staging each chunk of rows once for
  all nine taps and splitting the rows into partial slices summed in
  order;
* ``block_eval`` on ``wgmma`` too, two kernels a call (three with the
  projection shortcut) and z through a scratch tensor: a persistent
  spatial kernel (y_k for 5 whole frames a tile with W_k by TMA, resident
  where it fits, h staged a tile ahead, the aggregation per frame on
  ``mma.sync``), then the temporal forward's implicit GEMM with the
  block's epilogue (the row staging of ``csrc/tile_rows.cuh``, shared
  with ``temporal_block``);
* ``spatial_block``, ``spatial_block_save`` and ``spatial_conv`` on
  ``wgmma`` too (``csrc/spatial_block.cu``, the weights padded to 16-byte
  rows so TMA reads every one): a persistent forward (y_k for 5 whole
  frames a tile with W_k by TMA, resident where it fits, h a tile ahead,
  the aggregation per frame on ``mma.sync`` with the joints padded to 32,
  as ``block_eval``'s spatial kernel does), and a backward of three
  kernels: a persistent row kernel (t_k = round(A_k^T . g) on
  ``mma.sync`` into a bf16 scratch in x's row order, and dA with y_k
  recomputed by the forward's own ``y_slab``, or read from the saved
  tensor), a dx GEMM over x's rows with depth K * C_out (t and W^T by TMA;
  its epilogue also writes h for the next kernel) and a dW GEMM split over
  the rows (h and t by TMA), their partial slices summed in order.

``adaptive_graph``'s embedding GEMM (forward, dx, dW) runs on the tensor
cores (WMMA ``mma.sync``, two cp.async stages); its Gram, softmax,
their backward and the aggregation run on the CUDA cores with 16-byte
shared-memory reads (bf16 only; float32 and float64 take the plain
versions).  ``affine_relu`` is memory-bound, 16-byte loads, its channel
sums in per-CTA partial slices added in order.

``unit_tail`` is memory-bound, bf16 and float32: a thread 8 elements and
one mask byte a step, 16-byte loads; bitwise PyTorch's chain on CUDA.

``bn_moments`` is memory-bound and runs on the CUDA cores in every dtype:
the forward reads ``x`` once with 16-byte loads into per-thread float32
sums (float64 for float64), per-CTA partial sums added in a fixed order by
a second kernel; the backward is one elementwise pass over ``x``.

Their bounds and what each design does about them are in the notes at the
head of each source.  The float32 kernels stay on the CUDA cores (float32
is the check type; tensor cores would make it TF32).

Every wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel, or raises, for a CUDA tensor; it counts its launches in
a ``launches`` attribute (the train and conv ops have one wrapper, and one
count, for the forward and one for the backward, one per op call whatever
the kernels it launches; the conv ops count both layouts together;
``spatial_block_save`` counts apart from ``spatial_block``).  ``_build``
compiles ``csrc/`` with ``nvcc`` at first use and loads the library with
``ctypes``.
"""
