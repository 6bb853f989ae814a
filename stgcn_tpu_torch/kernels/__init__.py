"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Which TPU kernel of the JAX package each one stands for (the Pallas entry
points are listed in PERF.md; the ones not named here are still to be
ported, ROADMAP.md queue 2):

=====================  =====================================================
Port kernel            Replaces
=====================  =====================================================
``block_eval``         ``stgcn_tpu/kernels/block_fused.py``
(``csrc/block_eval.cu``)   ``fused_block_vm`` (``_mega_kernel``), and
                       ``stgcn_tpu/kernels/block_packed.py``
                       ``fused_block_packed_eval`` (``_mega_packed_kernel``):
                       both compute one whole eval block
=====================  =====================================================

Every wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel, or raises, for a CUDA tensor; it counts its launches in
a ``launches`` attribute.  ``_build`` compiles ``csrc/`` with ``nvcc`` at
first use and loads the library with ``ctypes``.
"""
