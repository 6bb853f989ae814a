"""2s-AGCN's adaptive graph and per-sample aggregation: kernels, plain
versions, autograd.

Two differentiable ops on V-major ``(V, NM, T, C)`` activations (``NM``:
the bodies of every clip, each its own sample):

* :func:`adaptive_graph` ``(x, w, b) -> C``, the data-dependent graph of
  one 2s-AGCN unit (Shi et al., CVPR 2019, ``model/agcn.py``)::

      E      = round(x . W + b)          W: (C_in, 2 K Ce), theta_k then phi_k
      S_k[n] = sum_{t,c} theta_k[i,n,t,c] phi_k[j,n,t,c] / (Ce T)
      C_k[n] = softmax over i (dim -2) of S_k[n]       (NM, K, V, V) float32

* :func:`sample_aggregate` ``(x, a) -> z``, the aggregation through one
  adjacency a sample, ``a`` ``(NM, K, V, V)`` (``A_k + B_k + C_k[n]``)::

      z[w, n, t, k C_in + c] = round(sum_v a[n, k, v, w] x[v, n, t, c])

  and its backward returns ``da`` a sample, which feeds the softmax's
  backward (the spatial op of the ST-GCN units, ``spatial_block``, takes
  one ``(K, V, V)`` for the batch and sums ``dA`` over it).

The embeddings are float32 sums rounded to the activations' dtype; the
Gram, the softmax and the adjacency stay float32.  On CUDA each op runs
the hand-written kernels of ``csrc/adaptive_graph.cu`` (the embedding, its
dx and its dW on the tensor cores; the Gram and softmax, their backward and
the aggregation on the CUDA cores), which take bfloat16 activations and
refuse any other dtype; on the CPU it runs the plain versions
``*_reference``, which round at the same points (call them by name for
float32 or float64 on the card).

``adaptive_graph_forward.launches``, ``adaptive_graph_backward.launches``,
``sample_aggregate_forward.launches`` and
``sample_aggregate_backward.launches`` count the op calls that launched
kernels, one per call, and nothing else.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_block import _acc, _raise_on

GEMM_TILE = 64
GEMM_BK = 32
SPLIT_CTAS = 8          # a dW split's CTAs a streaming multiprocessor
BWD_SPLITS = 4          # CTAs a (sample, subset) of the Gram's backward
GRAM_SPLIT_CTAS = 8     # the Gram's CTAs a streaming multiprocessor
GRAM_CHUNK = 128        # depth a Gram CTA stages at a time (csrc DC)
GRAM_PAD = 28           # joints padded to a multiple of 4 (csrc VP)
MAX_JOINTS = GRAM_PAD
MAX_SUBSETS = 4


def _check(x, w, b, k: int):
    if x.dim() != 4:
        raise ValueError(f"x must be (V, NM, T, C_in), got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != c_in or w.shape[1] % (2 * k):
        raise ValueError(f"w must be ({c_in}, 2 K Ce) with K = {k}, got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b must be ({w.shape[1]},), got {tuple(b.shape)}")
    return w.shape[1] // (2 * k)


def _split_e(e, k: int, ce: int, acc):
    v, nm, t, _ = e.shape
    th = e[..., :k * ce].reshape(v, nm, t, k, ce).to(acc)
    ph = e[..., k * ce:].reshape(v, nm, t, k, ce).to(acc)
    return th, ph


def adaptive_graph_forward_reference(x, w, b, k: int):
    """Plain version of the forward: ``(C, E)``, the softmax ``(NM, K, V,
    V)`` in at least float32 and the rounded embeddings ``(V, NM, T, 2 K
    Ce)`` in ``x``'s dtype."""
    ce = _check(x, w, b, k)
    acc = _acc(x.dtype)
    v, nm, t, c_in = x.shape
    e = (x.reshape(-1, c_in).to(acc) @ w.to(x.dtype).to(acc)
         + b.to(x.dtype).to(acc)).to(x.dtype).reshape(v, nm, t, 2 * k * ce)
    th, ph = _split_e(e, k, ce, acc)
    s = torch.einsum("intkc,jntkc->nkij", th, ph) / (ce * t)
    return torch.softmax(s, dim=-2), e


def adaptive_graph_backward_reference(x, w, e, c, dc, k: int):
    """Plain version of the backward, written out with the kernels'
    rounding points (``dE`` in ``x``'s dtype): ``(dx, dw, db)`` in the
    dtypes of ``x``, ``w`` and ``w``."""
    acc = _acc(x.dtype)
    v, nm, t, c_in = x.shape
    ce = e.shape[-1] // (2 * k)
    dcf = dc.to(acc)
    ds = c * (dcf - (c * dcf).sum(dim=-2, keepdim=True)) / (ce * t)
    th, ph = _split_e(e, k, ce, acc)
    dth = torch.einsum("nkij,jntkc->intkc", ds, ph)
    dph = torch.einsum("nkij,intkc->jntkc", ds, th)
    de = torch.cat([dth.reshape(v, nm, t, k * ce),
                    dph.reshape(v, nm, t, k * ce)], dim=-1).to(x.dtype)
    de2 = de.reshape(-1, 2 * k * ce).to(acc)
    dx = (de2 @ w.to(x.dtype).to(acc).t()).to(x.dtype).reshape(x.shape)
    dw = x.reshape(-1, c_in).to(acc).t() @ de2
    return dx, dw.to(w.dtype), de2.sum(dim=0).to(w.dtype)


def sample_aggregate_forward_reference(x, a):
    """Plain version of the forward: ``z`` ``(V, NM, T, K C_in)`` in
    ``x``'s dtype."""
    acc = _acc(x.dtype)
    v, nm, t, c = x.shape
    k = a.shape[1]
    z = torch.einsum("vntc,nkvw->wntkc", x.to(acc), a.to(acc))
    return z.to(x.dtype).reshape(v, nm, t, k * c)


def sample_aggregate_backward_reference(x, a, dz):
    """Plain version of the backward: ``(dx, da)``, ``dx`` in ``x``'s dtype
    and ``da`` ``(NM, K, V, V)`` in ``a``'s."""
    acc = _acc(x.dtype)
    v, nm, t, c = x.shape
    k = a.shape[1]
    g = dz.reshape(v, nm, t, k, c).to(acc)
    dx = torch.einsum("nkvw,wntkc->vntc", a.to(acc), g).to(x.dtype)
    da = torch.einsum("vntc,wntkc->nkvw", x.to(acc), g)
    return dx, da.to(a.dtype)


# ---- kernel launches ---------------------------------------------------------

def _on_kernels(x) -> bool:
    """True for a CUDA tensor, False for a CPU one; the kernels take
    bfloat16 only."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"the adaptive graph kernels take bfloat16 on cuda, "
                         f"got {x.dtype} on {x.device}")
    return True


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _gemm(lib, a, b, bias, out, m, n, kd, lda, ldb, mode, splits=1,
          kchunk=0):
    with torch.cuda.device(a.device):
        err = lib.agcn_gemm_launch(
            a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, kd, lda, ldb, mode, splits, kchunk or kd,
            _stream(a.device))
    _raise_on(lib, err, "adaptive graph GEMM")


def _dw_split(rows: int, tiles: int, device) -> tuple[int, int]:
    """``(splits, rows a split)`` of the dW GEMM: about ``SPLIT_CTAS`` CTAs
    an SM over the output tiles, each split a whole number of k steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(SPLIT_CTAS * sms // max(tiles, 1),
                        -(-rows // GEMM_BK)))
    chunk = -(-rows // splits)
    chunk = -(-chunk // GEMM_BK) * GEMM_BK
    return -(-rows // chunk), chunk


def _gram(lib, p, ldp, offp, kstep_p, q, ldq, offq, kstep_q, nm, t, w, k,
          v, scale, softmax, out):
    """The Gram kernel over ``GRAM_SPLIT_CTAS`` CTAs an SM (the depth split
    between them, their partial slices added in order by its second
    kernel)."""
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    splits = max(1, min(-(-GRAM_SPLIT_CTAS * sms // (nm * k)),
                        -(-t * w // GRAM_CHUNK)))
    partial = torch.empty((splits, nm * k, GRAM_PAD * GRAM_PAD),
                          dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.agcn_gram_launch(
            p.data_ptr(), ldp, offp, kstep_p, q.data_ptr(), ldq, offq,
            kstep_q, nm, t, w, k, v, scale, softmax, splits,
            partial.data_ptr(), out.data_ptr(), _stream(p.device))
    _raise_on(lib, err, "adaptive graph Gram")


def _check_kernel_shapes(v: int, k: int):
    if v > MAX_JOINTS or k > MAX_SUBSETS:
        raise ValueError(f"the adaptive graph kernels take at most "
                         f"{MAX_JOINTS} joints and {MAX_SUBSETS} subsets, got "
                         f"{v} and {k}")


def adaptive_graph_forward(x, w, b, k: int):
    """Forward wrapper: ``(C, E)``; plain version on the CPU, kernels on
    CUDA."""
    if not _on_kernels(x):
        return adaptive_graph_forward_reference(x, w, b, k)
    from stgcn_tpu_torch.kernels._build import load_library

    ce = _check(x, w, b, k)
    x = x.contiguous()
    v, nm, t, c_in = x.shape
    _check_kernel_shapes(v, k)
    n2 = 2 * k * ce
    wb = w.to(torch.bfloat16).contiguous()
    bias = b.to(torch.bfloat16).to(torch.float32).contiguous()
    e = torch.empty((v, nm, t, n2), dtype=x.dtype, device=x.device)
    c = torch.empty((nm, k, v, v), dtype=torch.float32, device=x.device)
    rows = v * nm * t
    lib = load_library()
    _gemm(lib, x, wb, bias, e, rows, n2, c_in, c_in, n2, 0)
    _gram(lib, e, n2, 0, ce, e, n2, k * ce, ce, nm, t, ce, k, v,
          1.0 / (ce * t), 1, c)
    adaptive_graph_forward.launches += 1
    return c, e


adaptive_graph_forward.launches = 0


def adaptive_graph_backward(x, w, e, c, dc, k: int):
    """Backward wrapper: ``(dx, dw, db)``; plain version on the CPU,
    kernels on CUDA."""
    if not _on_kernels(x):
        return adaptive_graph_backward_reference(x, w, e, c, dc, k)
    from stgcn_tpu_torch.kernels._build import load_library

    x = x.contiguous()
    v, nm, t, c_in = x.shape
    n2 = e.shape[-1]
    ce = n2 // (2 * k)
    rows = v * nm * t
    dc = dc.to(torch.float32).contiguous()
    de = torch.empty_like(e)
    dx = torch.empty_like(x)
    wb = w.to(torch.bfloat16).contiguous()
    tiles = -(-c_in // GEMM_TILE) * -(-n2 // GEMM_TILE)
    splits, chunk = _dw_split(rows, tiles, x.device)
    partial = torch.empty((splits, c_in, n2), dtype=torch.float32,
                          device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.agcn_gram_bwd_launch(
            c.data_ptr(), dc.data_ptr(), e.data_ptr(), de.data_ptr(), n2,
            nm, t, ce, k, v, 1.0 / (ce * t), BWD_SPLITS, _stream(x.device))
    _raise_on(lib, err, "adaptive graph backward")
    _gemm(lib, de, wb, None, dx, rows, c_in, n2, n2, n2, 1)
    _gemm(lib, x, de, None, partial, c_in, n2, rows, c_in, n2, 2, splits,
          chunk)
    dw = partial.sum(dim=0)
    db = de.reshape(rows, n2).sum(dim=0, dtype=torch.float32)
    adaptive_graph_backward.launches += 1
    return dx, dw.to(w.dtype), db.to(w.dtype)


adaptive_graph_backward.launches = 0


def sample_aggregate_forward(x, a):
    """Forward wrapper: ``z``; plain version on the CPU, kernel on
    CUDA."""
    if not _on_kernels(x):
        return sample_aggregate_forward_reference(x, a)
    from stgcn_tpu_torch.kernels._build import load_library

    x = x.contiguous()
    v, nm, t, c = x.shape
    k = a.shape[1]
    _check_kernel_shapes(v, k)
    a32 = a.to(torch.float32).contiguous()
    z = torch.empty((v, nm, t, k * c), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.agcn_agg_launch(x.data_ptr(), a32.data_ptr(), z.data_ptr(),
                                  nm, t, c, k, v, 0, _stream(x.device))
    _raise_on(lib, err, "per-sample aggregation")
    sample_aggregate_forward.launches += 1
    return z


sample_aggregate_forward.launches = 0


def sample_aggregate_backward(x, a, dz):
    """Backward wrapper: ``(dx, da)``; plain version on the CPU, kernels
    on CUDA."""
    if not _on_kernels(x):
        return sample_aggregate_backward_reference(x, a, dz)
    from stgcn_tpu_torch.kernels._build import load_library

    x = x.contiguous()
    v, nm, t, c = x.shape
    k = a.shape[1]
    a32 = a.to(torch.float32).contiguous()
    dz = dz.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    da = torch.empty((nm, k, v, v), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.agcn_agg_launch(dz.data_ptr(), a32.data_ptr(),
                                  dx.data_ptr(), nm, t, c, k, v, 1,
                                  _stream(x.device))
    _raise_on(lib, err, "per-sample aggregation backward")
    _gram(lib, x, c, 0, 0, dz, k * c, 0, c, nm, t, c, k, v, 1.0, 0, da)
    sample_aggregate_backward.launches += 1
    return dx, da.to(a.dtype)


sample_aggregate_backward.launches = 0


class _AdaptiveGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, k):
        c, e = adaptive_graph_forward(x, w, b, k)
        ctx.save_for_backward(x, w, e, c)
        ctx.k = k
        return c

    @staticmethod
    def backward(ctx, dc):
        x, w, e, c = ctx.saved_tensors
        dx, dw, db = adaptive_graph_backward(x, w, e, c, dc, ctx.k)
        return dx, dw, db, None


class _SampleAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a):
        ctx.save_for_backward(x, a)
        return sample_aggregate_forward(x, a)

    @staticmethod
    def backward(ctx, dz):
        x, a = ctx.saved_tensors
        return sample_aggregate_backward(x, a, dz)


def adaptive_graph(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The differentiable adaptive graph ``C`` ``(NM, K, V, V)`` of ``x``
    ``(V, NM, T, C_in)``, ``w`` ``(C_in, 2 K Ce)`` (theta's K blocks of
    ``Ce`` columns, then phi's) and ``b`` ``(2 K Ce,)``."""
    return _AdaptiveGraph.apply(x, w, b, k)


def sample_aggregate(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The differentiable per-sample aggregation ``z`` ``(V, NM, T, K
    C_in)`` of ``x`` ``(V, NM, T, C_in)`` through ``a`` ``(NM, K, V, V)``."""
    return _SampleAggregate.apply(x, a)
