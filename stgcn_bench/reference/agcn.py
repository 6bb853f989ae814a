"""A plain PyTorch 2s-AGCN (joint stream): the yardstick that decides
``correct`` for the AGCN cells.

Written from ``model/agcn.py``, ``graph/ntu_rgb_d.py`` and
``config/nturgbd-cross-subject/train_joint.yaml`` of
github.com/lshiwjx/2s-AGCN (Shi et al., CVPR 2019, arXiv:1805.07694): the
same per-subset loop, ``.view``s and order, in float32 by default, with no
kernel, no batching trick and TF32 off.  It imports nothing of the program
under test: the graph is built here from the edge list, the weights are
the benchmark's, copied.

Departures from the published code:

* parameters are one dictionary a unit in the layout the benchmark makes
  them (``stgcn_bench/drivers/train_agcn.py``): ``gcn`` ``a_w``/``b_w``
  ``(K, C_in, Ce)`` and ``a_b``/``b_b`` ``(K, Ce)`` (``conv_a``,
  ``conv_b``), ``d_w`` ``(K, C_in, C_out)`` and ``d_b`` (``conv_d``),
  ``PA``; ``bn_g``; ``down``/``bn_down``; ``tcn`` ``w`` ``(9, C_out,
  C_out)`` and ``b``, ``bn_t``; ``res``/``bn_res``; ``data_bn``; ``fc``
  ``w`` ``(C, classes)`` and ``b``.  Each is turned into the published
  layer's weight where it is used;
* the input arrives as ``(N, M, T, V, C)`` and is permuted to the
  published ``(N, C, T, V, M)`` first;
* a BatchNorm is ``F.batch_norm`` on copies of the running statistics
  (``nn.BatchNorm``'s arithmetic, momentum 0.1, eps 1e-5);
* ``rounding`` rounds every tensor that a lower-precision program would
  hold in its compute type (each unit's input, conv inputs and weights,
  their outputs, the head), for the control of the check; ``adaptive=False``
  leaves the data-dependent graph ``C_k`` out (``A_k + B_k`` only), the
  fault that a program which dropped the mechanism would give.

The optimizer is ``torch.optim.SGD`` with the configuration's momentum,
Nesterov and weight decay.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
NUM_JOINTS = 25

# graph/ntu_rgb_d.py: the inward edges, 1-indexed
INWARD_1 = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
            (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13),
            (15, 14), (16, 15), (17, 1), (18, 17), (19, 18), (20, 19),
            (22, 23), (23, 8), (24, 25), (25, 12)]


def edge2mat(link, num_node):
    a = np.zeros((num_node, num_node))
    for i, j in link:
        a[j, i] = 1
    return a


def normalize_digraph(a):
    dl = np.sum(a, 0)
    h, w = a.shape
    dn = np.zeros((w, w))
    for i in range(w):
        if dl[i] > 0:
            dn[i, i] = dl[i] ** (-1)
    return np.dot(a, dn)


def subsets(num_node: int = NUM_JOINTS) -> np.ndarray:
    """``(3, V, V)``: identity, normalized inward, normalized outward."""
    inward = [(i - 1, j - 1) for i, j in INWARD_1]
    outward = [(j, i) for i, j in inward]
    return np.stack((np.eye(num_node),
                     normalize_digraph(edge2mat(inward, num_node)),
                     normalize_digraph(edge2mat(outward, num_node))))


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _keep(x):
    return x


def _conv(x, w, b, rnd, stride=1):
    """A 1 x 1 conv (``nn.Conv2d(C_in, C_out, 1, stride=(stride, 1))``)
    with weight ``w`` ``(C_in, C_out)``."""
    return rnd(F.conv2d(rnd(x), rnd(w.t()[:, :, None, None]), rnd(b),
                        stride=(stride, 1)))


def _bn(x, p, st, new, key):
    mean, var = st[key]["mean"].clone(), st[key]["var"].clone()
    out = F.batch_norm(x, mean, var, p[key]["scale"], p[key]["offset"],
                       training=True, momentum=BN_MOMENTUM, eps=BN_EPS)
    new[key] = {"mean": mean, "var": var}
    return out


def unit_gcn(p, st, new, x, A, rnd, adaptive=True):
    gp = p["gcn"]
    N, C, T, V = x.size()
    A = A + gp["PA"]
    inter_c = gp["a_w"].shape[2]
    y = None
    for i in range(A.shape[0]):
        A1 = _conv(x, gp["a_w"][i], gp["a_b"][i], rnd).permute(
            0, 3, 1, 2).contiguous().view(N, V, inter_c * T)
        A2 = _conv(x, gp["b_w"][i], gp["b_b"][i], rnd).view(N, inter_c * T, V)
        A1 = torch.softmax(torch.matmul(A1, A2) / A1.size(-1), -2)  # N V V
        if not adaptive:
            A1 = torch.zeros_like(A1)
        A1 = A1 + A[i]
        A2 = rnd(x).view(N, C * T, V)
        z = _conv(rnd(torch.matmul(A2, A1).view(N, C, T, V)), gp["d_w"][i],
                  gp["d_b"][i], rnd)
        y = z + y if y is not None else z
    y = _bn(y, p, st, new, "bn_g")
    if "down" in p:
        y = y + _bn(_conv(x, p["down"]["w"], p["down"]["b"], rnd), p, st,
                    new, "bn_down")
    else:
        y = y + x
    return torch.relu(y)


def unit_tcn(p, st, new, x, stride, rnd):
    w = p["tcn"]["w"]                                # (9, C, C_out)
    pad = (w.shape[0] - 1) // 2
    h = rnd(F.conv2d(rnd(x), rnd(w.permute(2, 1, 0)[..., None]),
                     rnd(p["tcn"]["b"]), stride=(stride, 1),
                     padding=(pad, 0)))
    return _bn(h, p, st, new, "bn_t")


def tcn_gcn_unit(p, st, x, A, stride, residual, rnd, adaptive=True):
    new = {}
    out = unit_tcn(p, st, new, unit_gcn(p, st, new, x, A, rnd, adaptive),
                   stride, rnd)
    if "res" in p:
        out = out + _bn(_conv(x, p["res"]["w"], p["res"]["b"], rnd, stride),
                        p, st, new, "bn_res")
    elif residual:
        out = out + x
    return rnd(torch.relu(out)), new


def forward(params, state, x, A, strides, rounding=None, adaptive=True):
    """Train-mode logits and new running statistics of ``x`` ``(N, M, T,
    V, C)``."""
    rnd = rounding or _keep
    x = x.permute(0, 4, 2, 3, 1)                     # (N, C, T, V, M)
    N, C, T, V, M = x.size()
    x = x.permute(0, 4, 3, 1, 2).contiguous().view(N, M * V * C, T)
    new = {}
    x = _bn(x, params, state, new, "data_bn")
    x = rnd(x.view(N, M, V, C, T).permute(0, 1, 3, 4, 2).contiguous().view(
        N * M, C, T, V))
    units = []
    for i, (p, st) in enumerate(zip(params["units"], state["units"])):
        x, s = tcn_gcn_unit(p, st, x, A, strides[i], i > 0, rnd, adaptive)
        units.append(s)
    c_new = x.size(1)
    x = x.view(N, M, c_new, -1)
    x = x.mean(3).mean(1)
    logits = rnd(F.linear(rnd(x), rnd(params["fc"]["w"].t()),
                          rnd(params["fc"]["b"])))
    return logits, {"data_bn": new["data_bn"], "units": units}


def leaves(tree, prefix=""):
    """``{path: tensor}`` of a nested dictionary and list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if torch.is_tensor(v):
            out[path] = v
        else:
            out.update(leaves(v, path))
    return out


def _copy(tree, dtype, requires_grad=False):
    if torch.is_tensor(tree):
        return tree.detach().to(dtype, copy=True).requires_grad_(
            requires_grad)
    if isinstance(tree, dict):
        return {k: _copy(v, dtype, requires_grad) for k, v in tree.items()}
    return [_copy(v, dtype, requires_grad) for v in tree]


def train(params, state, batches, strides, optimizer: dict, *,
          rounding=None, adaptive: bool = True,
          dtype: torch.dtype = torch.float32) -> dict:
    """Train steps on copies of ``params`` and ``state``, one a batch of
    ``batches`` (``(x, y)`` pairs): ``torch.optim.SGD`` with the
    configuration's ``lr``, ``momentum``, ``nesterov`` and
    ``weight_decay``.  Returns each step's loss, the first step's momentum
    buffer (the gradient with its weight decay, as the optimizer got it),
    and the parameters and the running statistics after the last step."""
    params = _copy(params, dtype, requires_grad=True)
    state = _copy(state, dtype)
    flat = leaves(params)
    opt = torch.optim.SGD(list(flat.values()), lr=optimizer["lr"],
                          momentum=optimizer["momentum"],
                          nesterov=optimizer["nesterov"],
                          weight_decay=optimizer["weight_decay"])
    device = next(iter(flat.values())).device
    A = torch.from_numpy(subsets()).to(device=device, dtype=dtype)
    losses, first = [], None
    with no_tf32():
        for x, y in batches:
            opt.zero_grad(set_to_none=True)
            logits, state = forward(params, state, x.to(dtype), A, strides,
                                    rounding, adaptive)
            loss = F.cross_entropy(logits.to(torch.promote_types(
                logits.dtype, torch.float32)), y.long())
            loss.backward()
            opt.step()
            if first is None:
                first = {k: opt.state[p].get(
                    "momentum_buffer", torch.zeros_like(p)).detach().clone()
                    for k, p in flat.items()}
            losses.append(float(loss.detach()))
            del logits, loss
    return {"losses": losses, "first_grads": first,
            "params": {k: p.detach() for k, p in flat.items()},
            "state": leaves(state)}
