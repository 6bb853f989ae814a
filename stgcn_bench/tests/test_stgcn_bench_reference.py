"""The plain reference against the program's op path on the CPU, in
float64 at a small size: the graph, the train forward's logits and
gradients, three optimizer steps, and the served probabilities through the
``Predictor``'s bucketing and padding."""

import numpy as np
import pytest
import torch

from stgcn_bench import harness, weights
from stgcn_bench.reference import stgcn as ref
from stgcn_bench.tests.small import PLAN, small_cell

CELLS = ["train-kth-b64", "train-ntu-b64"]


def _inputs(cell, seed=5, n=4, t=12, trained=True):
    g = cell.config["stgcn_config"]
    gen = torch.Generator().manual_seed(seed)
    params, state = harness.make_weights(cell.config, gen, trained=trained)
    x = weights.skeleton_clips(n, t, 25, g["c_in"], gen)
    y = weights.labels(n, g["num_classes"], gen)
    dist = (ref.gravity_distances(x[..., :2])
            if g["strategy"] == "spatial_configuration" else None)
    return params, state, x, y, dist


def _model(cell, dist, **kw):
    from stgcn_tpu_torch.models.stgcn import STGCN

    kw = {"block_impl": "ops", "dtype": torch.float64,
          "compute_dtype": "float64", "dropout_rate": 0.0, **kw}
    return STGCN(harness.program_config(cell.config, **kw), distances=dist)


def _f64(tree, grad=False):
    return ref._copy(tree, torch.float64, grad)


@pytest.mark.parametrize("workload", CELLS)
def test_adjacency_is_the_programs(workload):
    cell = small_cell(workload)
    _, _, _, _, dist = _inputs(cell)
    model = _model(cell, dist)
    mine = harness.reference_adjacency(cell.config, dist, "cpu")
    assert torch.equal(model.adjacency.float(), mine)


@pytest.mark.parametrize("workload", CELLS)
def test_train_forward_and_gradients(workload):
    from stgcn_tpu_torch.training import metrics as M

    cell = small_cell(workload)
    params, state, x, y, dist = _inputs(cell)
    model = _model(cell, dist)
    a = harness.reference_adjacency(cell.config, dist, "cpu").double()
    p_prog, p_ref = _f64(params, True), _f64(params, True)
    logits, new = model.apply(p_prog, _f64(state), x.double(), train=True)
    M.cross_entropy(logits, y).backward()
    want, new_ref = ref.forward(p_ref, _f64(state), x.double(), a, PLAN,
                                train=True)
    ref.cross_entropy(want, y).backward()
    # the program takes the variance as E[x^2] - E[x]^2, the reference
    # about the mean: float64 cancellation leaves ~1e-8 of the largest
    assert torch.allclose(logits, want, rtol=1e-8, atol=1e-10)
    got, exp = ref.leaves(p_prog), ref.leaves(p_ref)
    scale = max(float(g.grad.abs().max()) for g in exp.values())
    for k in exp:
        assert torch.allclose(got[k].grad, exp[k].grad, rtol=1e-6,
                              atol=1e-7 * scale), k
    for k, v in ref.leaves(new_ref).items():
        assert torch.allclose(ref.leaves(new)[k], v, rtol=1e-10), k


@pytest.mark.parametrize("workload", CELLS)
def test_three_steps_with_dropout(workload):
    """Losses and parameters after three steps of the configuration's
    optimizer, dropout 0.5 with the keep masks drawn as the program draws
    them (float64 op path, whose masks are on ``(N, T, V, C)``)."""
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.train_state import train_state_from

    cell = small_cell(workload)
    cfg = cell.config
    params, state, x, y, dist = _inputs(cell, trained=False, n=8)
    model = _model(cell, dist, dropout_rate=0.5)
    seed = 2 ** 31 + 3
    ts = train_state_from(_f64(params), _f64(state),
                          harness.program_optimizer(cfg), seed,
                          torch.device("cpu"))
    step = make_train_step(model)
    batches = [(x[i::2].double(), y[i::2]) for i in (0, 1, 0)]
    losses = [float(step(ts, bx, by)["loss"]) for bx, by in batches]

    def masks(s):
        # the op path draws (N, T, V, C); the fused path (V, N, T, C)
        gen = torch.Generator().manual_seed(harness.dropout_key(seed, s))
        out, t = [], 12
        for c, stride in PLAN:
            t = (t - 1) // stride + 1
            u = torch.rand((4, t, 25, c), generator=gen)
            out.append((u < 0.5).permute(0, 3, 1, 2))
        return out

    a = harness.reference_adjacency(cfg, dist, "cpu")
    out = ref.train(params, state, batches, a, PLAN, cfg["optimizer"],
                    dropout=0.5, keep_masks=masks, dtype=torch.float64)
    assert np.allclose(losses, out["losses"], rtol=1e-8)
    for k, v in ref.leaves(ts.params).items():
        assert torch.allclose(v.detach(), out["params"][k], rtol=1e-6,
                              atol=1e-8), k


def test_served_probabilities():
    """The ``Predictor`` (buckets, wrap-padding, batch padding, the fused
    eval forward's plain versions in float32 on the CPU) against the
    reference's probabilities."""
    from stgcn_tpu_torch.serving import Predictor

    from stgcn_bench.drivers import serve_closed

    cell = small_cell("serve-kth-clips", f32=True)
    params, state, x, _, _ = _inputs(cell, n=12, t=40)
    lengths = [5, 12, 19, 20, 21, 33, 40, 40, 7, 28, 38, 11]
    clips = [x[i, :n] for i, n in enumerate(lengths)]
    model = serve_closed.served_model(cell, params, state, "cpu")
    pred = Predictor(model, buckets=(20, 40), max_batch=8, device="cpu")
    got = torch.from_numpy(pred.predict([c.numpy() for c in clips]).probs)
    a = harness.reference_adjacency(cell.config, None, "cpu")
    want = ref.predict(params, state, clips, a, PLAN, (20, 40), batch=5)
    assert torch.allclose(got, want, atol=2e-6)
    assert float((want.max(1).values - want.min(1).values).min()) > 0.05
