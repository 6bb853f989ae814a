"""The rank side of the ``tests/test_torch_parallel_*.py`` files.

The test files hold JAX (and its 8 virtual devices), so the ranks of a
``torch.distributed`` world cannot run there: :func:`launch` starts each
rank as a fresh ``python`` process running this module, which imports
torch, numpy and the port only.  The processes meet at a ``file://``
rendezvous in the test's temporary directory (no TCP port, so parallel
test workers cannot collide), on the gloo backend, one thread each.  Each
rank runs one suite of cases (one ``suite_*`` function) on the inputs the
test pickled, and pickles what it returns; every rank of the world calls
``make_mesh`` for every case, as ``torch.distributed`` makes groups
collectively, and a rank outside a case's mesh skips its work.

    python tests/torch_parallel_ranks.py SUITE RANK WORLD DIR
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(suite: str, world: int, inputs: dict, tmp: str,
           timeout_s: float = 300.0) -> list:
    """Run ``suite`` on ``world`` ranks with ``inputs``; returns each
    rank's result.  Fails with every failed rank's output."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", TMPDIR=tmp)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(world), tmp], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [f"rank {r} (exit {p.returncode}):\n{o[-4000:]}"
              for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---- helpers of the rank side ------------------------------------------

def _np(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def _model(cfg: dict):
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig

    cfg = dict(cfg)
    cfg["strategy"] = Strategy(cfg["strategy"])
    cfg["dtype"] = getattr(torch, cfg.get("dtype", "float64"))
    return STGCN(STGCNConfig(**cfg))


def _state_from(params, state, mesh, replicated):
    """This rank's train state over the given whole (numpy) weights."""
    from stgcn_tpu_torch.models.convert import params_from_jax
    from stgcn_tpu_torch.parallel.mesh import shard_params
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import train_state_from

    p, s = params_from_jax(params, state)
    local = shard_params(p, mesh, replicated=replicated)
    return train_state_from(local, s, adam(1e-3), 0, mesh.device)


def _grads(ts, mesh, replicated):
    """The whole gradient tree of a sharded step (gathered over model)."""
    from stgcn_tpu_torch.parallel.mesh import gather_params
    from stgcn_tpu_torch.tree import tree_map

    g = tree_map(lambda p: p.grad, ts.params)
    return _np(gather_params(g, mesh, replicated=replicated))


def _count_conv_kernel_calls() -> dict:
    """Wrap the conv ops' kernel wrappers (``spatial_conv_fused``,
    ``temporal_conv_fused``, which run their plain versions on the CPU) so
    that each call is counted; returns the counts, updated in place."""
    from stgcn_tpu_torch.ops import spatial_conv, temporal_conv

    calls = {"spatial_conv": 0, "temporal_conv": 0}
    for mod, name in ((spatial_conv, "spatial_conv"),
                      (temporal_conv, "temporal_conv")):
        fn = getattr(mod, f"{name}_fused")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(mod, f"{name}_fused", counted)
    return calls


# ---- suites ----------------------------------------------------------------

def suite_step(inp: dict) -> dict:
    """The ops-path sharded step on each case's mesh: loss, whole
    gradients, new BN state, the conv kernel wrappers' calls; the eval
    step's sums; the masked step; the shard/gather round trip."""
    import torch

    from stgcn_tpu_torch.parallel.mesh import (
        gather_params,
        make_mesh,
        shard_params,
    )
    from stgcn_tpu_torch.parallel.train import (
        make_sharded_eval_step,
        make_sharded_grads,
        shard_batch,
    )
    from stgcn_tpu_torch.tree import tree_leaves

    calls = _count_conv_kernel_calls()
    out = {}
    for name, case in inp["cases"].items():
        mesh = make_mesh(*case["mesh"], device="cpu")
        if mesh is None:
            continue
        model = _model(case["config"])
        joints = case.get("shard_joints", False)
        ts = _state_from(case["params"], case["state"], mesh, joints)
        mask = case.get("time_mask")
        grads = make_sharded_grads(model, mesh, shard_joints=joints,
                                   use_time_mask=mask is not None)
        batch = shard_batch(case["x"], case["y"], mesh, shard_joints=joints,
                            time_mask=mask)
        before = dict(calls)
        loss, acc, new_ms = grads(ts, *batch)
        res = {"loss": float(loss), "acc": float(acc),
               "grads": _grads(ts, mesh, joints), "state": _np(new_ms),
               "kernel_calls": {k: calls[k] - before[k] for k in calls}}
        if case.get("eval"):
            sums = make_sharded_eval_step(model, mesh, shard_joints=joints)(
                ts, *batch[:2])
            res["eval"] = _np(sums)
        if case.get("round_trip"):
            from stgcn_tpu_torch.models.convert import params_from_jax

            whole, _ = params_from_jax(case["params"], case["state"])
            back = gather_params(shard_params(whole, mesh), mesh)
            res["round_trip"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                  tree_leaves(back)))
        out[name] = res
    return out


def suite_halo(inp: dict) -> dict:
    """The halo conv of each case against the unsharded op on every
    rank's whole input: each rank's output shard and its gradients."""
    import torch

    from stgcn_tpu_torch.parallel.halo import make_halo_temporal_conv
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.ops.temporal_conv import temporal_conv

    out = {}
    for name, case in inp["cases"].items():
        mesh = make_mesh(*case["mesh"], device="cpu")
        if mesh is None:
            continue
        record = []
        conv = make_halo_temporal_conv(mesh, inner_impl=case["impl"],
                                       overlap=case["overlap"],
                                       record=record)
        x = torch.from_numpy(case["x"])
        nt, i = case["mesh"][1], mesh.index("time")
        t_l = x.shape[1] // nt
        xs = x[:, i * t_l:(i + 1) * t_l].clone().requires_grad_()
        params = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in case["params"].items()}
        y = conv(params, xs, stride=case["stride"])
        g = torch.from_numpy(case["g"])
        t_o = g.shape[1] // nt
        (y * g[:, i * t_o:(i + 1) * t_o]).sum().backward()
        dx = xs.grad.numpy().copy()
        dw, db = params["w"].grad.clone(), params["b"].grad.clone()
        # the parameters' gradients summed over the time ranks
        torch.distributed.all_reduce(dw, group=mesh.group("time"))
        torch.distributed.all_reduce(db, group=mesh.group("time"))
        # the unsharded op on the whole input
        xw = x.clone().requires_grad_()
        pw = {k: torch.from_numpy(v).requires_grad_()
              for k, v in case["params"].items()}
        yw = temporal_conv(pw, xw, stride=case["stride"], impl=case["impl"])
        (yw * g).sum().backward()
        out[name] = {
            "y": y.detach().numpy(), "dx": dx, "dw": dw.numpy(),
            "db": db.numpy(),
            "y_whole": yw.detach()[:, i * t_o:(i + 1) * t_o].numpy(),
            "dx_whole": xw.grad[:, i * t_l:(i + 1) * t_l].numpy(),
            "dw_whole": pw["w"].grad.numpy(),
            "db_whole": pw["b"].grad.numpy(), "record": record}
    return out


def suite_fused_dp(inp: dict) -> dict:
    """The data-parallel fused step's gradients, loss and BN state, its
    eval logits, and ``Predictor(mesh)``'s answer."""
    import torch

    from stgcn_tpu_torch.models.convert import state_dict_from_jax
    from stgcn_tpu_torch.parallel.fused_dp import (
        fused_eval_forward_dp,
        make_fused_dp_grads,
    )
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import shard_batch
    from stgcn_tpu_torch.serving import Predictor

    mesh = make_mesh(*inp["mesh"], device="cpu")
    model = _model(inp["config"])
    ts = _state_from(inp["params"], inp["state"], mesh, True)
    x, y = shard_batch(inp["x"], inp["y"], mesh)
    loss, acc, new_ms = make_fused_dp_grads(model, mesh)(
        ts.params, ts.model_state, None, x, y)
    with torch.no_grad():
        logits = fused_eval_forward_dp(model, ts.params, ts.model_state, x,
                                       mesh)
    serve = _model(inp["serve_config"])
    serve.load_state_dict(state_dict_from_jax(
        inp["serve_params"], inp["serve_state"], residual=True,
        adjacency=serve.adjacency.numpy()))
    pred = Predictor(serve, buckets=inp["buckets"],
                     max_batch=inp["max_batch"], mesh=mesh)
    probs = pred.predict(inp["sequences"]).probs
    return {"loss": float(loss), "acc": float(acc),
            "grads": _grads(ts, mesh, True), "state": _np(new_ms),
            "logits": logits.numpy(), "probs": probs}


def suite_trainer(inp: dict) -> dict:
    """A ``(1, 1, 2)`` ``Trainer`` run with a checkpoint from rank 0, its
    sharded eval logits and the unsharded logits of its gathered state;
    then the training CLI on a ``(2, 1, 1)`` mesh."""
    import contextlib
    import io

    import torch

    from stgcn_tpu_torch.cli.train import main as cli_main
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        apply_hooks,
        gather_train_state,
        shard_batch,
    )
    from stgcn_tpu_torch.training.loop import Trainer
    from stgcn_tpu_torch.training.optimizers import adam

    mesh = make_mesh(1, 1, 2, device="cpu")
    model = _model(inp["config"])
    trainer = Trainer(model, adam(1e-3), mesh=mesh,
                      checkpoint_dir=inp["ckpt_dir"],
                      checkpoint_every_epochs=1)
    state = trainer.init_state()
    batches = [(x, y, None) for x, y in inp["batches"]]
    result = trainer.fit(state, lambda epoch: batches, epochs=2)
    x, y = shard_batch(inp["eval_x"], inp["eval_y"], mesh)
    with torch.no_grad():
        sharded, _ = model.apply(state.params, state.model_state, x,
                                 train=False, **apply_hooks(model, mesh))
    full = gather_train_state(state, mesh)
    with torch.no_grad():
        whole, _ = model.apply(full.params, full.model_state,
                               torch.from_numpy(inp["eval_x"]), train=False)
    out = {"history": result.history, "step": state.step,
           "sharded_logits": sharded.numpy(), "whole_logits": whole.numpy()}

    # the CLI on two ranks of a data axis
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(inp["cli_argv"])
    out["cli_rc"], out["cli_out"] = rc, buf.getvalue()
    return out


def main(suite: str, rank: int, world: int, tmp: str) -> None:
    import torch

    from stgcn_tpu_torch.parallel.launcher import initialize_distributed

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    initialize_distributed("file://" + os.path.join(tmp, "rendezvous"),
                           world, rank, backend="gloo")
    result = globals()[f"suite_{suite}"](inputs)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
