"""Training 2s-AGCN on one card: the program's train step
(``make_train_step`` over ``stgcn_tpu_torch.models.agcn.AGCN``, captured)
on a ring of distinct two-body batches, one step each, back to back.

The traffic file gives ``batch`` (clips), ``bodies``, ``frames``,
``second_body_share``, ``ring``, ``check_steps`` and ``inflight`` as the
other training cells' do.  A clip's skeletons are ``weights.skeleton_clips``
drawn from the seed; its second body is a skeleton of its own where the
clip's label is among the last ``second_body_share`` of the classes (NTU
RGB+D 60's mutual actions, A50-A60), and zeros elsewhere, as NTU's feeder
pads a one-person clip.  The weights follow ``model/agcn.py``'s
initialisation, drawn from the seed, with the GCN BatchNorm's scale at 1
and ``B_k`` uniform in +-0.1 (the configuration's ``assumed``).

The first ``check_steps`` calls run before the window on the ring's first
batches; the plain reference (``stgcn_bench/reference/agcn.py``) follows
them after the window has closed, and ``check.train_numbers`` compares.
"""

from __future__ import annotations

import json
import math
import statistics
import time

import torch

from stgcn_bench import check, harness, training, weights
from stgcn_bench.reference import agcn as ref
from stgcn_bench.trace import profiled

K = 3

# the readings this cell's limits may name: ``check.train_numbers``' and
# ``stats_median``, the median leaf of the running statistics' change
COMPARED = training.COMPARED + ("stats_median",)


def unit_shapes(config: dict) -> list[tuple[int, int, int, bool]]:
    """``(c_in, c_out, stride, residual)`` of every unit (the first has no
    shortcut)."""
    g = config["agcn_config"]
    out, c_prev = [], g["c_in"]
    for i, (c_out, stride) in enumerate(g["plan"]):
        out.append((c_prev, c_out, stride, i > 0))
        c_prev = c_out
    return out


def _specs(config: dict) -> list:
    """``(path, shape, std)`` of every weight drawn from a normal."""
    g = config["agcn_config"]
    gamma, out = g["gamma"], []
    for i, (c_in, c_out, stride, residual) in enumerate(unit_shapes(config)):
        ce = c_out // g["coff_embedding"]
        out += [((i, "gcn", "a_w"), (K, c_in, ce), math.sqrt(2.0 / ce)),
                ((i, "gcn", "b_w"), (K, c_in, ce), math.sqrt(2.0 / ce)),
                ((i, "gcn", "d_w"), (K, c_in, c_out),
                 math.sqrt(2.0 / (c_out * c_in * K))),
                ((i, "tcn", "w"), (gamma, c_out, c_out),
                 math.sqrt(2.0 / (c_out * gamma)))]
        if c_in != c_out:
            out.append(((i, "down", "w"), (c_in, c_out),
                        math.sqrt(2.0 / c_out)))
        if residual and (c_in != c_out or stride != 1):
            out.append(((i, "res", "w"), (c_in, c_out),
                        math.sqrt(2.0 / c_out)))
    out.append(((None, "fc", "w"), (g["plan"][-1][0], g["num_classes"]),
                math.sqrt(2.0 / g["num_classes"])))
    return out


def make_weights(config: dict, generator: torch.Generator
                 ) -> tuple[dict, dict]:
    """``(params, state)`` in the layout of ``AGCN.init_params``, float32
    on the generator's device, in two draws: the normals of every conv and
    of ``fc`` (zero biases), then ``B_k`` uniform in +-0.1; BatchNorms at
    scale 1, offset 0, statistics 0 and 1."""
    g, v = config["agcn_config"], config["graph"]["num_joints"]
    dev = generator.device
    specs = _specs(config)
    sizes = [math.prod(s) for _, s, _ in specs]
    draw = torch.randn(sum(sizes), generator=generator, device=dev)
    shapes = unit_shapes(config)
    pa = torch.rand(len(shapes) * K * v * v, generator=generator,
                    device=dev).mul_(0.2).sub_(0.1)

    def bn(c):
        return ({"scale": torch.ones(c, device=dev),
                 "offset": torch.zeros(c, device=dev)},
                {"mean": torch.zeros(c, device=dev),
                 "var": torch.ones(c, device=dev)})

    units = [{"gcn": {}} for _ in shapes]
    states = [{} for _ in shapes]
    fc = {}
    for ((i, group, name), shape, std), piece in zip(
            specs, torch.split(draw, sizes)):
        target = fc if i is None else units[i].setdefault(group, {})
        target[name] = (piece * std).reshape(shape)
    for i, (c_in, c_out, stride, residual) in enumerate(shapes):
        p, s = units[i], states[i]
        ce = c_out // g["coff_embedding"]
        gp = p["gcn"]
        gp["a_b"] = torch.zeros(K, ce, device=dev)
        gp["b_b"] = torch.zeros(K, ce, device=dev)
        gp["d_b"] = torch.zeros(K, c_out, device=dev)
        gp["PA"] = pa[i * K * v * v:(i + 1) * K * v * v].reshape(K, v, v)
        p["tcn"]["b"] = torch.zeros(c_out, device=dev)
        for key in ("bn_g", "bn_t"):
            p[key], s[key] = bn(c_out)
        for conv, key in (("down", "bn_down"), ("res", "bn_res")):
            if conv in p:
                p[conv]["b"] = torch.zeros(c_out, device=dev)
                p[key], s[key] = bn(c_out)
    fc["b"] = torch.zeros(g["num_classes"], device=dev)
    data_p, data_s = bn(g["num_persons"] * v * g["c_in"])
    return ({"data_bn": data_p, "units": units, "fc": fc},
            {"data_bn": data_s, "units": states})


def inputs(cell, seed: int, device):
    """``(params, state, xs, ys)``: the starting weights, then the ring
    ``(R, B, M, T, V, C)`` with its labels, all drawn on ``device`` from
    one generator seeded with ``seed``."""
    cfg, tr = cell.config, cell.traffic
    g = cfg["agcn_config"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, state = make_weights(cfg, gen)
    r, b, m, t = tr["ring"], tr["batch"], tr["bodies"], tr["frames"]
    v, c = cfg["graph"]["num_joints"], g["c_in"]
    ys = weights.labels(r * b, g["num_classes"], gen).reshape(r, b)
    xs = weights.skeleton_clips(r * b * m, t, v, c, gen).reshape(
        r, b, m, t, v, c)
    mutual = g["num_classes"] - round(tr["second_body_share"]
                                      * g["num_classes"])
    alone = (ys < mutual)[:, :, None, None, None, None]
    xs[:, :, 1:] = torch.where(alone, torch.zeros((), device=device),
                               xs[:, :, 1:])
    return params, state, xs, ys


def program_model(cell, device):
    from stgcn_tpu_torch.models.agcn import AGCN, AGCNConfig

    g = dict(cell.config["agcn_config"])
    if g.pop("num_subsets") != K:
        raise ValueError("the program's AGCN has three subsets")
    g["plan"] = tuple(tuple(p) for p in g["plan"])
    g["compute_dtype"] = getattr(torch, g["compute_dtype"])
    return AGCN(AGCNConfig(**g)).to(device)


def program_optimizer(config: dict):
    from stgcn_tpu_torch.training.optimizers import OptimizerSpec

    o = config["optimizer"]
    return OptimizerSpec("momentum", o["lr"], momentum=o["momentum"],
                         weight_decay=o["weight_decay"],
                         nesterov=o["nesterov"])


def strides(config: dict) -> list[int]:
    return [s for _, s in config["agcn_config"]["plan"]]


def reference_train(cell, inp: dict, *, rows=None, rounding=None,
                    adaptive: bool = True) -> dict:
    """The reference over the first ``check_steps`` batches (their first
    ``rows`` clips)."""
    steps = cell.traffic["check_steps"]
    batches = [(inp["xs"][i][:rows], inp["ys"][i][:rows])
               for i in range(steps)]
    return ref.train(inp["params"], inp["state"], batches,
                     strides(cell.config), cell.config["optimizer"],
                     rounding=rounding, adaptive=adaptive)


def readings(got: dict, want: dict, inp: dict) -> dict:
    """``check.train_numbers`` of ``got`` against ``want``, both from the
    starting weights of ``inp``, with ``stats_median`` and
    ``grad_gap_live``: the worst leaf's gradient gap over the leaves whose
    reference gradient is not nought (no element reaches ``check``'s
    quiet floor).  The nought ones are the conv biases before a BatchNorm
    and theta's bias, whose shift along a column the softmax over i takes
    out; ``change_gap`` leaves them out already."""
    nums = check.train_numbers(got, want, ref.leaves(inp["params"]),
                               ref.leaves(inp["state"]))
    nums["stats_median"] = statistics.median(
        nums["leaves"]["stats"].values())
    nought = {k for k, n in nums["quiet"].items()
              if n == want["first_grads"][k].numel()}
    nums["grad_gap_live"], nums["grad_leaf_live"] = check.worst(
        {k: v for k, v in nums["leaves"]["grad"].items() if k not in nought})
    nums["nought"] = sorted(nought)
    return nums


def reference_check(cell, inp: dict, prog: dict) -> tuple[list, dict]:
    """The ``(name, value, limit)`` triples of the readings that the
    cell's limits name, and every reading, which it prints."""
    out = reference_train(cell, inp)
    nums = readings(prog, out, inp)
    lim = cell.limits
    print("check detail: " + json.dumps({
        "losses": prog["losses"], "reference": out["losses"],
        **{k: v for k, v in nums.items() if k not in ("quiet", "leaves")}}),
        flush=True)
    return [(name, nums[name], lim[name]) for name in COMPARED
            if name in lim], nums


def run(cell, seed: int, seconds: float, trace: bool, env: dict) -> dict:
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.train_state import train_state_from

    device = env["device"]
    tr = cell.traffic
    harness.set_tf32(cell.config)
    harness.stage(env, "imports")
    params, state, xs, ys = inputs(cell, seed, device)
    harness.stage(env, "inputs")
    model = program_model(cell, device)
    ts = train_state_from(params, state, program_optimizer(cell.config),
                          seed, device)
    step = env.get("make_step", make_train_step)(model)
    harness.stage(env, "model")
    prog = training.first_steps(step, ts, xs, ys, cell.config,
                                tr["check_steps"])
    training.synchronize(device)
    harness.stage(env, "first_steps")
    setup_s = time.time() - env["start"]
    with profiled(trace) as rec:
        with torch.profiler.record_function("window"):
            steps, window_s, issue, last_loss = training.window(
                step, ts, xs, ys, start=tr["check_steps"], seconds=seconds,
                device=device, inflight=tr["inflight"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del step, ts, model
    training.release()
    inp = {"params": params, "state": state, "xs": xs, "ys": ys}
    numbers, readings = reference_check(cell, inp, prog)
    return {
        "attempted": steps,
        "failed": 0 if last_loss == last_loss else steps,
        "e2e": {"setup_s": setup_s,
                "train_seq_per_s": steps * tr["batch"] / window_s,
                "peak_mem_gib": peak / 2 ** 30},
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "trace": rec.trace,
        "busy_s": [rec.trace.busy_s()] if rec.trace else None,
        "readings": readings,
        "check_inputs": inp,
        "ctx": {"steps": steps, "window_s": window_s,
                "batch": tr["batch"], "frames": tr["frames"],
                "bodies": tr["bodies"],
                "issue_ms": training.mean(issue) * 1e3},
    }
