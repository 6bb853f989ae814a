"""The port stands alone: it imports nothing of JAX or of ``stgcn_tpu``.

The GPU machine the port runs on has torch, numpy, scipy, einops, pytest and
hypothesis, and no jax, jaxlib, pandas, ml_dtypes or optax.  A subprocess
recreates that with an import hook, serves a prediction, takes one hybrid
train step (through ``training/graphs.CapturedStep``, eager on the CPU), saves and restores a checkpoint, runs an eval step, serves
from the checkpoint and takes one sharded step of
``stgcn_tpu_torch.parallel`` on a one-rank gloo mesh on the CPU; a second one imports ``stgcn_tpu_torch.data``
and runs the training CLI for one synthetic epoch on the CPU, TensorBoard
hidden as well; a third runs ``bench_torch.py`` at a tiny size and imports
every ``scripts/torch_*.py``; an AST scan checks every module of the port,
``chip_smoke.py``, ``bench_torch.py`` and the ``scripts/torch_*.py`` tools.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pandas", "ml_dtypes", "optax", "stgcn_tpu")
TOOL_FILES = [ROOT / "bench_torch.py"] + sorted(
    (ROOT / "scripts").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "stgcn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "minimal_train_torch.py",
    *TOOL_FILES]
# the port's scripts import each other and chip_smoke.py by module name
LOCAL_MODULES = {p.stem for p in PORT_FILES
                 if "stgcn_tpu_torch" not in p.relative_to(ROOT).parts}

HOOK = textwrap.dedent("""
    import sys

    FORBIDDEN = {forbidden!r}

    import importlib.machinery

    class Absent:
        # loader of a blocked module: importing it fails as for a package
        # that is not installed
        def create_module(self, spec):
            raise ModuleNotFoundError("blocked " + spec.name)

        def exec_module(self, module):
            raise ModuleNotFoundError("blocked " + module.__name__)

    class Block:
        # a spec without an origin, so probes such as torch._dynamo's
        # find_spec scan of optional libraries see no installed package
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                return importlib.machinery.ModuleSpec(name, Absent())
            return None

    sys.meta_path.insert(0, Block())
""")

SCRIPT = HOOK + textwrap.dedent("""
    import numpy as np
    import stgcn_tpu_torch
    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
    from stgcn_tpu_torch.serving import Predictor
    import stgcn_tpu_torch.kernels._build
    import stgcn_tpu_torch.models.convert

    model = STGCN(STGCNConfig(plan=((8, 1), (16, 2)),
                              strategy=Strategy.DISTANCE, residual=True))
    pred = Predictor(model, max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    out = pred.predict([rng.normal(0, 1, (t, 25, 2)).astype(np.float32)
                        for t in (40, 70, 90)])
    assert out.probs.shape == (3, 6), out.probs.shape

    import torch
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    cfg = STGCNConfig(plan=((8, 1), (16, 2)), strategy=Strategy.DISTANCE,
                      residual=True, dropout_rate=0.5, block_impl="hybrid",
                      fused_blocks=(1,))
    train_model = STGCN(cfg)
    ts = create_train_state(train_model, adam(1e-3), device="cpu")
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 25, 2)).astype(np.float32))
    step = make_train_step(train_model)
    metrics = step(ts, x, torch.tensor([1, 4]))
    assert bool(torch.isfinite(metrics["loss"])), metrics
    # the captured step's module, eager on the CPU
    import stgcn_tpu_torch.training.graphs as graphs
    assert isinstance(step, graphs.CapturedStep) and not step.captured
    assert step.signatures == 1 and step.cache_size == 0

    import tempfile
    from stgcn_tpu_torch.training import checkpoint
    from stgcn_tpu_torch.training.loop import make_eval_step

    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_checkpoint(d + "/ckpt_1", ts, {{"step": 1}})
        fresh = create_train_state(train_model, adam(1e-3), seed=5,
                                   device="cpu")
        checkpoint.restore_checkpoint(checkpoint.latest_checkpoint(d), fresh)
        assert fresh.step == 1 and fresh.seed == 0
        sums = make_eval_step(train_model)(fresh, x, torch.tensor([1, 4]))
        assert int(sums["count"]) == 2, sums
        served = Predictor.from_checkpoint(d + "/ckpt_1", cfg, max_batch=2,
                                           device="cpu")
        assert served.predict([x[0].numpy()]).probs.shape == (1, 6)

    from stgcn_tpu_torch.parallel import (create_sharded_train_state,
                                          make_mesh, make_sharded_train_step,
                                          shard_batch)
    mesh = make_mesh(1, 1, 1, device="cpu")     # a one-rank gloo world
    pmodel = STGCN(STGCNConfig(plan=((8, 1), (16, 2)),
                               strategy=Strategy.DISTANCE))
    pts, _ = create_sharded_train_state(pmodel, adam(1e-3), mesh)
    pm = make_sharded_train_step(pmodel, mesh)(
        pts, *shard_batch(x.numpy(), np.array([1, 4]), mesh))
    assert bool(torch.isfinite(pm["loss"])) and pts.step == 1, pm
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("ISOLATED-OK")
""")


# the CLI case also hides TensorBoard, which the GPU machine lacks too
CLI_BLOCKED = FORBIDDEN + ("tensorboard", "tensorboardX", "tensorflow")

CLI_SCRIPT = HOOK + textwrap.dedent("""
    import os
    import stgcn_tpu_torch.data
    from stgcn_tpu_torch.cli.train import main

    tmp = sys.argv[1]
    assert main(["--data.synthetic", "true", "--train.epochs", "1",
                 "--data.batch_size", "64", "--data.collate_mode", "fixed",
                 "--data.fixed_len", "16", "--model.num_layers", "9",
                 "--train.device", "cpu",
                 "--train.checkpoint_dir", os.path.join(tmp, "ckpt"),
                 "--train.log_dir", os.path.join(tmp, "logs")]) == 0
    assert os.path.exists(os.path.join(tmp, "stgcn_synth", "metadata.csv"))
    assert os.path.exists(os.path.join(tmp, "logs", "val_loss.csv"))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("ISOLATED-OK")
""")


# the tools case hides matplotlib as well, which the GPU machine lacks
TOOLS_BLOCKED = FORBIDDEN + ("matplotlib",)

TOOLS_SCRIPT = HOOK + textwrap.dedent("""
    import importlib
    import os
    import pkgutil

    import numpy as np
    import stgcn_tpu_torch

    for info in pkgutil.walk_packages(stgcn_tpu_torch.__path__,
                                      "stgcn_tpu_torch."):
        importlib.import_module(info.name)

    from stgcn_tpu_torch.cli import evaluate
    from stgcn_tpu_torch.data import generate_dataset
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.checkpoint import save_checkpoint
    from stgcn_tpu_torch.training.config import (model_config_from,
                                                 parse_config)
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state
    from stgcn_tpu_torch.utils import visualize

    tmp = sys.argv[1]
    meta = generate_dataset(os.path.join(tmp, "data"), num_subjects=5)
    flags = ["--data.metadata_file", meta, "--data.dataset_dir",
             os.path.join(tmp, "data"), "--data.collate_mode", "fixed",
             "--data.fixed_len", "16", "--model.num_layers", "9",
             "--train.device", "cpu"]
    model = STGCN(model_config_from(parse_config(flags)))
    ts = create_train_state(model, adam(1e-3), device="cpu")
    save_checkpoint(os.path.join(tmp, "ckpt_0"), ts, {{"step": 0}})
    assert evaluate.main(flags + ["--checkpoint",
                                  os.path.join(tmp, "ckpt_0")]) == 0
    try:
        visualize.render_sequence_frames(np.zeros((1, 25, 2)), tmp)
    except ImportError as e:
        assert "matplotlib" in str(e), e
    else:
        raise AssertionError("drew without matplotlib")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("ISOLATED-OK")
""")


# the measurement tools: bench_torch.py's whole run at a tiny size, and
# every scripts/torch_*.py imported
BENCH_SCRIPT = HOOK + textwrap.dedent("""
    import importlib
    import os

    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "scripts")]
    import bench_torch

    assert bench_torch.main(["--device", "cpu", "--batch", "2", "--frames",
                             "16", "--steps", "1"]) == 0
    for name in {scripts!r}:
        importlib.import_module(name)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("ISOLATED-OK")
""")


def run_isolated(script: str, *args: str, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    res = subprocess.run([sys.executable, "-c", script, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout


def test_port_serves_without_jax_or_the_jax_package():
    run_isolated(SCRIPT.format(forbidden=FORBIDDEN))


def test_cli_trains_without_jax_pandas_or_tensorboard(tmp_path):
    # two torch threads: the tier-1 suite runs six workers at once
    run_isolated(CLI_SCRIPT.format(forbidden=CLI_BLOCKED), str(tmp_path),
                 env_extra={"TMPDIR": str(tmp_path),
                            "OMP_NUM_THREADS": "2"})


def test_tools_run_without_jax_pandas_or_matplotlib(tmp_path):
    run_isolated(TOOLS_SCRIPT.format(forbidden=TOOLS_BLOCKED), str(tmp_path),
                 env_extra={"OMP_NUM_THREADS": "2"})


def test_bench_tools_run_without_jax_pandas_or_matplotlib():
    scripts = [p.stem for p in TOOL_FILES if p.parent.name == "scripts"]
    run_isolated(BENCH_SCRIPT.format(forbidden=TOOLS_BLOCKED,
                                     scripts=scripts),
                 env_extra={"OMP_NUM_THREADS": "2"})


def imported_roots(path: Path, lazy: bool = True) -> set[str]:
    """The top-level packages ``path`` imports; without ``lazy``, only
    those imported outside function bodies (when the module loads)."""
    tree = ast.parse(path.read_text(), str(path))
    nodes = ast.walk(tree)
    if not lazy:
        functions = (ast.FunctionDef, ast.AsyncFunctionDef)
        inner = {id(n) for f in ast.walk(tree) if isinstance(f, functions)
                 for n in ast.walk(f)}
        nodes = [n for n in ast.walk(tree) if id(n) not in inner]
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_torch_numpy_and_stdlib(path):
    # matplotlib only inside the functions that draw: the GPU machine
    # lacks it, and the tools case above runs without it
    allowed = {"torch", "numpy", "stgcn_tpu_torch"} | LOCAL_MODULES
    third_party = {r for r in imported_roots(path)
                   if r not in sys.stdlib_module_names}
    assert third_party <= allowed | {"matplotlib"}, third_party - allowed
    at_load = {r for r in imported_roots(path, lazy=False)
               if r not in sys.stdlib_module_names}
    assert at_load <= allowed, at_load - allowed


def test_agcn_reference_stands_alone():
    """The benchmark's plain 2s-AGCN imports no JAX, nothing of the JAX
    package and nothing of the port: torch, numpy and the standard library
    only."""
    path = ROOT / "stgcn_bench" / "reference" / "agcn.py"
    roots = {r for r in imported_roots(path)
             if r not in sys.stdlib_module_names}
    assert roots <= {"torch", "numpy"}, roots
    assert not roots & (set(FORBIDDEN) | {"stgcn_tpu_torch", "stgcn_bench"})
