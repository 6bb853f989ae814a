"""What a run loads, where it writes, and its refusals: no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``stgcn_tpu`` in a run
or in the reference (nor ``stgcn_tpu_torch`` in the reference); no result
without a card; the data-parallel rendezvous under ``TMPDIR`` and gone
after the run."""

import json
import os
import shutil
import subprocess
import sys

from stgcn_bench import harness
from stgcn_bench.tests.conftest import REPO
from stgcn_bench.tests.small import correct, run, small_cell

PY = sys.executable


def _python(code, **kw):
    return subprocess.run([PY, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300, **kw)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [PY, str(REPO / "stgcn_bench" / "tests" / "cpu_run.py"),
         "train-kth-b64", "--small", "--trace"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    modules = json.loads(lines[-1].split(" ", 1)[1])
    assert "stgcn_tpu_torch" in modules
    assert not set(modules) & set(harness.FORBIDDEN)
    assert json.loads(lines[-2])["correct"] in (True, False)


def test_the_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys, json; sys.path.insert(0, '.');"
        "import stgcn_bench.reference.stgcn;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert out.returncode == 0, out.stderr
    modules = set(json.loads(out.stdout))
    assert not modules & {*harness.FORBIDDEN, "stgcn_tpu_torch"}


def test_the_guard_refuses_a_jax_module():
    for name in ("jax", "jaxlib.xla_client", "stgcn_tpu.models"):
        out = _python("import sys, types; sys.path.insert(0, '.');"
                      f"sys.modules[{name!r}] = types.ModuleType('m');"
                      "from stgcn_bench import harness;"
                      "harness.guard_modules()")
        assert out.returncode == 3 and name in out.stderr
    out = _python("import sys; sys.path.insert(0, '.');"
                  "import stgcn_tpu_torch; from stgcn_bench import harness;"
                  "harness.guard_modules()")
    assert out.returncode == 0, out.stderr


def test_no_result_without_a_card(tmp_path):
    """Without CUDA the run exits non-zero and prints nothing; in a
    directory that holds only BENCHMARK.json and the benchmark's files it
    does the same."""
    argv = [PY, "stgcn_bench/run.py", "--workload", "train-kth-b64",
            "--seed", "3000000000", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "stgcn_bench", tmp_path / "stgcn_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(argv, capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_rendezvous_under_tmpdir_and_removed(tmp_path, monkeypatch):
    from stgcn_bench.tests.test_stgcn_bench_faults import _ranks

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    made = []
    real = tempfile.mkdtemp

    def mkdtemp(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    out = run(small_cell("train-ntu-b256-dp4", f32=True), seconds=0.3,
              rank=0, rank_argv=_ranks(None))
    assert correct(out)
    assert made and all(p.startswith(str(tmp_path)) for p in made)
    assert not any(os.path.exists(p) for p in made)
