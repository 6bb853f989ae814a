"""The port's user tools, held against the JAX package's where it has them.

* ``data/openpose.py``: ``process_openpose`` on one JSON keypoint tree
  gives the JAX module's ``.npy`` bytes and ``metadata.csv`` bytes (pandas'
  ``to_csv`` there, the ``csv`` module here); ``videos_to_reprocess`` and
  ``check_all_videos_processed`` give its answers and errors.
* ``cli/report.py``: ``moving_average`` and ``read_metric_csv`` equal the
  JAX ones; ``curves`` and ``confusion`` draw (matplotlib is installed
  here), as do ``utils/visualize.py``'s frames and GIF.
* ``cli/evaluate.py``: a port checkpoint (``.npz``, which both packages
  read) evaluated by the port and by the JAX CLI on the op path at float32:
  loss within 1e-5, equal accuracy and confusion matrix; the same weights
  through ``--torch-checkpoint`` from the ``.pt`` the port's export wrote.
* ``cli/export.py``: the ``pt`` file read by the JAX ``import_state_dict``
  gives the JAX eval logits within 1e-5 of the port's; the ``pt2``
  program's probabilities equal the op-path ``Predictor``'s (1e-6), at two
  batch sizes with ``--dynamic-batch``, and a fixed one refuses another
  batch size; ``stablehlo`` is refused, naming ``pt2``.
* ``cli/preprocess.py``: ``synthetic`` and ``distances`` write what the JAX
  CLI writes.
* ``utils/benchmark.py``: ``device_time``'s call count and rotated
  arguments, ``tflops``.
"""

import json
import os

import numpy as np
import pytest
import torch

from stgcn_tpu.cli import evaluate as jax_evaluate
from stgcn_tpu.cli import preprocess as jax_preprocess
from stgcn_tpu.cli import report as jax_report
from stgcn_tpu.cli.train import build_datasets as jax_build_datasets
from stgcn_tpu.data import batches as jax_batches
from stgcn_tpu.data import openpose as jax_openpose
from stgcn_tpu.models.importer import import_state_dict
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training.checkpoint import restore_checkpoint as jax_restore
from stgcn_tpu.training.config import model_config_from as jax_model_config
from stgcn_tpu.training.config import parse_config as jax_parse_config
from stgcn_tpu.training.loop import Trainer as JaxTrainer
from stgcn_tpu.utils import benchmark as jax_benchmark
from stgcn_tpu_torch.cli import evaluate, export, preprocess, report
from stgcn_tpu_torch.data import generate_dataset, openpose
from stgcn_tpu_torch.models.stgcn import STGCN
from stgcn_tpu_torch.serving import Predictor
from stgcn_tpu_torch.training.checkpoint import save_checkpoint
from stgcn_tpu_torch.training.config import model_config_from, parse_config
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import create_train_state
from stgcn_tpu_torch.utils import benchmark, visualize
from stgcn_tpu_torch.utils.logging import CsvLogger

T = 16


# ---- OpenPose ingestion -----------------------------------------------------
def keypoint_tree(root, seed=0, videos=2, frames=12):
    """``root/keypoints/<action>/<stem>_<frame>_keypoints.json`` and empty
    ``root/videos/<action>/<stem>.avi``; some frames without a person."""
    rng = np.random.default_rng(seed)
    for action in openpose.ACTIONS:
        kdir = root / "keypoints" / action
        vdir = root / "videos" / action
        kdir.mkdir(parents=True)
        vdir.mkdir(parents=True)
        for v in range(videos):
            stem = f"person{v + 1:02d}_{action}_d{v + 2}_uncomp"
            (vdir / f"{stem}.avi").write_bytes(b"")
            for f in range(frames):
                people = [] if rng.random() < 0.3 else [{
                    "pose_keypoints_2d":
                        rng.uniform(0, 640, 75).astype(np.float32).tolist()}]
                (kdir / f"{stem}_{f:012d}_keypoints.json").write_text(
                    json.dumps({"version": 1.3, "people": people}))
    return root / "keypoints", root / "videos"


def test_process_openpose_writes_the_jax_files(tmp_path):
    kp, _ = keypoint_tree(tmp_path)
    got = openpose.process_openpose(str(kp), str(tmp_path / "port"))
    want = jax_openpose.process_openpose(str(kp), str(tmp_path / "jax"))
    assert open(got, "rb").read() == open(want, "rb").read()
    names = sorted(f for f in os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 1 + 2 * len(openpose.ACTIONS)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_frames_from_json_and_reprocess_and_check(tmp_path):
    kp, videos = keypoint_tree(tmp_path, seed=1, frames=20)
    paths = sorted((kp / "boxing").glob("*.json"))
    got, skipped = openpose.frames_from_json(paths)
    want, want_skipped = jax_openpose.frames_from_json(paths)
    np.testing.assert_array_equal(got, want)
    assert skipped == want_skipped and got.dtype == np.float32
    for run in (1, 2, 3, 30):
        assert openpose.videos_to_reprocess(str(kp), run) == \
            jax_openpose.videos_to_reprocess(str(kp), run)
    assert openpose.check_all_videos_processed(str(videos), str(kp)) == \
        jax_openpose.check_all_videos_processed(str(videos), str(kp)) == 12
    (videos / "walking" / "person09_walking_d1_uncomp.avi").write_bytes(b"")
    for mod in (openpose, jax_openpose):
        with pytest.raises(RuntimeError, match="walking: unprocessed"):
            mod.check_all_videos_processed(str(videos), str(kp))


def test_person_less_video_and_empty_tree(tmp_path):
    kdir = tmp_path / "kp" / "running"
    kdir.mkdir(parents=True)
    for f in range(3):
        (kdir / f"person03_running_d1_uncomp_{f:012d}_keypoints.json"
         ).write_text(json.dumps({"people": []}))
    for sub, mod in (("port", openpose), ("jax", jax_openpose)):
        mod.process_openpose(str(tmp_path / "kp"), str(tmp_path / sub))
    seq = np.load(tmp_path / "port" / "person03_running_d1.npy")
    assert seq.shape == (0, 25, 3)
    assert (tmp_path / "port" / "metadata.csv").read_bytes() == \
        (tmp_path / "jax" / "metadata.csv").read_bytes()


# ---- report and visualize ---------------------------------------------------
@pytest.mark.parametrize("n", [1, 4, 10, 50])
def test_moving_average_matches_jax(n):
    y = np.random.default_rng(n).normal(size=23)
    np.testing.assert_array_equal(report.moving_average(y, n),
                                  jax_report.moving_average(y, n))
    assert report.moving_average(np.zeros(0), n).shape == (0,)


def test_read_metric_csv_matches_jax(tmp_path):
    logger = CsvLogger(str(tmp_path))
    for step in range(5):
        logger.log("val_loss", step * 10, 1.0 / (step + 1))
    logger.close()
    headerless = tmp_path / "raw.csv"
    headerless.write_text("1.5,3,0.25\n2.5,4,0.5\n\n")
    for path in (tmp_path / "val_loss.csv", headerless):
        got = report.read_metric_csv(str(path))
        want = jax_report.read_metric_csv(str(path))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        report.read_metric_csv(str(tmp_path / "val_loss.csv"))[0],
        [0, 10, 20, 30, 40])


def test_report_and_visualize_draw(tmp_path, monkeypatch):
    csv_path = tmp_path / "a.csv"
    csv_path.write_text("Wall time,Step,Value\n" + "".join(
        f"0,{i},{np.sin(i)}\n" for i in range(30)))
    cm = tmp_path / "cm.npy"
    np.save(cm, np.arange(36).reshape(6, 6))
    assert report.main(["curves", "--csv", str(csv_path), "--label", "a",
                        "--out", str(tmp_path / "c.png")]) == 0
    assert report.main(["confusion", "--npy", str(cm), "--kth-labels",
                        "--out", str(tmp_path / "m.png")]) == 0
    seq = np.random.default_rng(0).uniform(0, 400, (3, 25, 3))
    frames = visualize.render_sequence_frames(seq[:, :, :2],
                                              str(tmp_path / "frames"))
    monkeypatch.setattr(visualize.shutil, "which", lambda name: None)
    gif = visualize.save_skeleton_video(seq, str(tmp_path / "v.mp4"), fps=5)
    assert gif == str(tmp_path / "v.gif")
    for path in [tmp_path / "c.png", tmp_path / "m.png", gif, *frames]:
        assert os.path.getsize(path) > 0
    assert len(frames) == 3


# ---- evaluate and export ----------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small synthetic dataset, the CLI flags for it and a port
    checkpoint of the 9-block model after two steps."""
    root = tmp_path_factory.mktemp("tools")
    meta = generate_dataset(str(root / "data"), num_subjects=5, seed=2)
    flags = ["--data.metadata_file", meta, "--data.dataset_dir",
             str(root / "data"), "--data.batch_size", "8",
             "--data.collate_mode", "fixed", "--data.fixed_len", str(T),
             "--model.num_layers", "9", "--model.residual", "true",
             "--train.device", "cpu"]
    model = STGCN(model_config_from(parse_config(flags)))
    ts = create_train_state(model, adam(1e-3), seed=0, device="cpu")
    step = make_train_step(model)
    rng = np.random.default_rng(0)
    for _ in range(2):
        step(ts, torch.from_numpy(rng.normal(0, 1, (8, T, 25, 2)).astype(
            np.float32)), torch.from_numpy(rng.integers(0, 6, 8)))
    base = str(root / "ckpt_2")
    save_checkpoint(base, ts, {"epoch": 1, "step": 2, "final": True})
    return dict(root=root, flags=flags, base=base, model=model)


def eval_line(text):
    return [line for line in text.splitlines()
            if line.startswith("[eval] split=")]


def test_evaluate_matches_the_jax_cli(trained, capsys):
    flags, base, root = trained["flags"], trained["base"], trained["root"]
    assert evaluate.main(flags + ["--checkpoint", base, "--save-confusion",
                                  str(root / "cm_port.npy")]) == 0
    port_out = capsys.readouterr().out
    assert jax_evaluate.main(flags + ["--checkpoint", base,
                                      "--save-confusion",
                                      str(root / "cm_jax.npy")]) == 0
    jax_out = capsys.readouterr().out
    assert f"[eval] restored {base}" in port_out
    assert eval_line(port_out) == eval_line(jax_out) != []
    np.testing.assert_array_equal(np.load(root / "cm_port.npy"),
                                  np.load(root / "cm_jax.npy"))

    got = evaluate.evaluate_checkpoint(parse_config(flags), checkpoint=base,
                                       device=torch.device("cpu"))
    jcfg = jax_parse_config(flags)
    test_ds = jax_build_datasets(jcfg)[2]
    jtrainer = JaxTrainer(JaxSTGCN(jax_model_config(jcfg)))
    state = jax_restore(base, jtrainer.init_state(),
                        skip_prefixes=("opt_state",))
    want = jtrainer.evaluate(state, jax_batches(test_ds, 8, mode="fixed",
                                                fixed_len=T))
    assert got["count"] == want["count"] == 24
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert got["acc"] == want["acc"]
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  np.asarray(want["confusion_matrix"]))


def test_torch_checkpoint_from_the_port_export(trained, capsys):
    flags, base, root = trained["flags"], trained["base"], trained["root"]
    pt = str(root / "exported.pt")
    assert export.main(flags + ["--checkpoint", base, "--out", pt]) == 0
    assert f"tensors to {pt} (pt)" in capsys.readouterr().out
    assert evaluate.main(flags + ["--torch-checkpoint", pt]) == 0
    assert f"[eval] imported torch state dict from {pt}" in \
        capsys.readouterr().out
    cfg = parse_config(flags)
    cpu = torch.device("cpu")
    via_pt = evaluate.evaluate_checkpoint(cfg, torch_checkpoint=pt,
                                          device=cpu)
    via_npz = evaluate.evaluate_checkpoint(cfg, checkpoint=base, device=cpu)
    assert abs(via_pt["loss"] - via_npz["loss"]) <= 1e-5
    assert via_pt["acc"] == via_npz["acc"]
    np.testing.assert_array_equal(via_pt["confusion_matrix"],
                                  via_npz["confusion_matrix"])


def test_export_pt_and_npz_load_in_jax(trained):
    flags, base, root = trained["flags"], trained["base"], trained["root"]
    sds = {}
    for fmt in ("pt", "npz"):
        out = str(root / f"weights.{fmt}")
        assert export.main(flags + ["--checkpoint", base, "--out", out]) == 0
        sds[fmt] = ({k: v.numpy() for k, v in torch.load(out).items()}
                    if fmt == "pt" else dict(np.load(out)))
    assert sds["pt"].keys() == sds["npz"].keys()
    for k in sds["pt"]:
        np.testing.assert_array_equal(sds["pt"][k], sds["npz"][k])
    model = trained["model"]
    params, state = import_state_dict(sds["pt"], num_blocks=9,
                                      num_partitions=model.num_partitions,
                                      residual=True)
    jmodel = JaxSTGCN(JaxConfig(plan=model.config.plan, residual=True,
                                adjacency_mode="reference"))
    x = np.random.default_rng(5).normal(0, 1, (3, T, 25, 2)).astype(
        np.float32)
    want, _ = jmodel.apply(params, state, x, train=False)
    port = STGCN(model.config)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in sds["pt"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_export_pt2_round_trip(trained, capsys):
    flags, base, root = trained["flags"], trained["base"], trained["root"]
    dyn, fixed = str(root / "dyn.pt2"), str(root / "fixed.pt2")
    assert export.main(flags + ["--checkpoint", base, "--out", dyn,
                                "--dynamic-batch", "--seq-len", str(T)]) == 0
    assert "op-path eval forward" in capsys.readouterr().out
    assert export.main(flags + ["--checkpoint", base, "--out", fixed,
                                "--format", "pt2", "--batch", "4",
                                "--seq-len", str(T)]) == 0
    cfg = model_config_from(parse_config(flags))
    pred = Predictor.from_checkpoint(base, cfg, use_fused=False,
                                     device="cpu")
    program = torch.export.load(dyn).module()
    rng = np.random.default_rng(6)
    for n in (3, 5):
        x = rng.normal(0, 1, (n, T, 25, 2)).astype(np.float32)
        with torch.no_grad():
            got = program(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, pred.predict_batch(x), rtol=1e-6,
                                   atol=1e-6)
    one = torch.export.load(fixed).module()
    with torch.no_grad():
        assert one(torch.zeros(4, T, 25, 2)).shape == (4, 6)
        with pytest.raises(Exception):
            one(torch.zeros(3, T, 25, 2))
    with pytest.raises(SystemExit, match="use --format pt2"):
        export.main(flags + ["--checkpoint", base, "--out",
                             str(root / "m.stablehlo")])


# ---- preprocess -------------------------------------------------------------
def test_preprocess_synthetic_and_distances_match_jax(tmp_path, capsys):
    for sub, main in (("port", preprocess.main), ("jax", jax_preprocess.main)):
        d = str(tmp_path / sub)
        assert main(["synthetic", "--out", d, "--subjects", "2", "--seed",
                     "1"]) == 0
        assert main(["distances", "--data", d, "--out",
                     str(tmp_path / f"{sub}.npy")]) == 0
    out = capsys.readouterr().out
    assert out.count("wrote") == 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"),
                                  np.load(tmp_path / "jax.npy"))


def test_preprocess_openpose_check_and_reprocess(tmp_path, capsys):
    kp, videos = keypoint_tree(tmp_path, seed=3)
    out = str(tmp_path / "npy")
    assert preprocess.main(["openpose", "--keypoints", str(kp), "--out",
                            out]) == 0
    assert preprocess.main(["check", "--videos", str(videos), "--keypoints",
                            str(kp)]) == 0
    assert preprocess.main(["reprocess", "--keypoints", str(kp),
                            "--max-missing", "100"]) == 0
    text = capsys.readouterr().out
    assert f"wrote {os.path.join(out, 'metadata.csv')}" in text
    assert "all 12 videos processed" in text
    assert "nothing to reprocess" in text


# ---- device timing ----------------------------------------------------------
def test_device_time_rotates_arguments_and_tflops():
    seen = []

    def fn(x, k):
        seen.append((float(x[0]), k))

    x = torch.zeros(4, dtype=torch.float64)
    seconds = benchmark.device_time(fn, x, 7, iters=5, distinct=3, warmup=2)
    assert seconds > 0 and len(seen) == 7
    assert [k for _, k in seen] == [7] * 7
    np.testing.assert_allclose([v for v, _ in seen[2:]],
                               [0, 1e-6, 2e-6, 0, 1e-6])
    assert benchmark.tflops(3e12, 1.5) == jax_benchmark.tflops(3e12, 1.5) \
        == 2.0
