"""OpenPose JSON keypoints -> per-video ``.npy`` + ``metadata.csv``.

The port's copy of ``stgcn_tpu/data/openpose.py`` without pandas
(counterpart of src/data/process_openpose.py:11-139): each video has one
JSON per frame; person 0's ``pose_keypoints_2d`` is reshaped to ``(25, 3)``,
person-less frames are skipped, and ``{subject}_{action}_{scenario}.npy``
is written.  ``metadata.csv`` is written with the ``csv`` module in the
columns, row order and quoting of the JAX package's ``DataFrame.to_csv``.
The QA helpers find videos without keypoints and long runs of missing
frames.
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path

import numpy as np

ACTIONS = ("boxing", "handclapping", "handwaving", "jogging", "running",
           "walking")
METADATA_COLUMNS = ("subject", "action", "scenario", "filename")
# OpenPose appends "_%012d_keypoints.json" (28 characters) to the video stem
_SUFFIX_LEN = 28


def _video_stems(action_dir: Path) -> list[str]:
    return sorted({f.name[:-_SUFFIX_LEN] for f in action_dir.glob("*.json")})


def frames_from_json(json_paths: list[Path]) -> tuple[np.ndarray, list[int]]:
    """Stack per-frame keypoints; returns ``(T, 25, 3)`` and the indices of
    the skipped (person-less) frames."""
    frames, skipped = [], []
    for i, p in enumerate(json_paths):
        with open(p) as f:
            data = json.load(f)
        people = data.get("people", [])
        if not people:
            skipped.append(i)
            continue
        kp = np.asarray(people[0]["pose_keypoints_2d"], np.float32)
        frames.append(kp.reshape(25, 3))
    if not frames:
        return np.zeros((0, 25, 3), np.float32), skipped
    return np.stack(frames), skipped


def process_openpose(keypoints_dir: str, output_dir: str,
                     actions: tuple[str, ...] = ACTIONS) -> str:
    """Ingest ``keypoints_dir/{action}/*.json`` into ``.npy`` files and
    ``metadata.csv`` under ``output_dir``; returns the CSV's path."""
    os.makedirs(output_dir, exist_ok=True)
    rows = []
    for action in actions:
        action_dir = Path(keypoints_dir) / action
        if not action_dir.is_dir():
            continue
        for stem in _video_stems(action_dir):
            seq, _ = frames_from_json(sorted(action_dir.glob(stem + "*.json")))
            subject, _, scenario, *_ = stem.split("_")
            fname = f"{subject}_{action}_{scenario}.npy"
            np.save(os.path.join(output_dir, fname), seq)
            rows.append((subject, action, scenario, fname))
    meta_path = os.path.join(output_dir, "metadata.csv")
    with open(meta_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(METADATA_COLUMNS)
        writer.writerows(rows)
    return meta_path


def check_all_videos_processed(videos_dir: str, keypoints_dir: str,
                               actions: tuple[str, ...] = ACTIONS) -> int:
    """Raise ``RuntimeError`` unless every ``.avi`` has keypoints; returns
    the number of videos."""
    count = 0
    for action in actions:
        vids = sorted(f[:-4] for f in os.listdir(os.path.join(videos_dir,
                                                              action))
                      if f.endswith(".avi"))
        missing = set(vids) - set(_video_stems(Path(keypoints_dir) / action))
        if missing:
            raise RuntimeError(f"{action}: unprocessed videos "
                               f"{sorted(missing)}")
        count += len(vids)
    return count


def videos_to_reprocess(keypoints_dir: str, max_missing_run: int = 30,
                        actions: tuple[str, ...] = ACTIONS) -> list[str]:
    """Videos with at least ``max_missing_run`` consecutive person-less
    frames, sorted."""
    redo = set()
    for action in actions:
        action_dir = Path(keypoints_dir) / action
        if not action_dir.is_dir():
            continue
        for stem in _video_stems(action_dir):
            _, skipped = frames_from_json(
                sorted(action_dir.glob(stem + "*.json")))
            longest = run = 0
            prev = None
            for i in skipped:
                run = run + 1 if prev == i - 1 else 1
                prev = i
                longest = max(longest, run)
            if longest >= max_missing_run:
                redo.add(stem)
    return sorted(redo)
