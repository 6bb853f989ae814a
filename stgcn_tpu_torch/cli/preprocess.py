"""Data preprocessing CLI (port of ``stgcn_tpu/cli/preprocess.py``):
OpenPose ingestion, the distance precompute, QA, synthetic generation and
skeleton rendering, on the port's ``data`` and ``utils.visualize``.

Counterpart of the reference's offline pipeline (src/data/process_openpose.py,
src/data/calculate_distances.py, openpose_from_kth.sh and the plot_skeleton
helper in src/data/util.py).

Usage::

    python -m stgcn_tpu_torch.cli.preprocess openpose --keypoints DIR --out DIR
    python -m stgcn_tpu_torch.cli.preprocess distances --data DIR --out d.npy
    python -m stgcn_tpu_torch.cli.preprocess check --videos DIR --keypoints DIR
    python -m stgcn_tpu_torch.cli.preprocess reprocess --keypoints DIR
    python -m stgcn_tpu_torch.cli.preprocess synthetic --out DIR [--subjects N]
    python -m stgcn_tpu_torch.cli.preprocess render --npy seq.npy --out v.mp4
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="stgcn_tpu_torch data "
                                                 "preprocessing")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("openpose", help="JSON keypoints -> npy + metadata.csv")
    p.add_argument("--keypoints", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("distances", help="gravity-center distance precompute")
    p.add_argument("--data", required=True, help="directory of .npy sequences")
    p.add_argument("--out", required=True, help="output .npy file")

    p = sub.add_parser("check", help="verify every video has keypoints")
    p.add_argument("--videos", required=True)
    p.add_argument("--keypoints", required=True)

    p = sub.add_parser("reprocess", help="find videos with long missing runs")
    p.add_argument("--keypoints", required=True)
    p.add_argument("--max-missing", type=int, default=30)

    p = sub.add_parser("synthetic", help="generate a synthetic KTH-format set")
    p.add_argument("--out", required=True)
    p.add_argument("--subjects", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("render", help="render a skeleton sequence to video")
    p.add_argument("--npy", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--max-frames", type=int, default=150)

    args = parser.parse_args(argv)

    if args.cmd == "openpose":
        from stgcn_tpu_torch.data.openpose import process_openpose
        print(f"wrote {process_openpose(args.keypoints, args.out)}")
    elif args.cmd == "distances":
        from stgcn_tpu_torch.data.distances import (
            calculate_distances_from_dir,
        )
        d = calculate_distances_from_dir(args.data, args.out)
        print(f"wrote {args.out} (mean dist {d.mean():.2f})")
    elif args.cmd == "check":
        from stgcn_tpu_torch.data.openpose import check_all_videos_processed
        n = check_all_videos_processed(args.videos, args.keypoints)
        print(f"all {n} videos processed")
    elif args.cmd == "reprocess":
        from stgcn_tpu_torch.data.openpose import videos_to_reprocess
        redo = videos_to_reprocess(args.keypoints, args.max_missing)
        print("\n".join(redo) if redo else "nothing to reprocess")
    elif args.cmd == "synthetic":
        from stgcn_tpu_torch.data.synthetic import generate_dataset
        meta = generate_dataset(args.out, num_subjects=args.subjects,
                                seed=args.seed)
        print(f"wrote {meta}")
    elif args.cmd == "render":
        from stgcn_tpu_torch.utils.visualize import save_skeleton_video
        seq = np.load(args.npy)[:args.max_frames]
        print(f"wrote {save_skeleton_video(seq, args.out, fps=args.fps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
