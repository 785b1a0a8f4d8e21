"""Submission postprocess (counterpart of auformer/postprocess.py; reference
postprocess/postprocess.py).

Predictions exist only for frames with a detected, cropped face; the
challenge wants one row per frame of the original video. ``nearest_interp``
expands the rows of the detected frames to the whole video by repeating the
nearest previous detected frame (postprocess.py:29-48), and
``expand_predictions`` rewrites the per-task txts (postprocess.py:51-89),
with explicit paths in place of the reference's hardcoded drives.

Frame counts come from each video's meta.json side file, or from its
container where it has none (``data/video.py``: the index of an MP4, AVI
or Matroska file; the head and the tail of an ASF file (.wmv) or an MPEG
program stream (.mpg, .mpeg), as ffmpeg's open reads them), which then
writes the side file, as the JAX package's ``Video(path, write=True)``
does.

    python -m auformer_torch.postprocess --predictions results \
        --frames_root <cropped_aligned> --video_dir <videos> --tasks au
"""
from __future__ import annotations

import glob
import os

from .data.split import natsort_key
from .data.testset import strip_position
from .data.utils import find_all_video_files
from .data.video import Video


def nearest_interp(source_list: list[int], target_len: int) -> list[int]:
    """Map each of ``target_len`` frames to an index into ``source_list``:
    the nearest previous detected frame (reference postprocess.py:29-48)."""
    source_list = sorted(source_list)
    n = len(source_list)
    if target_len <= n:
        return list(range(n))
    out: list[int] = []
    index = 0
    while index + 1 < n and len(out) < target_len:
        out.extend([index] * (source_list[index + 1] - source_list[index]))
        index += 1
    out = out[:target_len]
    out.extend([index] * (target_len - len(out)))
    return out


def video_frame_counts(video_dir: str) -> dict[str, int]:
    """Video name -> frame count of every video under ``video_dir``, from
    its meta.json side file or its container (auformer/postprocess.py:
    38-47). The reference pickles the same table (postprocess.py:17-28)."""
    counts: dict[str, int] = {}
    for path in find_all_video_files(video_dir):
        counts[os.path.splitext(os.path.basename(path))[0]] = \
            Video(path, write=True).num_frames
    return counts


def expand_predictions(prediction_path: str, frames_root: str,
                       video_frame_counts: dict[str, int],
                       out_dir: str = "prediction_new",
                       tasks=("AU", "EXPR", "VA")) -> None:
    """Rewrite sparse per-video prediction txts as dense full-length ones.

    prediction_path/<task>/<video>.txt   header + one row per detected frame
    frames_root/<video>/                 cropped-aligned jpgs (detected ids)
    video_frame_counts                   frames of each original video
    """
    for task in tasks:
        for pf in glob.glob(os.path.join(prediction_path, task, "*.txt")):
            aligned_name = os.path.splitext(os.path.basename(pf))[0]
            n_frame = video_frame_counts[strip_position(aligned_name)]
            frame_dir = os.path.join(frames_root, aligned_name)
            frames = sorted((f for f in os.listdir(frame_dir)
                             if f.endswith(".jpg")), key=natsort_key)
            frames = [int(f.split(".")[0]) for f in frames]
            with open(pf) as f:
                pred = f.readlines()
            if len(frames) != len(pred) - 1:
                raise ValueError(f"{pf}: {len(pred) - 1} rows for "
                                 f"{len(frames)} detected frames")
            os.makedirs(os.path.join(out_dir, task), exist_ok=True)
            indices = nearest_interp(frames, n_frame)
            with open(os.path.join(out_dir, task, os.path.basename(pf)),
                      "w") as nf:
                nf.write(pred[0])
                for i in range(n_frame):
                    nf.write(pred[indices[i] + 1])


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        description="expand sparse predictions to full video length")
    p.add_argument("--predictions", required=True,
                   help="dir with <task>/<video>.txt sparse files")
    p.add_argument("--frames_root", required=True,
                   help="cropped-aligned frame dirs (detected frame ids)")
    p.add_argument("--video_dir", required=True,
                   help="original videos (meta.json side files are read, "
                   "or written from the container)")
    p.add_argument("--out_dir", default="prediction_new")
    p.add_argument("--tasks", nargs="+", default=["AU", "EXPR", "VA"])
    args = p.parse_args(argv)
    expand_predictions(args.predictions, args.frames_root,
                       video_frame_counts(args.video_dir), args.out_dir,
                       tuple(args.tasks))


if __name__ == "__main__":
    main()
