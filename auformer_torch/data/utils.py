"""Small data utilities (counterpart of auformer/data/utils.py; reference
dataloader/utils.py:55-162)."""
from __future__ import annotations

import glob
import os

import numpy as np


def split_EX_VA_AU(inp: np.ndarray):
    """Column split of a stacked [EX(7) | VA(2) | AU(12)] label matrix
    (reference dataloader/utils.py:55-59)."""
    return inp[:, 0:7], inp[:, 7:9], inp[:, 9:]


def ex_from_one_hot(ex_arr: np.ndarray) -> np.ndarray:
    """(N, 7) one-hot -> (N,) class ids (reference utils.py:62-75)."""
    ex_arr = np.asarray(ex_arr)
    assert ex_arr.ndim == 2 and ex_arr.shape[1] == 7
    return np.argmax(ex_arr, axis=1).astype(np.int64)


def get_position(name: str) -> str:
    """_main/_left/_right suffix of multi-person video names
    (reference utils.py:109-118)."""
    for suf in ("_main", "_left", "_right"):
        if name.endswith(suf):
            return suf
    return ""


def find_all_files_with_ext_in(folder: str, ext: str) -> list[str]:
    pat = ext if ext.startswith(".") else "." + ext
    out = glob.glob(os.path.join(folder, "*" + pat))
    out.sort()
    return out


def get_filename(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def get_extension(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[1]


def get_path(path: str) -> str:
    return os.path.split(path)[0]


def convert_to_filenames(paths: list[str], sort_list: bool = True) -> list[str]:
    out = [get_filename(p) for p in paths]
    if sort_list:
        out.sort()
    return out


def solve_symlinks(paths: list[str]) -> list[str]:
    return [os.path.realpath(p) for p in paths]


IMAGE_EXTS = ("bmp", "jpg", "png", "jpeg", "tif", "tiff", "tga")


def find_all_image_files(folder: str) -> list[str]:
    out: list[str] = []
    for ext in IMAGE_EXTS:
        out += glob.glob(os.path.join(folder, "*." + ext))
        out += glob.glob(os.path.join(folder, "*." + ext.upper()))
    out.sort()
    return out


VIDEO_EXTS = ("avi", "mp4", "mkv", "mov", "wmv", "webm", "mpg", "mpeg")


def find_all_video_files(folder: str) -> list[str]:
    out: list[str] = []
    for ext in VIDEO_EXTS:
        out += glob.glob(os.path.join(folder, "*." + ext))
        out += glob.glob(os.path.join(folder, "*." + ext.upper()))
    out.sort()
    return out


def get_label_str2(data: dict) -> str:
    """Per-video split-membership suffix used by the processed-video naming
    scheme '001_AU1v_EX1__VA1v' (reference utils.py:150-162)."""
    labels = {"AU": "0_", "EX": "0_", "VA": "0_"}
    marks = {"train": "1_", "val": "1v", "test": "1t"}
    for task in data:
        split = data[task]["original_split"]
        if split in marks:
            labels[task] = marks[split]
    return ("_AU" + labels["AU"] + "_EX" + labels["EX"]
            + "_VA" + labels["VA"])
