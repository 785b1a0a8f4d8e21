"""Reads the checkpoints that the JAX package's orbax writes
(auformer/core/checkpointing.py::save_checkpoint), without orbax,
tensorstore or zstandard.

A checkpoint directory holds ``_METADATA`` (JSON: each leaf's key path in
``tree_metadata``, ``use_ocdbt``, ``use_zarr3``) and the leaves as zarr v2
arrays: under an OCDBT database (core/ocdbt.py) at the keys
``<name>/.zarray`` and ``<name>/<chunk>``, or with ``use_ocdbt: false``
each in its directory ``<name>/``, where ``<name>`` joins the leaf's keys
with ``.``. A chunk is zstd-compressed (data/native's decoder) or stored
raw, in C order; an absent chunk holds ``fill_value``. The tree's shape
comes from ``key_metadata``, never from splitting a name on ``.``.

:func:`read_orbax_checkpoint` returns the nested dict that orbax's
``restore`` returns: numpy arrays, ``torch.bfloat16`` tensors for
bfloat16 leaves (numpy has no bfloat16) and Python numbers for the leaves
that orbax saved as scalars. Zarr v3, a compressor other than
zstd, filters or Fortran order raise ValueError naming what they met.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from ..data.native import zstd_decompress, zstd_decompress_into
from .ocdbt import OcdbtReader

#: zarr v2 dtype -> numpy dtype (bfloat16 is read as its uint16 bits)
DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16,
          "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8,
          "|b1": np.bool_, "bfloat16": np.uint16}


def _fill(meta: dict):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):          # "NaN", "Infinity", "-Infinity"
        return float(value.replace("Infinity", "inf"))
    return value


def read_zarr_array(get: Callable[[str], bytes | None], name: str):
    """The zarr v2 array ``name``; ``get(key)`` returns the bytes stored at
    ``<name>/<key>`` or None."""
    raw = get(".zarray")
    if raw is None:
        raise ValueError(f"{name}: no .zarray (a zarr v3 array, or none)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, "
                         "not 2")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{name}: unsupported dtype {meta['dtype']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor "
                         f"{compressor.get('id')!r}")
    if meta.get("filters"):
        raise ValueError(f"{name}: unsupported filters "
                         f"{[f.get('id') for f in meta['filters']]}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: unsupported order {meta['order']!r}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{name}: dimension separator {sep!r}")
    dtype = np.dtype(DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    out = np.empty(shape, dtype)
    fill = _fill(meta)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        data = get(sep.join(map(str, idx)) if idx else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if data is None:
            out[region] = fill
            continue
        if chunks == shape and compressor is not None:     # one chunk
            n = zstd_decompress_into(data, out)
        else:
            if compressor is not None:
                data = zstd_decompress(data)
            n = len(data)
            if n == chunk_bytes:
                block = np.frombuffer(data, dtype).reshape(chunks)
                out[region] = block[tuple(slice(0, r.stop - r.start)
                                          for r in region)]
        if n != chunk_bytes:
            raise ValueError(f"{name}: chunk {idx} holds {n} bytes, "
                             f"expected {chunk_bytes}")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _keys(flat: str, entry: dict) -> list[str]:
    keys = [str(k["key"]) for k in entry.get("key_metadata") or []]
    if not keys:
        raise ValueError(f"_METADATA: {flat} has no key_metadata")
    return keys


def read_orbax_checkpoint(path: str) -> dict[str, Any]:
    """The tree that orbax saved at ``path`` (a directory with
    ``_METADATA``), every leaf read."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: no _METADATA, not an orbax checkpoint")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays are not supported (this "
                         "reader reads zarr v2, orbax's default)")
    if meta.get("use_ocdbt", False):
        db = OcdbtReader(path)
        entries = dict(db.items())

        def getter(name):
            def get(key):
                value = entries.get(f"{name}/{key}".encode())
                return None if value is None else db.value(value)
            return get
    else:
        def getter(name):
            def get(key):
                file = os.path.join(path, name, *key.split("/"))
                if not os.path.isfile(file):
                    return None
                with open(file, "rb") as f:
                    return f.read()
            return get
    tree: dict = {}
    for flat, entry in meta.get("tree_metadata", {}).items():
        keys = _keys(flat, entry)
        value_meta = entry.get("value_metadata") or {}
        if value_meta.get("skip_deserialize"):
            continue
        name = ".".join(map(str, keys))
        value = read_zarr_array(getter(name), name)
        if value_meta.get("value_type") == "scalar":    # a Python number
            value = value.item()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree
