"""FrameStore: the native key-value record store for frames and labels
(counterpart of auformer/data/framestore.py, the same on-disk format, so
either package reads the other's stores).

Replaces the reference's five LMDB environments (aff2compdataset.py:26-39:
.croped_jpeg / .croped_mask / .label_au / .label_expr / .label_va) with a
simple append-only shard format purpose-built for this read pattern:
many small values (JPEG bytes, 12-byte labels) read by string key
(``"<video>/<frame>.jpg"``, create_lmdb.py:20-24).

Layout of a store directory::

    meta.json          {"format": "framestore-v1", "entries": N, "shards": k}
    index.bin          packed index: per entry u16 key_len | key utf-8 |
                       u16 shard | u64 offset | u32 length
    shard-00000.bin    concatenated values

Reads slice mmap'd shards: no per-get syscall, no transaction machinery;
the OS page cache does the caching. The
native reader (data/native) mmaps the same format and performs batched
JPEG decode off the GIL; this module is the pure-Python access path to the
raw values (labels, and the bytes of any key) with identical semantics.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Optional

_MAGIC = "framestore-v1"
_IDX = struct.Struct("<HQI")  # shard, offset, length (key_len prefixed)


class FrameStoreWriter:
    """Append-only writer. Keys may be written in any order; duplicate keys
    keep the last value (LMDB put semantics)."""

    def __init__(self, path: str, shard_size: int = 1 << 30):
        self.path = path
        self.shard_size = shard_size
        os.makedirs(path, exist_ok=True)
        self._entries: dict[str, tuple[int, int, int]] = {}
        self._shard_idx = 0
        self._shard_pos = 0
        self._shard_f = open(self._shard_path(0), "wb")

    def _shard_path(self, i: int) -> str:
        return os.path.join(self.path, f"shard-{i:05d}.bin")

    def put(self, key: str, value: bytes) -> None:
        if self._shard_pos + len(value) > self.shard_size and self._shard_pos:
            self._shard_f.close()
            self._shard_idx += 1
            self._shard_pos = 0
            self._shard_f = open(self._shard_path(self._shard_idx), "wb")
        self._entries[key] = (self._shard_idx, self._shard_pos, len(value))
        self._shard_f.write(value)
        self._shard_pos += len(value)

    def close(self) -> None:
        self._shard_f.close()
        with open(os.path.join(self.path, "index.bin"), "wb") as f:
            for key, (shard, off, length) in self._entries.items():
                kb = key.encode("utf-8")
                f.write(struct.pack("<H", len(kb)))
                f.write(kb)
                f.write(_IDX.pack(shard, off, length))
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump({"format": _MAGIC, "entries": len(self._entries),
                       "shards": self._shard_idx + 1}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameStore:
    """Read-only mmap'd store. ``get`` returns bytes or None (the reference
    swallows missing keys into black-frame / sentinel-label fallbacks,
    aff2compdataset.py:191-212,264-287)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != _MAGIC:
            raise ValueError(f"{path}: not a framestore")
        self._index: dict[str, tuple[int, int, int]] = {}
        with open(os.path.join(path, "index.bin"), "rb") as f:
            data = f.read()
        pos = 0
        n = len(data)
        while pos < n:
            (klen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            key = data[pos:pos + klen].decode("utf-8")
            pos += klen
            shard, off, length = _IDX.unpack_from(data, pos)
            pos += _IDX.size
            self._index[key] = (shard, off, length)
        self._mmaps: list[mmap.mmap] = []
        self._files = []
        for i in range(meta["shards"]):
            f = open(os.path.join(path, f"shard-{i:05d}.bin"), "rb")
            self._files.append(f)
            size = os.fstat(f.fileno()).st_size
            self._mmaps.append(
                mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
                if size else None)

    def get(self, key: str) -> Optional[bytes]:
        e = self._index.get(key)
        if e is None:
            return None
        shard, off, length = e
        return self._mmaps[shard][off:off + length]

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        for m in self._mmaps:
            if m is not None:
                m.close()
        for f in self._files:
            f.close()


def first_key(path: str) -> str:
    """The first key in the index of the store at ``path``; "" when the
    store is empty."""
    with open(os.path.join(path, "index.bin"), "rb") as f:
        head = f.read(2)
        if len(head) < 2:
            return ""
        return f.read(struct.unpack("<H", head)[0]).decode("utf-8")


def open_store(path: str) -> Optional[FrameStore]:
    """Optional-open like the reference's try/except lmdb.open
    (aff2compdataset.py:25-36)."""
    try:
        return FrameStore(path)
    except (OSError, ValueError):
        return None
