"""A reader of OCDBT databases (tensorstore's "Optionally-Cooperative
Distributed B+Tree"), the key-value store under the JAX package's orbax
checkpoints (auformer/core/checkpointing.py), without tensorstore.

A database is a directory: ``manifest.ocdbt`` holds the configuration, the
newest versions inline and references to the version tree; data files
(``d/<id>``, and ``ocdbt.process_<i>/d/<id>`` under the sub-databases that
an orbax save writes, one per process) hold b+tree nodes, version-tree
nodes and values. Each encoded manifest or node is

    magic (u32 big-endian), length (u64 little-endian, the whole encoding),
    format version (varint, 0), compression (varint: 0 none, 1 zstd),
    body (a zstd frame when compressed), CRC-32C of all before (u32 LE)

and its body is column-major: each field of all entries in turn. Data
files are named through a table at the head of each body, prefix-coded,
with each name's base path (the sub-database it lies in) prepended to the
names that a node read from it holds. A b+tree node holds its keys
prefix-coded against the previous key, relative to the prefixes of the
interior entries above it. A value lies inline in its leaf or in a data
file at an offset. :class:`OcdbtReader` reads the newest version's tree:
``list()`` and ``read(key)``; ``versions()`` walks the version tree as
well. Every encoding's CRC-32C is verified; an unknown format version,
compression or manifest kind raises ValueError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

from ..data.native import crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1          # offset and length of an empty tree's root


class _Body:
    """A decoded body, read front to back; every read bounds-checked."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u32le(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64le(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")
        if value > _MISSING:
            raise ValueError(f"{self.what}: varint past 64 bits")
        return value

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def decode_encoding(data: bytes, magic: int, what: str) -> _Body:
    """Check the header and CRC-32C of an encoded manifest or node and
    return its (decompressed) body."""
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(data)} bytes is too short")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise ValueError(f"{what}: its header says {length} bytes, "
                         f"{len(data)} were read")
    crc = int.from_bytes(data[-4:], "little")
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Body(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: unknown format version {version}")
    compression = head.varint()
    rest = head.data[head.pos:]
    if compression == 0:
        return _Body(rest, what)
    if compression == 1:
        return _Body(zstd_decompress(rest), what)
    raise ValueError(f"{what}: unknown compression id {compression}")


@dataclass(frozen=True)
class DataFile:
    base_path: str        # the sub-database it lies in ("" at the root)
    relative_path: str

    @property
    def path(self) -> str:
        return self.base_path + self.relative_path


@dataclass(frozen=True)
class Location:
    file: DataFile
    offset: int
    length: int


@dataclass(frozen=True)
class Config:
    uuid: str
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: dict | None   # {"id": "zstd", "level": n} or None


@dataclass(frozen=True)
class Version:
    generation_number: int
    root_height: int
    root: Location | None      # None: an empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


def _data_files(body: _Body, base_path: str) -> list[DataFile]:
    n = body.varint()
    prefix = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    base = body.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{body.what}: data file prefix too long")
        path = prev[:prefix[i]] + body.take(suffix[i])
        if base[i] > len(path):
            raise ValueError(f"{body.what}: data file base path too long")
        files.append(DataFile(base_path + path[:base[i]].decode(),
                              path[base[i]:].decode()))
        prev = path
    return files


def _locations(body: _Body, n: int, files: list[DataFile]
               ) -> list[Location | None]:
    ids, offsets, lengths = (body.varints(n), body.varints(n),
                             body.varints(n))
    out = []
    for i, off, ln in zip(ids, offsets, lengths):
        if i >= len(files):
            raise ValueError(f"{body.what}: data file {i} of {len(files)}")
        missing = off == _MISSING and ln == _MISSING
        out.append(None if missing else Location(files[i], off, ln))
    return out


def _version_leaf(body: _Body, files: list[DataFile]) -> list[Version]:
    n = body.varint()
    gens = body.varints(n)
    heights = [body.byte() for _ in range(n)]
    roots = _locations(body, n, files)
    keys, tree, indirect = (body.varints(n), body.varints(n),
                            body.varints(n))
    times = [body.u64le() for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, keys, tree,
                                     indirect, times)]


def _version_interior(body: _Body, files: list[DataFile], heights=None
                      ) -> list[tuple[int, Location, int]]:
    """(height, location, num_generations) of each child; the manifest
    lists heights, a version node's children are one below it."""
    n = body.varint()
    body.varints(n)                       # generation numbers
    locs = _locations(body, n, files)
    counts = body.varints(n)
    [body.u64le() for _ in range(n)]      # commit times
    if heights is None:
        heights = [body.byte() for _ in range(n)]
    else:
        heights = [heights] * n
    return list(zip(heights, locs, counts))


def _keys(body: _Body, n: int, interior: bool
          ) -> tuple[list[bytes], list[int]]:
    prefix = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    common = body.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{body.what}: key prefix too long")
        prev = prev[:prefix[i]] + body.take(suffix[i])
        if common[i] > len(prev):
            raise ValueError(f"{body.what}: subtree prefix too long")
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class _Child:
    key: bytes            # the subtree's first key, relative to the node's
    common: int           # bytes of `key` that every key below shares
    location: Location


class OcdbtReader:
    """The OCDBT database in ``directory``, as of its newest version."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        data = self._file("manifest.ocdbt")
        body = decode_encoding(data, MANIFEST_MAGIC, "OCDBT manifest")
        uuid = body.take(16).hex()
        kind = body.varint()
        inline, node_bytes = body.varint(), body.varint()
        arity = body.byte()
        method = body.varint()
        if method == 0:
            compression = None
        elif method == 1:
            level = int.from_bytes(body.take(4), "little", signed=True)
            compression = {"id": "zstd", "level": level}
        else:
            raise ValueError(f"OCDBT manifest: unknown compression id "
                             f"{method} in the config")
        self.config = Config(uuid, kind, inline, node_bytes, arity,
                             compression)
        if kind != 0:
            raise ValueError(f"OCDBT manifest kind {kind} (numbered "
                             "manifests) is not supported")
        files = _data_files(body, "")
        self._versions = _version_leaf(body, files)
        self._version_nodes = _version_interior(body, files, heights=None)
        body.done()
        if not self._versions:
            raise ValueError("OCDBT manifest without a version")
        self.version = max(self._versions,
                           key=lambda v: v.generation_number)

    # -- files ----------------------------------------------------------------
    def _file(self, relative: str, offset: int = 0,
              length: int | None = None) -> bytes:
        path = os.path.normpath(os.path.join(self.directory, relative))
        if not path.startswith(self.directory + os.sep):
            raise ValueError(f"OCDBT data file {relative!r} lies outside "
                             f"{self.directory}")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(-1 if length is None else length)
        if length is not None and len(data) != length:
            raise ValueError(f"OCDBT data file {relative}: {length} bytes at "
                             f"{offset} asked, {len(data)} there")
        return data

    def _read(self, loc: Location) -> bytes:
        return self._file(loc.file.path, loc.offset, loc.length)

    # -- version tree ---------------------------------------------------------
    def versions(self) -> list[Version]:
        """Every version the database keeps, oldest first: the manifest's
        and those of the version-tree nodes below it."""
        out = list(self._versions)
        stack = list(self._version_nodes)
        while stack:
            height, loc, _ = stack.pop()
            body = decode_encoding(self._read(loc), VERSION_MAGIC,
                                   f"OCDBT version node {loc.file.path}")
            body.byte()                              # arity log2
            node_height = body.byte()
            if node_height != height:
                raise ValueError(f"OCDBT version node of height "
                                 f"{node_height}, expected {height}")
            files = _data_files(body, loc.file.base_path)
            if height == 0:
                out += _version_leaf(body, files)
            else:
                stack += _version_interior(body, files, heights=height - 1)
            body.done()
        return sorted(out, key=lambda v: v.generation_number)

    # -- b+tree ---------------------------------------------------------------
    def _node(self, loc: Location, height: int):
        body = decode_encoding(self._read(loc), BTREE_MAGIC,
                               f"OCDBT b+tree node {loc.file.path}")
        node_height = body.byte()
        if node_height != height:
            raise ValueError(f"OCDBT b+tree node of height {node_height}, "
                             f"expected {height}")
        files = _data_files(body, loc.file.base_path)
        n = body.varint()
        keys, common = _keys(body, n, interior=height > 0)
        if height > 0:
            locs = _locations(body, n, files)
            for _ in range(3):                   # the subtrees' statistics
                body.varints(n)
            body.done()
            if any(loc is None for loc in locs):
                raise ValueError("OCDBT interior node without a child")
            return [_Child(k, c, l) for k, c, l in zip(keys, common, locs)]
        lengths = body.varints(n)
        kinds = [body.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise ValueError(f"OCDBT leaf: unknown value kind {max(kinds)}")
        indirect = [i for i in range(n) if kinds[i]]
        ids, offsets = (body.varints(len(indirect)),
                        body.varints(len(indirect)))
        values: list[bytes | Location] = [b""] * n
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                raise ValueError(f"OCDBT leaf: data file {fid} of "
                                 f"{len(files)}")
            values[i] = Location(files[fid], off, lengths[i])
        for i in range(n):
            if not kinds[i]:
                values[i] = body.take(lengths[i])
        body.done()
        return list(zip(keys, values))

    def _walk(self, loc: Location, height: int, prefix: bytes
              ) -> Iterator[tuple[bytes, bytes | Location]]:
        entries = self._node(loc, height)
        if height == 0:
            for key, value in entries:
                yield prefix + key, value
            return
        for child in entries:
            yield from self._walk(child.location, height - 1,
                                  prefix + child.key[:child.common])

    def items(self) -> Iterator[tuple[bytes, bytes | Location]]:
        """(key, inline value or the Location of an indirect one), in key
        order."""
        if self.version.root is None:
            return iter(())
        return self._walk(self.version.root, self.version.root_height, b"")

    def list(self) -> list[bytes]:
        """Every key, in order."""
        return [key for key, _ in self.items()]

    def value(self, value: bytes | Location) -> bytes:
        return value if isinstance(value, bytes) else self._read(value)

    def read_all(self) -> dict[bytes, bytes]:
        """Every key with its value."""
        return {key: self.value(v) for key, v in self.items()}

    def read(self, key: bytes | str) -> bytes | None:
        """The value of ``key``, or None where the database lacks it."""
        key = key.encode() if isinstance(key, str) else key
        loc, height = self.version.root, self.version.root_height
        if loc is None:
            return None
        while height > 0:
            children = self._node(loc, height)
            child = None
            for c in children:                    # the last first key <= key
                if c.key <= key:
                    child = c
                else:
                    break
            if child is None or not key.startswith(child.key[:child.common]):
                return None
            key = key[child.common:]
            loc, height = child.location, height - 1
        for k, value in self._node(loc, 0):
            if k == key:
                return self.value(value)
        return None
