"""HDF5 files in numpy and the standard library's ``zlib``: the reader of the
ACDC and Synapse trees, and a writer for synthetic ones.

The reader covers what h5py writes with its default settings (``libver``
"earliest"), which is what a real ACDC / SSL4MIS tree holds:

  * superblock version 0 or 1 (a user block before it included);
  * version-1 object headers, with continuation blocks;
  * groups stored as a symbol table: a version-1 B-tree of symbol nodes
    (SNOD) over a local heap of names;
  * simple and scalar dataspaces;
  * little-endian integers of 1, 2, 4 and 8 bytes and IEEE floats of 2, 4
    and 8 bytes;
  * data layout message version 3, contiguous, compact or chunked with a
    version-1 B-tree chunk index (edge chunks that overhang the dataset
    included);
  * the filter pipeline's deflate (1), shuffle (2) and fletcher32 (3, the
    checksum verified).

Anything else raises ``NotImplementedError`` naming the structure (the
superblock of ``libver="latest"``, version-2 object headers, layout version
4 chunk indexes, big-endian or string types, new-style groups, other
filters), so the reader never returns data it did not understand. A file
that is not HDF5, or is cut short, raises ``OSError``.

The writer writes superblock version 0 and contiguous datasets, which h5py
reads unchanged.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
#: small files written by h5py (gzip, gzip + shuffle with edge chunks,
#: contiguous) and ``fixtures.json``: each dataset's shape, dtype, sha256
FIXTURES = Path(__file__).resolve().parent / "h5_fixtures"

#: (exponent location, exponent size, mantissa location, mantissa size,
#: exponent bias) of the IEEE floats by byte size
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                6: "compound", 7: "reference", 8: "enum",
                9: "variable-length", 10: "array"}
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32"}


class _Bytes:
    """The file's bytes with its offset and length sizes."""

    def __init__(self, data: bytes, base: int, size_o: int, size_l: int):
        self.data = data
        self.base = base
        self.o = size_o
        self.l = size_l

    def uint(self, pos: int, n: int) -> int:
        if pos < 0 or pos + n > len(self.data):
            raise OSError(f"HDF5 structure at byte {pos} runs past the end "
                          f"of the file ({len(self.data)} bytes)")
        return int.from_bytes(self.data[pos:pos + n], "little")

    def addr(self, pos: int) -> int | None:
        """An address field (relative to the base address), made absolute;
        None for the undefined address."""
        v = self.uint(pos, self.o)
        return None if v == (1 << 8 * self.o) - 1 else self.base + v

    def length(self, pos: int) -> int:
        return self.uint(pos, self.l)

    def span(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > len(self.data):
            raise OSError(f"HDF5 data at byte {pos} (+{n}) runs past the end "
                          f"of the file ({len(self.data)} bytes)")
        return self.data[pos:pos + n]

    def signature(self, pos: int, sig: bytes, what: str) -> None:
        if self.span(pos, 4) != sig:
            raise OSError(f"expected the {what} signature {sig!r} at byte "
                          f"{pos}, found {self.span(pos, 4)!r}")


def _find_superblock(data: bytes) -> int:
    """The superblock's offset: 0, or a power of two from 512 on (a user
    block before it)."""
    pos = 0
    while pos + 8 <= len(data):
        if data[pos:pos + 8] == SIGNATURE:
            return pos
        pos = 512 if pos == 0 else 2 * pos
    raise OSError("not an HDF5 file (no superblock signature)")


def _u(b: bytes, pos: int, n: int) -> int:
    return int.from_bytes(b[pos:pos + n], "little")


def _object_messages(f: _Bytes, addr: int) -> list[tuple[int, int, bytes]]:
    """(type, flags, body) of every message of the version-1 object header
    at ``addr``, its continuation blocks included."""
    if f.span(addr, 4) == b"OHDR":
        raise NotImplementedError(
            f"object header version 2 at byte {addr} (written with "
            "libver='latest' or newer)")
    version = f.uint(addr, 1)
    if version != 1:
        raise NotImplementedError(f"object header version {version} at byte "
                                  f"{addr}")
    total = f.uint(addr + 2, 2)
    blocks = [(addr + 16, f.uint(addr + 8, 4))]
    messages = []
    while blocks and len(messages) < total:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and len(messages) < total:
            mtype, msize = f.uint(pos, 2), f.uint(pos + 2, 2)
            flags = f.uint(pos + 4, 1)
            body = f.span(pos + 8, msize)
            if mtype == 0x10:  # continuation
                blocks.append((f.addr(pos + 8), f.length(pos + 8 + f.o)))
            messages.append((mtype, flags, body))
            pos += 8 + msize
    return messages


def _group_members(f: _Bytes, messages) -> dict[str, int]:
    """{name: object header address} of a symbol-table group."""
    table = [b for t, _, b in messages if t == 0x11]
    if not table:
        kinds = {t for t, _, _ in messages}
        if kinds & {0x02, 0x06}:
            raise NotImplementedError(
                "new-style group (link messages, compact or dense link "
                "storage)")
        raise OSError("object is not a group (no symbol table message)")
    body = table[0]
    btree = f.base + _u(body, 0, f.o)
    heap = f.base + _u(body, f.o, f.o)
    f.signature(heap, b"HEAP", "local heap")
    heap_data = f.addr(heap + 8 + 2 * f.l)
    heap_size = f.length(heap + 8)

    def name_at(offset: int) -> str:
        if offset >= heap_size:
            raise OSError(f"name offset {offset} outside the local heap")
        seg = f.span(heap_data + offset, heap_size - offset)
        return seg[:seg.index(b"\0")].decode("utf-8")

    members: dict[str, int] = {}

    def walk(node: int) -> None:
        f.signature(node, b"TREE", "B-tree node")
        if f.uint(node + 4, 1) != 0:
            raise OSError(f"B-tree node at byte {node} is not a group node")
        level, used = f.uint(node + 5, 1), f.uint(node + 6, 2)
        pos = node + 8 + 2 * f.o + f.l  # past the siblings and key 0
        for _ in range(used):
            child = f.addr(pos)
            pos += f.o + f.l
            if level > 0:
                walk(child)
                continue
            f.signature(child, b"SNOD", "symbol table node")
            entry = child + 8
            for _ in range(f.uint(child + 6, 2)):
                members[name_at(f.length(entry))] = f.addr(entry + f.o)
                entry += 2 * f.o + 24

    walk(btree)
    return dict(sorted(members.items()))


class Dataset:
    """One dataset: ``shape``, ``dtype`` and a numpy read of the whole of it
    (``ds[()]``, ``ds[:]``, ``np.asarray(ds)``)."""

    def __init__(self, f: _Bytes, name: str, messages):
        self._f = f
        self.name = name
        by_type: dict[int, bytes] = {}
        for mtype, flags, body in messages:
            if mtype in (0x01, 0x03, 0x08, 0x0B) and flags & 0x02:
                raise NotImplementedError(
                    f"{name}: shared (committed) message of type {mtype:#x}")
            if mtype == 0x07:
                raise NotImplementedError(f"{name}: external data files")
            by_type.setdefault(mtype, body)
        for mtype, what in ((0x01, "dataspace"), (0x03, "datatype"),
                            (0x08, "data layout")):
            if mtype not in by_type:
                raise OSError(f"{name}: object has no {what} message")
        self.shape = self._dataspace(by_type[0x01])
        self.dtype = self._datatype(by_type[0x03])
        self._layout = self._parse_layout(by_type[0x08])
        self._filters = (self._pipeline(by_type[0x0B])
                         if 0x0B in by_type else [])
        self._fill = self._fill_value(by_type.get(0x05), by_type.get(0x04))

    # -- messages ---------------------------------------------------------
    def _dataspace(self, b: bytes) -> tuple[int, ...]:
        version, rank = b[0], b[1]
        if version == 1:
            start = 8
        elif version == 2:
            if b[3] == 2:
                raise NotImplementedError(f"{self.name}: null dataspace")
            start = 4
        else:
            raise NotImplementedError(
                f"{self.name}: dataspace message version {version}")
        size_l = self._f.l
        return tuple(_u(b, start + i * size_l, size_l) for i in range(rank))

    def _datatype(self, b: bytes) -> np.dtype:
        cls, bits, size = b[0] & 0x0F, _u(b, 1, 3), _u(b, 4, 4)
        if cls == 0:
            if bits & 0x01:
                raise NotImplementedError(f"{self.name}: big-endian integer")
            if (_u(b, 8, 2), _u(b, 10, 2)) != (0, 8 * size) \
                    or size not in (1, 2, 4, 8) or bits & 0x06:
                raise NotImplementedError(
                    f"{self.name}: integer of {size} bytes with a bit offset, "
                    "precision or padding numpy cannot hold")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            if bits & 0x41:
                raise NotImplementedError(
                    f"{self.name}: big-endian or VAX-order float")
            layout = (b[12], b[13], b[14], b[15], _u(b, 16, 4))
            if (size not in _IEEE or layout != _IEEE[size]
                    or (_u(b, 8, 2), _u(b, 10, 2)) != (0, 8 * size)
                    or (bits >> 8) & 0xFF != 8 * size - 1
                    or (bits >> 4) & 0x03 != 2 or bits & 0x0E):
                raise NotImplementedError(
                    f"{self.name}: float of {size} bytes that is not IEEE")
            return np.dtype(f"<f{size}")
        raise NotImplementedError(
            f"{self.name}: datatype class {cls} "
            f"({_CLASS_NAMES.get(cls, 'unknown')})")

    def _parse_layout(self, b: bytes) -> tuple:
        version, f = b[0], self._f
        if version != 3:
            raise NotImplementedError(
                f"{self.name}: data layout message version {version}"
                + (" (the chunk indexes of libver='latest')"
                   if version == 4 else ""))
        cls = b[1]
        if cls == 0:
            size = _u(b, 2, 2)
            return ("compact", b[4:4 + size])
        if cls == 1:
            raw = _u(b, 2, f.o)
            addr = None if raw == (1 << 8 * f.o) - 1 else f.base + raw
            return ("contiguous", addr, _u(b, 2 + f.o, f.l))
        if cls == 2:
            nd = b[2]
            raw = _u(b, 3, f.o)
            addr = None if raw == (1 << 8 * f.o) - 1 else f.base + raw
            dims = [_u(b, 3 + f.o + 4 * i, 4) for i in range(nd)]
            if dims[-1] != self.dtype.itemsize:
                raise OSError(f"{self.name}: chunk element size {dims[-1]} "
                              f"!= datatype size {self.dtype.itemsize}")
            return ("chunked", addr, tuple(dims[:-1]))
        raise NotImplementedError(f"{self.name}: data layout class {cls} "
                                  "(virtual dataset)")

    def _pipeline(self, b: bytes) -> list[tuple[int, tuple[int, ...]]]:
        version, count = b[0], b[1]
        if version not in (1, 2):
            raise NotImplementedError(
                f"{self.name}: filter pipeline message version {version}")
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = _u(b, pos, 2)
            if version == 1 or fid >= 256:
                name_len = _u(b, pos + 2, 2)
                pos += 2
            else:
                name_len = 0
            nvals = _u(b, pos + 4, 2)
            pos += 6
            name = b[pos:pos + name_len].split(b"\0")[0].decode(
                "ascii", "replace")
            pos += (-(-name_len // 8) * 8) if version == 1 else name_len
            vals = tuple(_u(b, pos + 4 * i, 4) for i in range(nvals))
            pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in _FILTERS:
                raise NotImplementedError(
                    f"{self.name}: filter {fid} ({name or 'unnamed'})")
            out.append((fid, vals))
        return out

    def _fill_value(self, new: bytes | None, old: bytes | None):
        value = b""
        if new is not None:
            version = new[0]
            if version in (1, 2):
                if version == 1 or new[3]:
                    size = _u(new, 4, 4)
                    value = new[8:8 + size]
            elif version == 3:
                if new[1] & 0x20:
                    size = _u(new, 2, 4)
                    value = new[6:6 + size]
            else:
                raise NotImplementedError(
                    f"{self.name}: fill value message version {version}")
        elif old is not None:
            size = _u(old, 0, 4)
            value = old[4:4 + size]
        if len(value) == self.dtype.itemsize:
            return np.frombuffer(value, self.dtype)[0]
        return 0

    # -- data -------------------------------------------------------------
    def _decode(self, raw: bytes, mask: int) -> bytes:
        """Undo the filters (in reverse order) the chunk went through."""
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, vals = self._filters[i]
            if fid == 1:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise OSError(f"{self.name}: corrupt deflate chunk "
                                  f"({e})") from e
            elif fid == 2:
                size = vals[0] if vals else self.dtype.itemsize
                n = len(raw) // size
                body = np.frombuffer(raw, np.uint8, n * size)
                raw = (body.reshape(size, n).T.tobytes()
                       + raw[n * size:])
            else:
                stored = int.from_bytes(raw[-4:], "little")
                raw = raw[:-4]
                if stored != fletcher32(raw):
                    raise OSError(f"{self.name}: fletcher32 checksum "
                                  "mismatch (corrupt chunk)")
        return raw

    def _chunks(self, node: int, rank: int):
        """(offsets, stored size, filter mask, address) of every chunk
        under the chunk B-tree node at ``node``."""
        f = self._f
        f.signature(node, b"TREE", "B-tree node")
        if f.uint(node + 4, 1) != 1:
            raise OSError(f"{self.name}: B-tree node at byte {node} is not a "
                          "chunk node")
        level, used = f.uint(node + 5, 1), f.uint(node + 6, 2)
        key = 8 + 8 * (rank + 1)
        pos = node + 8 + 2 * f.o
        for _ in range(used):
            child = f.addr(pos + key)
            if level > 0:
                yield from self._chunks(child, rank)
            else:
                offsets = tuple(f.uint(pos + 8 + 8 * d, 8)
                                for d in range(rank))
                yield offsets, f.uint(pos, 4), f.uint(pos + 4, 4), child
            pos += key + f.o

    def read(self) -> np.ndarray:
        kind, f = self._layout[0], self._f
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        if kind == "compact":
            raw = self._layout[1]
            if len(raw) != nbytes:
                raise OSError(f"{self.name}: compact data of {len(raw)} "
                              f"bytes for {nbytes}")
            return np.frombuffer(raw, self.dtype).reshape(self.shape).copy()
        if kind == "contiguous":
            addr = self._layout[1]
            if addr is None:
                return np.full(self.shape, self._fill, self.dtype)
            return np.frombuffer(f.span(addr, nbytes), self.dtype).reshape(
                self.shape).copy()
        _, addr, chunk = self._layout
        out = np.full(self.shape, self._fill, self.dtype)
        if addr is None:
            return out
        per_chunk = int(np.prod(chunk)) * self.dtype.itemsize
        for offsets, size, mask, caddr in self._chunks(addr, len(chunk)):
            if any(o % c or o >= s for o, c, s
                   in zip(offsets, chunk, self.shape)):
                raise OSError(f"{self.name}: chunk at {offsets} is not on "
                              f"the {chunk} grid of {self.shape}")
            raw = self._decode(f.span(caddr, size), mask)
            if len(raw) != per_chunk:
                raise OSError(f"{self.name}: chunk at {offsets} decodes to "
                              f"{len(raw)} bytes, not {per_chunk}")
            block = np.frombuffer(raw, self.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def __getitem__(self, key) -> np.ndarray:
        return self.read()[key]

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)


class File:
    """An HDF5 file opened for reading: ``keys()``, ``name in f`` and
    ``f[name]`` (a :class:`Dataset`) over the root group's members. The
    whole file is read when it is opened, so nothing stays open."""

    def __init__(self, path: str | os.PathLike):
        self.filename = os.fspath(path)
        with open(self.filename, "rb") as fh:
            data = fh.read()
        start = _find_superblock(data)
        version = data[start + 8] if len(data) > start + 8 else None
        if version not in (0, 1):
            raise NotImplementedError(
                f"superblock version {version} (written with libver="
                "'latest' or newer)")
        size_o, size_l = data[start + 13], data[start + 14]
        if size_o not in (2, 4, 8) or size_l not in (2, 4, 8):
            raise OSError(f"{self.filename}: offset / length sizes "
                          f"{size_o} / {size_l}")
        pos = start + 24 + (4 if version == 1 else 0)
        probe = _Bytes(data, 0, size_o, size_l)
        base = probe.uint(pos, size_o)
        self._f = _Bytes(data, base, size_o, size_l)
        root_entry = pos + 4 * size_o
        root = self._f.addr(root_entry + size_o)
        self._members = _group_members(self._f,
                                       _object_messages(self._f, root))

    def keys(self) -> list[str]:
        return list(self._members)

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def __getitem__(self, name: str) -> Dataset:
        if name not in self._members:
            raise KeyError(f"{name!r} not in {self.filename} (members: "
                           f"{self.keys()})")
        messages = _object_messages(self._f, self._members[name])
        if any(t == 0x11 for t, _, _ in messages):
            raise NotImplementedError(f"{name}: nested group")
        return Dataset(self._f, name, messages)


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 of ``data`` (H5_checksum_fletcher32: big-endian
    16-bit words, sums folded every 360 words)."""
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    s1 = s2 = 0
    for i in range(0, len(words), 360):
        prefix = np.cumsum(words[i:i + 360])
        s2 = (s2 + len(prefix) * s1 + int(prefix.sum())) & 0xFFFFFFFF
        s1 = (s1 + int(prefix[-1])) & 0xFFFFFFFF
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def array_sha256(a: np.ndarray) -> str:
    """sha256 of an array's little-endian C-order bytes."""
    a = np.asarray(a)
    return hashlib.sha256(np.array(a, a.dtype.newbyteorder("<"),
                                   order="C").tobytes()).hexdigest()


def check_fixtures(directory: str | os.PathLike = FIXTURES) -> list[dict]:
    """Read every dataset that ``fixtures.json`` lists with this reader:
    one row each, {file, dataset, shape, dtype, sha256, ok} (``ok``: the
    shape, dtype and hash are those listed)."""
    directory = Path(directory)
    listed = json.loads((directory / "fixtures.json").read_text())
    rows = []
    for fname, datasets in listed["files"].items():
        f = File(directory / fname)
        for name, want in datasets.items():
            a = f[name][()]
            row = {"file": fname, "dataset": name, "shape": list(a.shape),
                   "dtype": str(a.dtype), "sha256": array_sha256(a)}
            row["ok"] = all(row[k] == want[k]
                            for k in ("shape", "dtype", "sha256"))
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_UNDEF = b"\xff" * 8
#: symbols a symbol node holds (2 x the superblock's group leaf node K, 4)
_SNOD_SLOTS = 8
#: children a group B-tree node holds (2 x the group internal node K, 16)
_TREE_SLOTS = 32


def _q(v: int) -> bytes:
    return int(v).to_bytes(8, "little")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return (mtype.to_bytes(2, "little") + len(body).to_bytes(2, "little")
            + bytes([flags, 0, 0, 0]) + body)


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return (bytes([1, 0]) + len(messages).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + len(body).to_bytes(4, "little")
            + b"\0" * 4 + body)


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return _message(0x03, bytes([0x10, 0x08 if dtype.kind == "i" else 0,
                                     0, 0]) + size.to_bytes(4, "little")
                        + (0).to_bytes(2, "little")
                        + (8 * size).to_bytes(2, "little"), flags=1)
    if dtype.kind == "f" and size in _IEEE:
        eloc, esize, mloc, msize, bias = _IEEE[size]
        return _message(0x03, bytes([0x11, 0x20, 8 * size - 1, 0])
                        + size.to_bytes(4, "little")
                        + (0).to_bytes(2, "little")
                        + (8 * size).to_bytes(2, "little")
                        + bytes([eloc, esize, mloc, msize])
                        + bias.to_bytes(4, "little"), flags=1)
    raise NotImplementedError(f"the writer does not write dtype {dtype}")


def _dataset_header(a: np.ndarray, addr: int | None) -> bytes:
    space = (bytes([1, a.ndim, 1 if a.ndim else 0, 0]) + b"\0" * 4
             + b"".join(_q(d) for d in a.shape) * 2)
    fill = bytes([2, 2, 2, 1]) + b"\0" * 4  # the library's default fill
    layout = bytes([3, 1]) + (_UNDEF if addr is None else _q(addr)) \
        + _q(a.nbytes)
    return _object_header([_message(0x01, space), _datatype_message(a.dtype),
                           _message(0x05, fill, flags=1),
                           _message(0x08, layout)])


def write(path: str | os.PathLike, datasets: dict[str, np.ndarray]) -> None:
    """Write ``datasets`` ({name: array}, at most eight) as contiguous
    datasets of a new HDF5 file (superblock version 0, little-endian),
    replacing ``path`` atomically."""
    names = sorted(datasets, key=lambda n: n.encode("utf-8"))
    if not 0 < len(names) <= _SNOD_SLOTS:
        raise ValueError(f"write takes 1 to {_SNOD_SLOTS} datasets, got "
                         f"{len(names)}")
    arrays = {}
    for n in names:
        if not n or "/" in n or n == ".":
            raise ValueError(f"dataset name {n!r}")
        a = np.asarray(datasets[n])
        arrays[n] = np.array(a, a.dtype.newbyteorder("<"), order="C")

    # the local heap's data segment: "" at 0, then each name NUL-padded
    heap_data = bytearray(8)
    name_offset = {}
    for n in names:
        name_offset[n] = len(heap_data)
        raw = n.encode("utf-8") + b"\0"
        heap_data += raw + b"\0" * (-len(raw) % 8)

    root_oh = 96  # the superblock's size
    tree = root_oh + 40
    heap = tree + 24 + (2 * _TREE_SLOTS + 1) * 8  # 33 keys, 32 children
    snod = heap + 32 + len(heap_data)
    pos = snod + 8 + _SNOD_SLOTS * 40
    headers, data_at = {}, {}
    for n in names:
        headers[n] = pos
        pos += len(_dataset_header(arrays[n], 0))
    for n in names:
        data_at[n] = pos if arrays[n].nbytes else None
        pos += arrays[n].nbytes + (-arrays[n].nbytes % 8)

    out = bytearray(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]))
    out += (4).to_bytes(2, "little") + (16).to_bytes(2, "little") + b"\0" * 4
    out += _q(0) + _UNDEF + _q(pos) + _UNDEF
    out += _q(0) + _q(root_oh) + (1).to_bytes(4, "little") + b"\0" * 4
    out += _q(tree) + _q(heap)
    out += _object_header([_message(0x11, _q(tree) + _q(heap))])
    out += (b"TREE" + bytes([0, 0]) + (1).to_bytes(2, "little") + _UNDEF
            + _UNDEF + _q(0) + _q(snod) + _q(name_offset[names[-1]]))
    out += b"\0" * (heap - len(out))
    out += (b"HEAP" + bytes([0, 0, 0, 0]) + _q(len(heap_data))
            + _q(1) + _q(heap + 32))  # free list 1: no free block
    out += heap_data
    out += b"SNOD" + bytes([1, 0]) + len(names).to_bytes(2, "little")
    for n in names:
        out += _q(name_offset[n]) + _q(headers[n]) + b"\0" * 24
    out += b"\0" * (headers[names[0]] - len(out))
    for n in names:
        out += _dataset_header(arrays[n], data_at[n])
    for n in names:
        raw = arrays[n].tobytes()
        out += raw + b"\0" * (-len(raw) % 8)
    if len(out) != pos:
        raise RuntimeError(f"h5 writer laid out {pos} bytes, wrote {len(out)}")
    tmp = f"{os.fspath(path)}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(out)
    os.replace(tmp, path)
