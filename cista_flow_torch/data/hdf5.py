"""HDF5 files, read and written with numpy, ``zlib`` and ``struct`` only.

The MVSEC recordings (``*_data.hdf5``, ``*_gt.hdf5``) and FlyingChairs2's
event files (``*-event.hdf5``) are HDF5; the JAX package reads and writes
them with h5py, which the port does not use. This module is the port's
counterpart of those uses (cista_flow_tpu/data/mvsec.py:82-98,
file_io.py:107-120, sim.py:343-355).

``File(path)`` reads what h5py writes at its defaults:
  - superblock version 0 or 1 (and 2 or 3, whose root object header must
    then still be version 1), 8-byte offsets and lengths, no user block;
  - version 1 object headers, with continuation blocks;
  - old-style groups: a symbol table message, its version 1 B-tree (type
    0), local heap and symbol table nodes, nested to any depth. The cached
    B-tree and heap addresses of a symbol table entry are never used: every
    object is read from its own header;
  - dataspace messages version 1 and 2 (scalar and simple);
  - datatype classes 0 (fixed-point, signed or unsigned, 1, 2, 4 or 8
    bytes) and 1 (IEEE float, 4 or 8 bytes), either byte order; an array
    keeps the file's byte order, as h5py returns it;
  - data layout messages version 3 (and 4, but not its chunk indexes):
    compact, contiguous, and chunked with a version 1 B-tree (type 1) chunk
    index; chunks through the filter pipeline's deflate (1), shuffle (2)
    and fletcher32 (3, checked), undone in reverse order and skipped where
    a chunk's filter mask says so; unallocated storage and chunks read as
    the fill value (zero unless the file sets one); edge chunks past the
    extent are cut.
Anything else raises ``ValueError`` naming what it met: new-style groups
(link messages, link info, a fractal heap), object header version 2
(``OHDR``), other chunk indexes (single chunk, implicit, fixed array,
extensible array, version 2 B-tree), other filters, other datatype classes
(strings, compound, variable-length, enum, ...), soft links, external
storage, shared messages. Nothing is guessed.

A ``Dataset`` reads lazily: ``ds[a:b]`` reads only rows a..b of the first
axis (one ``pread`` of a contiguous dataset; a chunked one decodes only the
chunks those rows touch, found through the chunk index, which is read once
per dataset). ``len(ds)``, ``ds.shape``, ``ds.dtype``, ``np.asarray(ds)``,
``ds[i]``, ``ds[()]`` and a tuple key whose first item selects rows work as
in h5py.

``write_h5(path, {"davis/left/events": array, ...})`` writes a file that
h5py reads back bit for bit: superblock version 0, version 1 object
headers, old-style groups (each group's members in one version 1 B-tree
node over symbol table nodes of 8 entries, at most 256 members a group),
and every dataset **contiguous** and unfiltered. Contiguous is the simplest
layout h5py reads, and it needs no chunk B-tree (a version 0 superblock has
no field for that tree's K, so the library's default K = 32 would allow 64
chunks a leaf, and the 572 frames of ``indoor_flying4`` would need a
two-level tree); the cost is file size (572 mostly-zero 260x346 frames,
51 MB, where h5py's gzip chunks are a few MB).
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF              # the undefined address
CLASS_NAMES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque",
               "compound", "reference", "enumerated", "variable-length", "array")
CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                 5: "version 2 B-tree"}
FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
# message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, EXTERNAL, LAYOUT = 0, 1, 2, 3, 4, 5, 6, 7, 8
GROUP_INFO, FILTER_PIPELINE, CONTINUATION, SYMBOL_TABLE = 10, 11, 16, 17
# the messages a dataset's data depend on: shared copies of them are refused
DATA_MESSAGES = {DATASPACE: "dataspace", DATATYPE: "datatype", FILL_OLD: "fill value",
                 FILL: "fill value", LAYOUT: "data layout", FILTER_PIPELINE: "filter pipeline"}
# the writer's B-tree and symbol-table-node sizes (the library's defaults)
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): 16-bit big-endian words
    summed in runs of 360, each run's sums folded to 16 bits."""
    n = len(data) // 2
    words = np.frombuffer(data[:2 * n], ">u2").astype(np.int64)
    s1 = s2 = 0
    for i in range(0, n, 360):
        w = words[i:i + 360]
        t = len(w)
        s2 += t * s1 + int(np.dot(np.arange(t, 0, -1), w))
        s1 += int(w.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def _datatype(body: bytes, where: str) -> np.dtype:
    cls, bits = body[0] & 0x0F, body[1] | body[2] << 8 | body[3] << 16
    (size,) = struct.unpack_from("<I", body, 4)
    name = CLASS_NAMES[cls] if cls < len(CLASS_NAMES) else f"class {cls}"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"{where}: fixed-point datatype of {size} bytes with bit offset "
                             f"{offset} and precision {precision}: not read")
        return np.dtype(f"{'>' if bits & 1 else '<'}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:
        order = bits & 0x41
        if order not in (0, 1):
            raise ValueError(f"{where}: VAX-order floating-point datatype: not read")
        layout = struct.unpack_from("<HHBBBBI", body, 8)
        ieee = {4: (0, 32, 23, 8, 0, 23, 127, 31), 8: (0, 64, 52, 11, 0, 52, 1023, 63)}
        if size not in ieee or layout + ((bits >> 8) & 0xFF,) != ieee[size]:
            raise ValueError(f"{where}: floating-point datatype of {size} bytes laid out as "
                             f"{layout}: only IEEE binary32 and binary64 are read")
        return np.dtype(f"{'>' if order else '<'}f{size}")
    raise ValueError(f"{where}: datatype class {cls} ({name}): only fixed-point and "
                     "floating-point datatypes are read")


def _dataspace(body: bytes, where: str) -> tuple:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise ValueError(f"{where}: null dataspace: not read")
        pos = 4
    else:
        raise ValueError(f"{where}: dataspace message version {version}: not read")
    return struct.unpack_from(f"<{rank}Q", body, pos)


def _fill(body: bytes, mtype: int) -> bytes:
    if mtype == FILL_OLD:
        (size,) = struct.unpack_from("<I", body, 0)
        return body[4:4 + size]
    version = body[0]
    if version in (1, 2):
        if version == 2 and not body[3]:
            return b""
        (size,) = struct.unpack_from("<I", body, 4)
        return body[8:8 + size] if size != 0xFFFFFFFF else b""
    if version == 3:
        if not body[1] & 0x20:
            return b""
        (size,) = struct.unpack_from("<I", body, 2)
        return body[6:6 + size]
    raise ValueError(f"fill value message version {version}: not read")


def _filters(body: bytes, where: str) -> list:
    version, n = body[0], body[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", body, pos)
        pos += 2
        namelen = 0
        if version == 1 or fid >= 256:
            (namelen,) = struct.unpack_from("<H", body, pos)
            pos += 2
        _, nvals = struct.unpack_from("<HH", body, pos)
        pos += 4
        pos += (namelen + 7) // 8 * 8 if version == 1 else namelen
        vals = struct.unpack_from(f"<{nvals}I", body, pos)
        pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (1, 2, 3):
            raise ValueError(f"{where}: filter {fid} ({FILTERS.get(fid, 'unknown')}): only "
                             "deflate (1), shuffle (2) and fletcher32 (3) are read")
        out.append((fid, vals))
    return out


class _Reader:
    """The open file: ``pread`` by address, the objects' messages."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fd = os.open(self.path, os.O_RDONLY)
        try:
            self._superblock()
        except BaseException:
            os.close(self.fd)
            raise

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, addr)
        if len(data) != n:
            raise ValueError(f"{self.path}: {n} bytes at {addr} run past the end of the file")
        return data

    def read_into(self, out: np.ndarray, addr: int) -> None:
        view = memoryview(out.reshape(-1).view(np.uint8))
        if os.preadv(self.fd, [view], addr) != len(view):
            raise ValueError(f"{self.path}: {len(view)} bytes at {addr} run past the end "
                             "of the file")

    def _superblock(self):
        head = self.read(0, 96)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at offset 0 (a user block is "
                             "not read)")
        version = head[8]
        if version in (0, 1):
            sizes = head[13], head[14]
            pos = 24 + (4 if version == 1 else 0)     # version 1: the chunk tree's K
            base, _, _, driver = struct.unpack_from("<4Q", head, pos)
            if driver != UNDEF:
                raise ValueError(f"{self.path}: driver information block: not read")
            (self.root,) = struct.unpack_from("<Q", head, pos + 32 + 8)
        elif version in (2, 3):
            sizes = head[9], head[10]
            base, _, _, self.root = struct.unpack_from("<4Q", head, 12)
        else:
            raise ValueError(f"{self.path}: superblock version {version}: not read")
        if sizes != (8, 8):
            raise ValueError(f"{self.path}: {sizes[0]}-byte offsets and {sizes[1]}-byte "
                             "lengths: only 8 and 8 are read")
        if base != 0:
            raise ValueError(f"{self.path}: base address {base}: not read")

    def messages(self, addr: int, where: str) -> list:
        """[(type, flags, body)] of the version 1 object header at ``addr``,
        continuation blocks followed."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{self.path}: {where}: object header version 2 ('OHDR'): only "
                             "version 1 object headers are read")
        version, _, _, _, size = struct.unpack_from("<BBHII", head, 0)
        if version != 1:
            raise ValueError(f"{self.path}: {where}: object header version {version}: not read")
        blocks, out = [(addr + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body, 0))
                elif mtype != NIL:
                    if mflags & 0x02 and mtype in DATA_MESSAGES:
                        raise ValueError(f"{self.path}: {where}: shared "
                                         f"{DATA_MESSAGES[mtype]} message: not read")
                    out.append((mtype, mflags, body))
        return out

    def heap(self, addr: int) -> bytes:
        head = self.read(addr, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {addr}")
        size, _, data = struct.unpack_from("<QQQ", head, 8)
        return self.read(data, size)

    def btree(self, addr: int, kind: int, key_size: int):
        """Yield (key bytes, child address) of every leaf entry of the
        version 1 B-tree at ``addr`` (node type ``kind``)."""
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != kind:
            raise ValueError(f"{self.path}: no version 1 B-tree of type {kind} at {addr}")
        level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 24, entries * (key_size + 8) + key_size)
        for i in range(entries):
            key = body[i * (key_size + 8):i * (key_size + 8) + key_size]
            (child,) = struct.unpack_from("<Q", body, i * (key_size + 8) + key_size)
            if level:
                yield from self.btree(child, kind, key_size)
            else:
                yield key, child

    def symbol_table(self, btree: int, heap_addr: int, where: str) -> dict:
        """{name: object header address} of an old-style group."""
        names = self.heap(heap_addr)
        out = {}
        for _, snod in self.btree(btree, 0, 8):
            head = self.read(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{self.path}: {where}: no symbol table node at {snod}")
            (n,) = struct.unpack_from("<H", head, 6)
            entries = self.read(snod + 8, 40 * n)
            for i in range(n):
                name_off, header, cache = struct.unpack_from("<QQI", entries, 40 * i)
                name = names[name_off:names.index(b"\0", name_off)].decode()
                if cache == 2:
                    raise ValueError(f"{self.path}: {where}/{name}: soft link: not read")
                out[name] = header
        return out

    def object(self, addr: int, where: str):
        msgs = self.messages(addr, where)
        types = {t for t, _, _ in msgs}
        if SYMBOL_TABLE in types:
            body = next(b for t, _, b in msgs if t == SYMBOL_TABLE)
            return Group(self, where, self.symbol_table(*struct.unpack_from("<QQ", body), where))
        if types & {LINK, LINK_INFO, GROUP_INFO}:
            raise ValueError(f"{self.path}: {where}: new-style group (link messages, link info, "
                             "a fractal heap): only old-style (symbol table) groups are read")
        if {DATASPACE, DATATYPE, LAYOUT} <= types:
            return Dataset(self, where, msgs)
        raise ValueError(f"{self.path}: {where}: an object with messages {sorted(types)}: "
                         "neither an old-style group nor a dataset")

    def close(self):
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class Group:
    """An old-style group: members by name or by a '/'-separated path."""

    def __init__(self, reader: _Reader, name: str, links: dict):
        self._reader, self.name, self._links = reader, name, links

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{self._reader.path}: no member {head!r} in {self.name!r}")
        where = f"{self.name.rstrip('/')}/{head}"
        obj = self._reader.object(self._links[head], where)
        if not rest:
            return obj
        if not isinstance(obj, Group):
            raise KeyError(f"{self._reader.path}: {where} is not a group")
        return obj[rest]

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default


class File(Group):
    """An HDF5 file opened for reading (``with File(path) as f: f["a/b"][:]``)."""

    def __init__(self, path):
        reader = _Reader(path)
        root = reader.object(reader.root, "/")
        if not isinstance(root, Group):
            raise ValueError(f"{path}: the root object is not a group")
        super().__init__(reader, "/", root._links)

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        reader = self.__dict__.get("_reader")
        if reader is not None:
            reader.close()


class Dataset:
    """A dataset, read lazily along its first axis."""

    def __init__(self, reader: _Reader, name: str, msgs: list):
        self._reader, self.name = reader, name
        where = f"{reader.path}: {name}"
        fill, filters, layout = b"", [], None
        for mtype, _, body in msgs:
            if mtype == DATASPACE:
                self.shape = tuple(int(d) for d in _dataspace(body, where))
            elif mtype == DATATYPE:
                self.dtype = _datatype(body, where)
            elif mtype in (FILL, FILL_OLD):
                fill = _fill(body, mtype) or fill
            elif mtype == FILTER_PIPELINE:
                filters = _filters(body, where)
            elif mtype == EXTERNAL:
                raise ValueError(f"{where}: external data files: not read")
            elif mtype == LAYOUT:
                layout = body
        self.fill = (np.frombuffer(fill, self.dtype)[0] if len(fill) == self.dtype.itemsize
                     else self.dtype.type(0))
        self.filters = filters
        self._layout(layout, where)
        self._chunks = None

    def _layout(self, body: bytes, where: str) -> None:
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise ValueError(f"{where}: data layout message version {version}: not read")
        if cls == 0:
            (size,) = struct.unpack_from("<H", body, 2)
            self.layout, self._data = "compact", body[4:4 + size]
        elif cls == 1:
            self.layout = "contiguous"
            self.address, self.storage = struct.unpack_from("<QQ", body, 2)
        elif cls == 2 and version == 3:
            rank1 = body[2]
            (self.address,) = struct.unpack_from("<Q", body, 3)
            dims = struct.unpack_from(f"<{rank1}I", body, 11)
            self.layout, self.chunk_shape = "chunked", tuple(int(d) for d in dims[:-1])
        elif cls == 2:
            rank1, enc = body[3], body[4]
            index = body[5 + rank1 * enc]
            raise ValueError(f"{where}: chunk index '{CHUNK_INDEXES.get(index, index)}' (data "
                             "layout version 4): only the version 1 B-tree chunk index is read")
        else:
            raise ValueError(f"{where}: data layout class {cls} (virtual): not read")
        if self.layout != "chunked" and self.filters:
            raise ValueError(f"{where}: a filter pipeline on {self.layout} storage: not read")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"{self.name}: a scalar dataset has no length")
        return self.shape[0]

    def __repr__(self):
        return f"<Dataset {self.name} {self.shape} {self.dtype} {self.layout}>"

    def __array__(self, dtype=None, copy=None):
        out = self[()]
        out = np.asarray(out)
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        rest = ()
        if isinstance(key, tuple) and key:
            key, rest = key[0], key[1:]
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            out = self._whole()
            return out[rest] if rest else out
        if not self.shape:
            raise IndexError(f"{self.name}: a scalar dataset takes only () or ...")
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"{self.name}: index {int(key)} out of range for {n} rows")
            out = self.rows(i, i + 1)[0]
            return out[rest] if rest else out
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            if step == 1:
                out = self.rows(start, max(start, stop))
            else:
                idx = range(start, stop, step)
                lo = min(idx, default=0)
                out = self.rows(lo, max(idx, default=-1) + 1)[np.asarray(idx, np.int64) - lo]
            return out[(slice(None),) + rest] if rest else out
        raise TypeError(f"{self.name}: only an integer, a slice, () or ... selects rows, "
                        f"got {key!r}")

    def _whole(self) -> np.ndarray:
        if not self.shape:
            out = self._scalar()
            return out[()]
        return self.rows(0, self.shape[0])

    def _scalar(self) -> np.ndarray:
        if self.layout == "compact":
            return np.frombuffer(self._data, self.dtype, count=1).reshape(()).copy()
        if self.layout == "contiguous":
            out = np.empty((), self.dtype)
            if self.address == UNDEF:
                out[()] = self.fill
            else:
                self._reader.read_into(out.reshape(1), self.address)
            return out
        return self._chunked(0, 1, ())

    def rows(self, start: int, stop: int) -> np.ndarray:
        """Rows ``start`` to ``stop`` of the first axis, reading only them."""
        shape = (stop - start,) + self.shape[1:]
        if self.layout == "compact":
            whole = np.frombuffer(self._data, self.dtype, count=self.size).reshape(self.shape)
            return whole[start:stop].copy()
        if self.layout == "contiguous":
            if self.address == UNDEF:
                return np.full(shape, self.fill, self.dtype)
            out = np.empty(shape, self.dtype)
            if out.size:
                row = math.prod(self.shape[1:]) * self.dtype.itemsize
                self._reader.read_into(out, self.address + start * row)
            return out
        return self._chunked(start, stop, shape)

    def _index(self):
        """The chunk index, read once: first-axis offsets (sorted), each
        chunk's offsets, address, stored size and filter mask."""
        if self._chunks is None:
            rank = len(self.chunk_shape)
            entries = []
            if self.address != UNDEF:
                for key, child in self._reader.btree(self.address, 1, 8 + 8 * (rank + 1)):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offsets = struct.unpack_from(f"<{rank}Q", key, 8)
                    entries.append((offsets, child, size, mask))
            entries.sort()
            self._chunks = (np.array([e[0][0] for e in entries], np.int64), entries)
        return self._chunks

    def _chunked(self, start: int, stop: int, shape: tuple) -> np.ndarray:
        out = np.full(shape, self.fill, self.dtype)
        if not out.size and shape:
            return out
        firsts, entries = self._index()
        c0 = self.chunk_shape[0]
        lo = int(np.searchsorted(firsts, start - c0, side="right"))
        hi = int(np.searchsorted(firsts, stop, side="left"))
        for offsets, addr, size, mask in entries[lo:hi]:
            data = self._decode(addr, size, mask)
            if not shape:                      # a scalar stored as one chunk
                return data.reshape(-1)[:1].reshape(())
            src, dst = [], []
            for axis, (o, c) in enumerate(zip(offsets, self.chunk_shape)):
                a, b = (max(start, o), min(stop, o + c)) if axis == 0 else \
                    (o, min(self.shape[axis], o + c))
                if a >= b:
                    break
                src.append(slice(a - o, b - o))
                dst.append(slice(a - start, b - start) if axis == 0 else slice(a, b))
            else:
                out[tuple(dst)] = data[tuple(src)]
        return out

    def _decode(self, addr: int, size: int, mask: int) -> np.ndarray:
        raw = self._reader.read(addr, size)
        where = f"{self._reader.path}: {self.name}: chunk at {addr}"
        for i in reversed(range(len(self.filters))):
            if mask & (1 << i):
                continue
            fid, vals = self.filters[i]
            if fid == 3:
                stored = struct.unpack("<I", raw[-4:])[0]
                raw = raw[:-4]
                sum_ = fletcher32(raw)
                # HDF5 1.6.0-1.6.2 stored the sum byte-reversed; the library accepts both
                if stored not in (sum_, struct.unpack(">I", struct.pack("<I", sum_))[0]):
                    raise ValueError(f"{where}: fletcher32 checksum mismatch")
            elif fid == 1:
                raw = zlib.decompress(raw)
            else:
                esize = vals[0] if vals else self.dtype.itemsize
                n = len(raw) // esize
                body = np.frombuffer(raw, np.uint8, count=n * esize).reshape(esize, n)
                raw = body.T.tobytes() + raw[n * esize:]
        count = math.prod(self.chunk_shape)
        if len(raw) != count * self.dtype.itemsize:
            raise ValueError(f"{where}: {len(raw)} bytes decoded, expected "
                             f"{count * self.dtype.itemsize}")
        return np.frombuffer(raw, self.dtype).reshape(self.chunk_shape)


# ---------------------------------------------------------------------------
# the writer

def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                            np.little_endian is False) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (8 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        eloc, esize, msize, bias = (23, 8, 23, 127) if size == 4 else (52, 11, 52, 1023)
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20 | order, 8 * size - 1, 0, size,
                           0, 8 * size, eloc, esize, 0, msize, bias)
    raise ValueError(f"write_h5 writes integers of 1, 2, 4 or 8 bytes and 32- or 64-bit "
                     f"floats, got {dtype}")


def _object_header(messages: list) -> bytes:
    """A version 1 object header of (type, body) messages, each padded to
    a multiple of 8 bytes."""
    body = b""
    for mtype, data in messages:
        data += b"\0" * (-len(data) % 8)
        body += struct.pack("<HHB3x", mtype, len(data), 1 if mtype == DATATYPE else 0) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Layout:
    """Addresses handed out in order, every piece 8-byte aligned."""

    def __init__(self, start: int):
        self.end, self.pieces = start, []

    def put(self, data) -> int:
        addr = self.end
        self.pieces.append((addr, data))
        n = data.nbytes if isinstance(data, np.ndarray) else len(data)
        self.end = addr + n + (-n % 8)
        return addr


def _write_group(out: _Layout, members: dict) -> tuple:
    """Write a group's members, then the group; returns (object header
    address, B-tree address, local heap address)."""
    entries = []
    for name in sorted(members, key=lambda s: s.encode()):
        item = members[name]
        if isinstance(item, dict):
            header, btree, heap = _write_group(out, item)
            entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
        else:
            entries.append((name, _write_dataset(out, item), 0, b"\0" * 16))
    per_node = 2 * GROUP_LEAF_K
    if len(entries) > per_node * 2 * GROUP_INTERNAL_K:
        raise ValueError(f"write_h5 writes at most {per_node * 2 * GROUP_INTERNAL_K} members "
                         f"a group, got {len(entries)}")
    names, offsets = b"\0" * 8, {}
    for name, *_ in entries:
        offsets[name] = len(names)
        raw = name.encode() + b"\0"
        names += raw + b"\0" * (-len(raw) % 8)
    snods, keys = [], [0]
    for i in range(0, len(entries), per_node):
        part = entries[i:i + per_node]
        node = b"SNOD" + struct.pack("<BxH", 1, len(part))
        for name, header, cache, scratch in part:
            node += struct.pack("<QQI4x", offsets[name], header, cache) + scratch
        snods.append(out.put(node + b"\0" * (8 + 40 * per_node - len(node))))
        keys.append(offsets[part[-1][0]])
    k2 = 2 * GROUP_INTERNAL_K
    tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF, UNDEF)
    for key, child in zip(keys, snods):
        tree += struct.pack("<QQ", key, child)
    tree += struct.pack("<Q", keys[-1])
    btree = out.put(tree + b"\0" * (24 + 8 * (2 * k2 + 1) - len(tree)))
    data = out.put(names)
    # free-list head 1: the library's H5HL_FREE_NULL, no free block
    heap = out.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(names), 1, data))
    header = out.put(_object_header([(SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
    return header, btree, heap


def _write_dataset(out: _Layout, arr: np.ndarray) -> int:
    dtype = _datatype_message(arr.dtype)
    arr = np.require(arr, requirements="C")         # (ascontiguousarray makes a scalar 1-d)
    space = struct.pack("<BBB5x", 1, arr.ndim, 0) + struct.pack(f"<{arr.ndim}Q", *arr.shape)
    addr = out.put(arr) if arr.nbytes else UNDEF
    layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
    # fill value message version 2: allocation late, written if set, none defined
    fill = struct.pack("<BBBB", 2, 2, 2, 0)
    return out.put(_object_header([(DATASPACE, space), (DATATYPE, dtype), (FILL, fill),
                                   (LAYOUT, layout)]))


def write_h5(path, datasets: dict) -> None:
    """Write ``{"group/.../name": array}`` as an HDF5 file: groups made as
    the paths need them, every array a contiguous dataset of its dtype
    (integers of 1, 2, 4 or 8 bytes, 32- and 64-bit floats, either byte
    order) and shape."""
    tree: dict = {}
    for name, arr in datasets.items():
        parts = name.strip("/").split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"write_h5: {name}: {p} is a dataset, not a group")
        if parts[-1] in node:
            raise ValueError(f"write_h5: {name} given twice")
        node[parts[-1]] = np.asarray(arr)
    out = _Layout(96)
    header, btree, heap = _write_group(out, tree)
    eof = out.end
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K,
                                 GROUP_INTERNAL_K, 0)
    sb += struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
    sb += struct.pack("<QQI4xQQ", 0, header, 1, btree, heap)
    with open(path, "wb") as f:
        f.write(sb)
        for addr, data in out.pieces:
            f.seek(addr)
            f.write(memoryview(data.reshape(-1).view(np.uint8))
                    if isinstance(data, np.ndarray) else data)
        f.truncate(eof)
