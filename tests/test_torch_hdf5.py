"""The port's HDF5 codec (``cista_flow_torch/data/hdf5.py``) against h5py.

The reader on a matrix of files h5py writes (contiguous, compact, chunked
with gzip, shuffle + gzip, fletcher32, edge chunks, unallocated chunks with
and without a fill value, chunk B-trees of two levels, nested groups,
groups of hundreds of members, object headers with continuation blocks,
every integer width, 32- and 64-bit floats in both byte orders, empty and
scalar datasets): every dataset bit for bit and with h5py's dtype, whole and
in slices that cross chunk boundaries. A slice reads only its rows. The
features the reader does not read raise ``ValueError`` naming them. h5py
reads the port writer's files bit for bit.
"""
import shutil

import numpy as np
import pytest

from cista_flow_torch.data import hdf5

h5py = pytest.importorskip("h5py")

RNG = np.random.default_rng(0)
DTYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8",
          ">i2", ">i4", ">i8", ">u4", ">f4", ">f8"]


def values(dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return RNG.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return RNG.integers(info.min, info.max, shape, dtype=dt.newbyteorder("="), endpoint=True
                        ).astype(dt)


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def check_file(path, rows=((0, 1), (3, 17), (-5, None))):
    """Every dataset of ``path`` through both readers: whole, by row, in
    slices."""
    names = []
    with h5py.File(path, "r") as ref:
        ref.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        with hdf5.File(path) as f:
            for n in names:
                want, ds = ref[n], f[n]
                assert ds.shape == want.shape and ds.dtype == want.dtype, n
                same(ds[()], want[()])
                same(np.asarray(ds), want[()])
                if want.ndim:
                    for a, b in rows:
                        same(ds[a:b], want[a:b])
                    if want.shape[0]:
                        same(ds[want.shape[0] // 2], want[want.shape[0] // 2])
                        same(ds[-1], want[-1])
    return names


@pytest.mark.parametrize("dtype", DTYPES)
def test_contiguous_dtypes(tmp_path, dtype):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f["a"] = values(dtype, (23, 3))
        f["b"] = values(dtype, (40,))
    assert check_file(path) == ["a", "b"]


@pytest.mark.parametrize("filters", [
    dict(compression="gzip"),
    dict(compression="gzip", shuffle=True),
    dict(compression="gzip", compression_opts=9, shuffle=True, fletcher32=True),
    dict(shuffle=True),
    dict(fletcher32=True),
    dict(),
], ids=["gzip", "shuffle-gzip", "shuffle-gzip-fletcher32", "shuffle", "fletcher32", "none"])
@pytest.mark.parametrize("dtype", ["u1", "i2", ">i4", "f4", ">f8", "i8"])
def test_chunked_filters_and_edge_chunks(tmp_path, filters, dtype):
    """Chunks of (4, 3, 5) over a (30, 7, 12) extent: edge chunks past the
    extent on every axis; slices across chunk boundaries."""
    path = tmp_path / "k.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=values(dtype, (30, 7, 12)), chunks=(4, 3, 5), **filters)
        f.create_dataset("y", data=values(dtype, (9,)), chunks=(4,), **filters)
    check_file(path, rows=((0, 30), (3, 9), (7, 8), (27, 40), (11, 5)))
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        same(f["x"][2:27:4], ref["x"][2:27:4])
        same(f["x"][5, 2], ref["x"][5, 2])
        same(f["x"][3:9, 1:6, ::2], ref["x"][3:9, 1:6, ::2])


@pytest.mark.parametrize("fill", [None, 7.5])
def test_unallocated_chunks_read_as_the_fill_value(tmp_path, fill):
    path = tmp_path / "u.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", shape=(50, 6), chunks=(8, 6), dtype="f4", fillvalue=fill,
                              compression="gzip")
        ds[10:20] = values("f4", (10, 6))
        f.create_dataset("never", shape=(12, 2), chunks=(4, 2), dtype="i4")
        f.create_dataset("late", shape=(5, 2), dtype="f8", fillvalue=fill)  # contiguous, no data
    check_file(path, rows=((0, 50), (5, 12), (30, 40)))
    with hdf5.File(path) as f:
        assert f["x"][40, 0] == (fill or 0)


def test_two_level_chunk_btree_and_lazy_slices(tmp_path, monkeypatch):
    """400 chunks (a leaf holds 64): a B-tree of two levels. A slice
    decodes only the chunks it touches, a contiguous slice reads only its
    rows."""
    path = tmp_path / "t.h5"
    events = values("f8", (2000, 4))
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=events, chunks=(5, 4), compression="gzip")
        f["flat"] = events
    check_file(path, rows=((0, 2000), (3, 1997), (1234, 1301)))
    decoded, read = [], []
    orig_decode, orig_into = hdf5.Dataset._decode, hdf5._Reader.read_into
    monkeypatch.setattr(hdf5.Dataset, "_decode",
                        lambda self, *a: decoded.append(a) or orig_decode(self, *a))
    monkeypatch.setattr(hdf5._Reader, "read_into",
                        lambda self, out, addr: read.append(out.nbytes) or
                        orig_into(self, out, addr))
    with hdf5.File(path) as f:
        same(f["chunked"][1234:1301], events[1234:1301])
        assert len(decoded) == 15                  # the chunks at rows 1230, 1235, ..., 1300
        same(f["flat"][1234:1301], events[1234:1301])
        assert read == [67 * 4 * 8]


def test_nested_groups_many_members_and_continuations(tmp_path):
    """davis/left-style nesting, a group of 300 members (symbol table
    nodes hold 8, a B-tree leaf 32: a two-level group B-tree), and a
    dataset whose header grows a continuation block (attributes added after
    it was made)."""
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("davis/left/deep/er")
        g["v"] = values("i4", (7,))
        many = f.create_group("many")
        for i in range(300):
            many[f"d{i:03d}"] = np.full((2,), i, np.int16)
        ds = f.create_dataset("attrs", data=values("f4", (11, 2)))
        f["after"] = np.arange(3)           # the header cannot grow in place
        for i in range(40):
            ds.attrs[f"a{i}"] = np.arange(i + 1)
    names = check_file(path)
    assert len(names) == 303
    reader = hdf5._Reader(path)
    header = hdf5.File(path)._links["attrs"]
    size = np.frombuffer(reader.read(header + 8, 4), "<u4")[0]
    first = reader.read(header + 16, size)
    assert b"\x10\x00\x10\x00" in first          # a continuation message (type 16, 16 bytes)
    reader.close()
    with hdf5.File(path) as f:
        assert f["davis"].keys() == ["left"] and "davis/left/deep/er/v" in f
        assert len(f["many"]) == 300 and f["many/d299"][1] == 299
        assert f.get("nothing/here") is None
        with pytest.raises(KeyError):
            f["davis/right"]


def test_compact_scalar_and_empty(tmp_path):
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset("compact", data=values(">i2", (6, 2)), dcpl=dcpl)
        f["scalar"] = np.float64(2.5)
        f["empty"] = np.zeros((0, 4))
        f.create_dataset("empty_chunked", shape=(0, 4), maxshape=(None, 4), dtype="f4")
    check_file(path)
    with hdf5.File(path) as f:
        assert f["compact"].layout == "compact" and f["scalar"][()] == 2.5
        assert f["empty"][:].shape == (0, 4) and len(f["empty_chunked"]) == 0


def test_fletcher32_mismatch_raises(tmp_path):
    path, bad = tmp_path / "f.h5", tmp_path / "bad.h5"
    data = values("f4", (64,))
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(64,), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = raw.find(data.tobytes()[:16])
    raw[at + 5] ^= 0xFF
    bad.write_bytes(bytes(raw))
    with hdf5.File(bad) as f, pytest.raises(ValueError, match="fletcher32"):
        f["x"][:]


def make_unsupported(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    if kind == "latest":
        with h5py.File(path, "w", libver="latest") as f:
            f["a"] = np.arange(4)
        return path, "object header version 2"
    if kind == "latest_group":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_group("g")
        return path, "object header version 2"
    with h5py.File(path, "w") as f:
        if kind == "string":
            f["x"] = np.array([b"abc", b"de"])
            return path, "class 3 \\(string\\)"
        if kind == "compound":
            f["x"] = np.zeros(3, dtype=[("a", "i4"), ("b", "f8")])
            return path, "class 6 \\(compound\\)"
        if kind == "vlen":
            f.create_dataset("x", shape=(2,), dtype=h5py.vlen_dtype(np.int32))
            return path, "class 9 \\(variable-length\\)"
        if kind == "bool":
            f["x"] = np.array([True, False])
            return path, "class 8 \\(enumerated\\)"
        if kind == "f2":
            f["x"] = np.zeros(3, np.float16)
            return path, "floating-point datatype of 2 bytes"
        if kind == "lzf":
            f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="lzf")
            return path, "filter 32000"
        if kind == "scaleoffset":
            f.create_dataset("x", data=np.arange(100), chunks=(10,), scaleoffset=0)
            return path, "filter 6 \\(scaleoffset\\)"
        if kind == "soft":
            f["a"] = np.arange(3)
            f["b"] = h5py.SoftLink("/a")
            return path, "soft link"
        if kind == "external":
            f.create_dataset("x", shape=(4,), dtype="i4", external=[(str(tmp_path / "ext.bin"), 0,
                                                                    h5py.h5f.UNLIMITED)])
            return path, "external data files"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["latest", "latest_group", "string", "compound", "vlen", "bool",
                                  "f2", "lzf", "scaleoffset", "soft", "external"])
def test_unsupported_features_raise_by_name(tmp_path, kind):
    path, match = make_unsupported(tmp_path, kind)
    with pytest.raises(ValueError, match=match):
        with hdf5.File(path) as f:
            obj = f["g"] if kind == "latest_group" else f["b" if kind == "soft" else
                                                         ("a" if kind == "latest" else "x")]
            obj[()]


def test_not_hdf5_and_user_block_raise(tmp_path):
    plain = tmp_path / "plain.h5"
    plain.write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(ValueError, match="no HDF5 signature"):
        hdf5.File(plain)
    ub = tmp_path / "ub.h5"
    with h5py.File(ub, "w", userblock_size=512) as f:
        f["a"] = np.arange(3)
    with pytest.raises(ValueError, match="user block"):
        hdf5.File(ub)


@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_the_writer_bit_for_bit(tmp_path, dtype):
    arrays = {"davis/left/events": values(dtype, (57, 4)),
              "davis/left/image_raw": values(dtype, (3, 5, 7)),
              "davis/left/image_raw_ts": values(dtype, (3,)),
              "davis/right/x": values(dtype, (0, 2)),
              "x": values(dtype, (1,)), "s": np.asarray(values(dtype, (1,))[0])}
    path = tmp_path / "w.h5"
    hdf5.write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        for name, want in arrays.items():
            same(f[name][()], want)
        assert sorted(f["davis"]) == ["left", "right"]
    check_file(path)


def test_writer_groups_of_many_members(tmp_path):
    """More members than a symbol table node holds: several nodes under one
    B-tree leaf, names in byte order."""
    arrays = {f"g/{n}": np.arange(i, i + 3, dtype=np.int32)
              for i, n in enumerate(["b", "a", "B", "_z", "A0"] + [f"m{j}" for j in range(60)])}
    path = tmp_path / "m.h5"
    hdf5.write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f["g"]) == sorted(n.split("/")[1] for n in arrays)
        for name, want in arrays.items():
            same(f[name][()], want)
    with hdf5.File(path) as f:
        assert f["g"].keys() == sorted(f["g"].keys(), key=str.encode)
    with pytest.raises(ValueError, match="at most 256"):
        hdf5.write_h5(tmp_path / "big.h5", {f"g/{i}": np.zeros(1) for i in range(257)})
    with pytest.raises(ValueError, match="writes integers"):
        hdf5.write_h5(tmp_path / "bad.h5", {"x": np.zeros(2, bool)})
    copy = tmp_path / "copy.h5"
    shutil.copy(path, copy)
    with hdf5.File(copy) as f:
        same(f["g/m59"][:], arrays["g/m59"])
