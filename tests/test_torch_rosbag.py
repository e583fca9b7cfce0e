"""The port's bag reader, bag writer and native codec against the JAX package.

The same messages, made with numpy from a seed, go through both packages'
`BagWriter` (none, bz2 and lz4 chunks, one chunk and several) and each
package's `BagReader` reads the other's bags. The port's codec
(`tpufusion_torch/native/`, a plain C interface built by `cc` at first use)
is held against its plain versions (the numpy unpack, the pure-Python LZ4)
and against the JAX package's extension and pure-Python codec. Tolerance:
none anywhere — bags are byte-equal, unpacked fields bit-equal (NaN where
a field is absent), decoded bytes equal, and every error raises the
reference extension's exception type and message.
"""

import os
import shutil
import struct
import time
import unittest.mock as um

import numpy as np
import pytest

import tpufusion.data.lz4 as jax_lz4
import tpufusion.data.rosbag_reader as jax_bag
import tpufusion.data.rosmsg as jax_rosmsg
import tpufusion_torch.data.lz4 as port_lz4
import tpufusion_torch.data.rosbag_reader as port_bag
import tpufusion_torch.data.rosmsg as port_rosmsg
from tpufusion_torch import native

T0 = 1_490_000_000_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUILD_DIR = native.BUILD_DIR


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's extension, built in place by its own loader (a
    worker that asks while another builds it gets None once: ask again)."""
    from tpufusion.native import get_fastpoints

    for _ in range(120):
        fp = get_fastpoints()
        if fp is not None:
            return fp
        time.sleep(0.5)
    raise AssertionError("the JAX package's native extension did not build")


def jax_pure_python(fn, *args, **kw):
    """A JAX-package codec function with its extension switched off: its
    pure-Python path."""
    with um.patch("tpufusion.native.get_fastpoints", lambda: None):
        return fn(*args, **kw)


def _messages(seed: int):
    """(connections, messages) of a small drive: clouds of varying sizes,
    mono8 and rgb8 camera frames, radar tracks and a duplicate stamp."""
    rng = np.random.default_rng(seed)
    conns = [(0, "/velodyne_points", "sensor_msgs/PointCloud2", ""),
             (1, "/image_raw", "sensor_msgs/Image", ""),
             (2, "/radar/tracks", "radar_driver/RadarTracks", port_bag.RADAR_TRACKS_DEFINITION)]
    msgs = []
    for i in range(6):
        t = T0 + (i if i != 3 else 2) * 100_000_000
        pts = rng.normal(0, 20, (300 + 70 * i, 4)).astype(np.float32)
        msgs.append((0, t, port_bag.serialize_pointcloud2(pts)))
        shape, enc = ((24, 40, 3), "rgb8") if i % 2 else ((24, 40), "mono8")
        img = rng.integers(0, 255, shape).astype(np.uint8)
        msgs.append((1, t + 30_000_000, port_bag.serialize_image(img, enc)))
        tracks = [{"number": k, "range": float(rng.uniform(5, 60)),
                   "angle": float(rng.uniform(-30, 30)), "moving": bool(k % 2)}
                  for k in range(i % 3 + 1)]
        msgs.append((2, t + 50_000_000, port_bag.serialize_radar_tracks(tracks, t + 50_000_000)))
    return conns, msgs


def _write(module, path, compression, chunk_threshold=4 << 20, seed=0):
    conns, msgs = _messages(seed)
    w = module.BagWriter(compression=compression, chunk_threshold=chunk_threshold)
    for conn in conns:
        w.add_connection(*conn)
    for m in msgs:
        w.add_message(*m)
    w.write(str(path))
    return msgs


def _read(module, path):
    return [(m.topic, m.msg_type, m.timestamp, m.raw, m.definition)
            for m in module.BagReader(str(path)).read_messages()]


@pytest.mark.parametrize("chunk_threshold", [4 << 20, 4096], ids=["one_chunk", "many_chunks"])
@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_port_writes_the_reference_bytes_and_each_reads_the_other(
        tmp_path, jax_native, compression, chunk_threshold):
    port_path, jax_path = tmp_path / "port.bag", tmp_path / "jax.bag"
    msgs = _write(port_bag, port_path, compression, chunk_threshold)
    _write(jax_bag, jax_path, compression, chunk_threshold)
    assert port_path.read_bytes() == jax_path.read_bytes()
    for reader in (port_bag, jax_bag):
        for path in (port_path, jax_path):
            got = _read(reader, path)
            assert [(t, raw) for _, t, raw in msgs] == [(g[2], g[3]) for g in got]
            assert got == _read(jax_bag, jax_path)
    assert _read(port_bag, port_path)[2][4] == port_bag.RADAR_TRACKS_DEFINITION


def test_topic_filter_and_decoders_match_the_reference(tmp_path):
    path = tmp_path / "d.bag"
    _write(port_bag, path, "lz4", chunk_threshold=8192)
    port_msgs = list(port_bag.BagReader(str(path)).read_messages(topics=["/image_raw", "/radar/tracks"]))
    jax_msgs = list(jax_bag.BagReader(str(path)).read_messages(topics=["/image_raw", "/radar/tracks"]))
    assert len(port_msgs) == len(jax_msgs) == 12
    for p, j in zip(port_msgs, jax_msgs):
        if p.topic == "/image_raw":
            (pi, pe), (ji, je) = port_bag.parse_image(p.raw), jax_bag.parse_image(j.raw)
            assert pe == je and pi.dtype == ji.dtype
            np.testing.assert_array_equal(pi, ji)
        else:
            assert port_bag.parse_radar_tracks(p) == jax_bag.parse_radar_tracks(j)
    got, got_ts = port_bag.extract_bag_points(str(path))
    want, want_ts = jax_bag.extract_bag_points(str(path))
    np.testing.assert_array_equal(got, want)  # NaN padding at the same places
    np.testing.assert_array_equal(got_ts, want_ts)
    clouds = port_bag.BagReader(str(path)).read_messages(topics=["/velodyne_points"])
    assert [port_bag.pointcloud2_size(m.raw) for m in clouds] == [300 + 70 * i for i in range(6)]


def test_rosmsg_copy_matches_the_reference():
    definition = """\
Header header
Track[4] fixed
Track[] tracks
float64[] samples
string label
duration age
================================================================================
MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id
================================================================================
MSG: pkg/Track
int8 a
uint16 b
int32 c # a comment
uint64 d
float32 e
bool f
char g
int64 CONSTANT=5
"""
    rng = np.random.default_rng(4)

    def track():
        return {"a": int(rng.integers(-128, 127)), "b": int(rng.integers(0, 65535)),
                "c": int(rng.integers(-2**31, 2**31 - 1)), "d": int(rng.integers(0, 2**63)),
                "e": float(np.float32(rng.normal())), "f": bool(rng.integers(2)),
                "g": int(rng.integers(0, 255))}

    value = {"header": {"seq": 7, "stamp": T0 + 3, "frame_id": "radar"},
             "fixed": [track() for _ in range(4)], "tracks": [track() for _ in range(3)],
             "samples": rng.normal(size=5).tolist(), "label": "ünïcode", "age": -1_500_000_000}
    raw = port_rosmsg.encode_message(value, definition)
    assert raw == jax_rosmsg.encode_message(value, definition)
    got, want = port_rosmsg.decode_message(raw, definition), jax_rosmsg.decode_message(raw, definition)
    np.testing.assert_array_equal(got.pop("samples"), want.pop("samples"))
    assert got == want and got["tracks"][1] == value["tracks"][1]
    assert sorted(port_rosmsg.parse_definition(definition)) == sorted(jax_rosmsg.parse_definition(definition))
    with pytest.raises(ValueError, match="consumed"):
        port_rosmsg.decode_message(raw + b"\0", definition)


# -- the PointCloud2 unpack ------------------------------------------------------

_PF = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16, 5: np.int32, 6: np.uint32,
       7: np.float32, 8: np.float64}


def _pointcloud2(fields, columns, point_step, height=1, row_pad=0):
    """A PointCloud2 message whose points hold `columns` (one array a
    field, of the field's dtype) at the fields' (name, offset, code);
    rows of an organized cloud padded by `row_pad` bytes."""
    n = len(columns[0])
    width = n // height
    rows = np.zeros((n, point_step), np.uint8)
    for (_, offset, code), col in zip(fields, columns):
        size = np.dtype(_PF[code]).itemsize
        rows[:, offset:offset + size] = np.ascontiguousarray(col, _PF[code]).view(np.uint8).reshape(n, size)
    row_step = width * point_step + row_pad
    data = np.zeros((height, row_step), np.uint8)
    data[:, : width * point_step] = rows.reshape(height, width * point_step)
    buf = struct.pack("<III", 0, 0, 0) + struct.pack("<I", 8) + b"velodyne"
    buf += struct.pack("<II", height, width) + struct.pack("<I", len(fields))
    for name, offset, code in fields:
        buf += struct.pack("<I", len(name)) + name.encode() + struct.pack("<IBI", offset, code, 1)
    buf += struct.pack("<B", 0) + struct.pack("<II", point_step, row_step)
    raw = data.tobytes()
    return buf + struct.pack("<I", len(raw)) + raw + struct.pack("<B", 1)


def _column(rng, code, n):
    dt = np.dtype(_PF[code])
    if dt.kind == "f":
        return (rng.normal(0, 1e3, n) * rng.choice([1, 1e-30, 1e30], n)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, endpoint=True, dtype=dt)


@pytest.mark.parametrize("code", sorted(_PF), ids=[np.dtype(_PF[c]).name for c in sorted(_PF)])
def test_native_unpack_equals_numpy_for_every_pointfield_code(jax_native, code):
    """x and intensity of `code`, y float32, z absent (a NaN column);
    an organized cloud with padded rows too."""
    rng = np.random.default_rng(code)
    fields = [("x", 0, code), ("y", 8, 7), ("intensity", 12, code)]
    for height, row_pad in ((1, 0), (3, 7)):
        n = 60
        raw = _pointcloud2(fields, [_column(rng, code, n), _column(rng, 7, n), _column(rng, code, n)],
                           point_step=24, height=height, row_pad=row_pad)
        got = port_bag.parse_pointcloud2(raw)
        plain = port_bag.parse_pointcloud2(raw, use_native=False)
        assert got.shape == (n, 4) and got.dtype == np.float32
        assert np.isnan(got[:, 2]).all()
        np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))
        for use_native in (True, False):
            want = jax_bag.parse_pointcloud2(raw, use_native=use_native)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        only = port_bag.parse_pointcloud2(raw, want=("intensity", "missing"))
        np.testing.assert_array_equal(only[:, 0].view(np.uint32), got[:, 3].view(np.uint32))
        assert np.isnan(only[:, 1]).all()


def test_parse_runs_the_native_unpack():
    raw = port_bag.serialize_pointcloud2(np.ones((5, 4), np.float32))
    with um.patch.object(native, "unpack", side_effect=RuntimeError("native called")):
        with pytest.raises(RuntimeError, match="native called"):
            port_bag.parse_pointcloud2(raw)
        assert port_bag.parse_pointcloud2(raw, use_native=False).shape == (5, 4)


# -- LZ4 -----------------------------------------------------------------------

def _cases(rng):
    return [b"", b"a", b"abc" * 4000,
            bytes(rng.integers(0, 256, (1 << 16) + 7).astype(np.uint8)),
            bytes(rng.integers(0, 3, 150_000).astype(np.uint8)),
            np.random.default_rng(9).normal(0, 20, (5000, 4)).astype(np.float32).tobytes()]


def test_lz4_round_trips_across_native_plain_and_the_reference(jax_native):
    rng = np.random.default_rng(5)
    for c in _cases(rng):
        blocks = [port_lz4.lz4_block_compress(c), port_lz4.lz4_block_compress_reference(c),
                  jax_lz4.lz4_block_compress(c), jax_pure_python(jax_lz4.lz4_block_compress, c)]
        assert blocks[0] == blocks[2] and blocks[1] == blocks[3]  # native = native, plain = plain
        for blk in blocks:
            assert port_lz4.lz4_block_decompress(blk) == c
            assert port_lz4.lz4_block_decompress_reference(blk) == c
            assert jax_pure_python(jax_lz4.lz4_block_decompress, blk) == c
            assert port_lz4.lz4_block_decompress(blk, max_size=len(c)) == c
        frames = [port_lz4.lz4_frame_compress(c), port_lz4.lz4_frame_compress_reference(c),
                  jax_lz4.lz4_frame_compress(c), jax_pure_python(jax_lz4.lz4_frame_compress, c),
                  port_lz4.lz4_frame_compress(c, 1000)]
        assert frames[0] == frames[2] and frames[1] == frames[3]
        for frm in frames:
            assert port_lz4.lz4_frame_decompress(frm) == c
            assert port_lz4.lz4_frame_decompress_reference(frm) == c
            assert jax_lz4.lz4_frame_decompress(frm) == c
            assert port_lz4.lz4_frame_decompress(frm, len(c)) == c
            if len(c) > 1:  # the declared size is a hard bound in both
                for fn in (port_lz4.lz4_frame_decompress, port_lz4.lz4_frame_decompress_reference):
                    with pytest.raises(ValueError, match="exceeds declared size"):
                        fn(frm, len(c) - 1)


def test_lz4_block_linked_frame_decodes():
    """A frame whose second block's match reaches into the first block's
    output (roslz4's streaming writer emits these)."""
    b1 = bytes([8 << 4]) + b"ABCDEFGH"
    b2 = bytes([0]) + struct.pack("<H", 8) + bytes([0])
    frame = struct.pack("<I", port_lz4.LZ4_FRAME_MAGIC) + bytes([1 << 6, 0x40, 0])
    for blk in (b1, b2):
        frame += struct.pack("<I", len(blk)) + blk
    frame += struct.pack("<I", 0)
    for fn in (port_lz4.lz4_frame_decompress, port_lz4.lz4_frame_decompress_reference,
               jax_lz4.lz4_frame_decompress):
        assert fn(frame) == b"ABCDEFGHABCD"


def test_lz4_declared_size_is_a_hard_bound():
    comp = port_lz4.lz4_block_compress(b"x" * 200_000)
    assert port_lz4.lz4_block_decompress(comp, max_size=200_000) == b"x" * 200_000
    for fn in (port_lz4.lz4_block_decompress, port_lz4.lz4_block_decompress_reference):
        with pytest.raises(ValueError, match="exceeds declared size"):
            fn(comp, max_size=1000)
    # without a bound the output buffer grows past its first guess (3x + 64)
    assert port_lz4.lz4_block_decompress(comp) == b"x" * 200_000


_GOOD = port_lz4.lz4_frame_compress(b"hello hello hello hello hello hello")
_FRAME_HEAD = struct.pack("<I", port_lz4.LZ4_FRAME_MAGIC) + bytes([1 << 6, 0x40, 0])
_BAD_CODEC_INPUTS = {
    "truncated literal length": ("lz4_decompress", bytes([0xF0])),
    "literal run past end": ("lz4_decompress", bytes([0x50]) + b"ab"),
    "truncated match offset": ("lz4_decompress", bytes([0x10]) + b"a" + b"\x01"),
    "zero match offset": ("lz4_decompress", bytes([0x10]) + b"a" + b"\0\0" + b"\0"),
    "offset before the output": ("lz4_decompress", bytes([0x10]) + b"a" + b"\x05\0" + b"\0"),
    "truncated match length": ("lz4_decompress", bytes([0x1F]) + b"a" + b"\x01\0"),
    "frame too short": ("lz4_frame_decompress", b"\x04\x22\x4d"),
    "bad magic": ("lz4_frame_decompress", b"\0" * 12),
    "unsupported version": ("lz4_frame_decompress", _GOOD[:4] + bytes([0x80]) + _GOOD[5:]),
    "truncated block": ("lz4_frame_decompress", _FRAME_HEAD + struct.pack("<I", 100) + b"abc"),
    "bad block inside a frame": ("lz4_frame_decompress", _FRAME_HEAD + struct.pack("<I", 2)
                                 + bytes([0x50, 0x61]) + struct.pack("<I", 0)),
}


@pytest.mark.parametrize("case", sorted(_BAD_CODEC_INPUTS))
def test_codec_errors_raise_the_reference_extension_exception(jax_native, case):
    """Each error code of the C interface raises what the reference's
    CPython extension raises on the same input: type and message."""
    name, data = _BAD_CODEC_INPUTS[case]
    port_fn = {"lz4_decompress": native.lz4_block_decompress,
               "lz4_frame_decompress": native.lz4_frame_decompress}[name]
    with pytest.raises(Exception) as want:
        getattr(jax_native, name)(data, -1)
    with pytest.raises(Exception) as got:
        port_fn(data)
    assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))
    assert type(got.value) is ValueError


_BAD_UNPACKS = {  # (n, point_step, offsets, codes, data length)
    "field past point_step": (4, 8, (0, 6), (7, 7), 64),
    "float64 past point_step": (4, 8, (4,), (8,), 64),
    "unknown datatype": (4, 16, (0,), (9,), 64),
    "data shorter than n * point_step": (5, 16, (0,), (7,), 64),
    "too many fields": (1, 64, tuple(range(17)), (2,) * 17, 64),
    "offsets / codes mismatch": (1, 16, (0, 4), (7,), 64),
}


@pytest.mark.parametrize("case", sorted(_BAD_UNPACKS))
def test_unpack_errors_raise_the_reference_extension_exception(jax_native, case):
    n, step, offsets, codes, length = _BAD_UNPACKS[case]
    data = bytes(length)
    with pytest.raises(Exception) as want:
        jax_native.unpack(data, n, step, offsets, codes)
    with pytest.raises(Exception) as got:
        native.unpack(data, n, step, offsets, codes)
    assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))


def test_frame_compress_rejects_a_bad_block_size(jax_native):
    for bs in (0, -4):
        with pytest.raises(ValueError, match="^block_size must be positive$"):
            port_lz4.lz4_frame_compress(b"abc", bs)
        with pytest.raises(ValueError, match="^block_size must be positive$"):
            jax_native.lz4_frame_compress(b"abc", bs)


# -- the native build ------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The native loader with nothing loaded and an empty build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "_build"


def test_native_library_is_built_once_under_a_hashed_name(fresh_build, monkeypatch):
    assert DEFAULT_BUILD_DIR == os.path.join(REPO, "tpufusion_torch", "_build")
    lib = native.load()
    path = native.library_path()
    assert os.path.dirname(path) == str(fresh_build) and os.path.exists(path)
    assert os.path.basename(path).startswith("libfastpoints_") and path.endswith(".so")
    assert os.listdir(fresh_build) == [os.path.basename(path)]  # no temporary left
    monkeypatch.setattr(native, "_compile", lambda out: pytest.fail("rebuilt"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.load() is not lib  # loaded again from the built file
    monkeypatch.setattr(native, "CC_FLAGS", ("-O2", "-shared", "-fPIC"))
    assert native.library_path() != path  # the flags are in the name


def test_a_failed_build_raises_with_the_compilers_output(fresh_build, monkeypatch):
    """No fallback: where `cc` fails, the loader and every caller raise
    RuntimeError; nothing falls back to numpy."""
    script = fresh_build.parent / "failing_cc"
    script.write_text("#!/bin/sh\necho 'fastpoints.c:1: error: no compiler here' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(native, "_compiler", lambda: str(script))
    with pytest.raises(RuntimeError, match=r"(?s)cc failed \(3\).*no compiler here"):
        native.load()
    raw = port_bag.serialize_pointcloud2(np.ones((5, 4), np.float32))
    with pytest.raises(RuntimeError, match="cc failed"):
        port_bag.parse_pointcloud2(raw)
    with pytest.raises(RuntimeError, match="cc failed"):
        port_lz4.lz4_frame_decompress(_GOOD)
    assert not os.path.exists(native.library_path())


def test_no_compiler_on_path_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.load()
