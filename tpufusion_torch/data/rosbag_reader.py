"""Minimal ROS1 bag (format 2.0) reader + writer (a copy of
`tpufusion/data/rosbag_reader.py`; its codec is `tpufusion_torch/native/`).

The reference consumes `.bag` files through the ROS stack (rosbag,
sensor_msgs.point_cloud2, cv_bridge); none of that exists here, so this
module implements the bag container format directly: record framing,
chunk decompression (none/bz2/lz4), connection records, and
deserializers for the message types the pipeline needs —
sensor_msgs/PointCloud2, sensor_msgs/Image, and radar tracks (decoded
generically from the connection's embedded message definition via
tpufusion_torch.data.rosmsg, matching `radar_tracks.py:10-33`).

Format: http://wiki.ros.org/Bags/Format/2.0 — every record is
  <u32 header_len><header fields><u32 data_len><data>
with header fields serialized as <u32 len>name=value. op codes: 0x03 bag
header, 0x05 chunk, 0x07 connection, 0x02 message data, 0x04/0x06 index
records (skipped).

BagWriter emits a valid single-chunk uncompressed bag for fixtures/tests.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass

import numpy as np

from tpufusion_torch import native

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07


def _parse_header(buf: bytes) -> dict[str, bytes]:
    out = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        fld = buf[pos : pos + flen]
        pos += flen
        name, _, value = fld.partition(b"=")
        out[name.decode()] = value
    return out


def _iter_records(buf: bytes, pos: int = 0):
    n = len(buf)
    while pos + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        header = _parse_header(buf[pos : pos + hlen])
        pos += hlen
        (dlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        data = buf[pos : pos + dlen]
        pos += dlen
        yield header, data


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str = ""
    md5sum: str = ""
    message_definition: str = ""


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    timestamp: int  # nanoseconds
    raw: bytes
    definition: str = ""  # embedded .msg definition from the connection


def _iter_file_records(f):
    """Stream (header, data) records from an open bag file. Reads are
    bounded by one record (the largest is a chunk, a few MB) — the
    reader never holds the whole bag (real challenge bags are 10-20 GB)."""
    while True:
        head = f.read(4)
        if len(head) < 4:
            return
        (hlen,) = struct.unpack("<I", head)
        hbuf = f.read(hlen)
        dhead = f.read(4)
        if len(hbuf) < hlen or len(dhead) < 4:
            return  # truncated tail
        header = _parse_header(hbuf)
        (dlen,) = struct.unpack("<I", dhead)
        data = f.read(dlen)
        if len(data) < dlen:
            return
        yield header, data


class BagReader:
    def __init__(self, path: str):
        self._path = path
        with open(path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a ROS1 v2.0 bag: {magic!r}")
            self._start = f.tell()
        self.connections: dict[int, Connection] = {}

    def _handle_conn(self, header, data):
        cid = struct.unpack("<I", header["conn"])[0]
        fields = _parse_header(data)
        self.connections[cid] = Connection(
            conn_id=cid,
            topic=header["topic"].decode(),
            msg_type=fields.get("type", b"").decode(),
            md5sum=fields.get("md5sum", b"").decode(),
            message_definition=fields.get(
                "message_definition", b""
            ).decode(errors="replace"),
        )

    def _decompress_chunk(self, header, data) -> bytes:
        comp = header.get("compression", b"none").decode()
        if comp == "none":
            return data
        if comp == "bz2":
            return bz2.decompress(data)
        if comp == "lz4":
            from tpufusion_torch.data.lz4 import lz4_frame_decompress

            # the chunk record declares its uncompressed size: lets the
            # native decoder allocate once + treat it as a hard bound
            raw_size = header.get("size")
            return lz4_frame_decompress(
                data,
                struct.unpack("<I", raw_size)[0] if raw_size else None,
            )
        raise NotImplementedError(f"chunk compression {comp!r}")

    def _record_to_msg(self, header, data, topics) -> BagMessage | None:
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONN:
            self._handle_conn(header, data)
        elif op == _OP_MSG:
            cid = struct.unpack("<I", header["conn"])[0]
            sec, nsec = struct.unpack("<II", header["time"])
            conn = self.connections.get(cid)
            if conn is None:
                return None
            if topics and conn.topic not in topics:
                return None
            return BagMessage(
                topic=conn.topic,
                msg_type=conn.msg_type,
                timestamp=sec * 1_000_000_000 + nsec,
                raw=data,
                definition=conn.message_definition,
            )
        # 0x03/0x04/0x06 carry no messages
        return None

    def read_messages(self, topics=None):
        """Yields BagMessage in file order, streaming from disk: peak
        memory is one decompressed chunk, not the bag."""
        topics = set(topics) if topics else None
        with open(self._path, "rb") as f:
            f.seek(self._start)
            for header, data in _iter_file_records(f):
                if header.get("op", b"\x00")[0] == _OP_CHUNK:
                    payload = self._decompress_chunk(header, data)
                    del data
                    for h2, d2 in _iter_records(payload):
                        msg = self._record_to_msg(h2, d2, topics)
                        if msg is not None:
                            yield msg
                else:
                    msg = self._record_to_msg(header, data, topics)
                    if msg is not None:
                        yield msg


# ---- message deserializers ----

_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def _read_string(buf, pos):
    (n,) = struct.unpack_from("<I", buf, pos)
    return buf[pos + 4 : pos + 4 + n].decode(), pos + 4 + n


def _skip_std_header(buf, pos=0):
    pos += 4 + 8  # seq + stamp
    _, pos = _read_string(buf, pos)  # frame_id
    return pos


def parse_pointcloud2(
    raw: bytes, want=("x", "y", "z", "intensity"), use_native: bool = True
):
    """sensor_msgs/PointCloud2 -> (N, len(want)) float32 (NaN for absent
    fields). Replaces sensor_msgs.point_cloud2.read_points.

    Runs the fused C extractor (`tpufusion_torch/native/`, built at first
    use, no fallback); use_native=False runs the per-field numpy strided
    copy, its plain version, which the tests hold it against.
    """
    pos = _skip_std_header(raw)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (nfields,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    fields = []
    for _ in range(nfields):
        name, pos = _read_string(raw, pos)
        offset, datatype, count = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields.append((name, offset, datatype, count))
    (is_bigendian,) = struct.unpack_from("<B", raw, pos)
    pos += 1
    point_step, row_step = struct.unpack_from("<II", raw, pos)
    pos += 8
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4

    n = height * width
    by_name = {f[0]: f for f in fields}
    if is_bigendian:
        raise NotImplementedError("big-endian PointCloud2 not supported")
    for name, offset, datatype, _ in fields:
        if offset + np.dtype(_PF_DTYPES[datatype]).itemsize > point_step:
            raise ValueError(
                f"field {name!r} at offset {offset} exceeds point_step "
                f"{point_step}"
            )
    # organized clouds can pad rows: repack to a contiguous point buffer
    if height > 1 and row_step != width * point_step:
        rows2d = np.frombuffer(raw, np.uint8, count=dlen, offset=pos)
        rows2d = rows2d.reshape(height, row_step)[:, : width * point_step]
        raw = rows2d.tobytes()
        pos, dlen = 0, n * point_step

    if use_native:
        offsets, codes = [], []
        for name in want:
            if name in by_name:
                _, offset, datatype, _ = by_name[name]
                offsets.append(offset)
                codes.append(datatype)
            else:
                offsets.append(-1)
                codes.append(0)
        payload = np.frombuffer(raw, np.uint8, count=dlen, offset=pos)
        return native.unpack(payload, n, point_step, offsets, codes)

    data = np.frombuffer(raw, np.uint8, count=dlen, offset=pos)
    out = np.full((n, len(want)), np.nan, np.float32)
    rows = data[: n * point_step].reshape(n, point_step)
    for j, name in enumerate(want):
        if name not in by_name:
            continue
        _, offset, datatype, _ = by_name[name]
        dt = _PF_DTYPES[datatype]
        width_b = np.dtype(dt).itemsize
        col = rows[:, offset : offset + width_b].copy().view(dt)[:, 0]
        out[:, j] = col.astype(np.float32)
    return out


def pointcloud2_size(raw: bytes) -> int:
    """Number of points in a PointCloud2 payload without unpacking it
    (header-only walk) — the streaming extractor's pass-1 scan uses this
    to size its output memmaps."""
    pos = _skip_std_header(raw)
    height, width = struct.unpack_from("<II", raw, pos)
    return int(height) * int(width)


def parse_image(raw: bytes):
    """sensor_msgs/Image -> (H, W[, C]) uint8 array + encoding."""
    pos = _skip_std_header(raw)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    encoding, pos = _read_string(raw, pos)
    (_, step) = struct.unpack_from("<BI", raw, pos)
    pos += 5
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    data = np.frombuffer(raw, np.uint8, count=dlen, offset=pos)
    img = data.reshape(height, step)[:, : width * (step // max(width, 1))]
    channels = step // max(width, 1)
    if channels > 1:
        img = img.reshape(height, width, channels)
    else:
        img = img.reshape(height, width)
    return img, encoding


def parse_radar_tracks(msg: BagMessage) -> list[dict]:
    """/radar/tracks message -> list of per-track dicts with a timestamp,
    exactly the rows `radar_tracks.parse_msg` produced
    (`modules/lidar/process/radar_tracks.py:10-33`). The wire layout is
    interpreted from the connection's embedded message definition, so any
    RadarTracks-like type (a `tracks` array of flat records) decodes."""
    from tpufusion_torch.data.rosmsg import decode_message

    if not msg.definition:
        raise ValueError(
            f"connection for {msg.topic!r} carries no message definition"
        )
    decoded = decode_message(msg.raw, msg.definition)
    tracks = decoded.get("tracks")
    if tracks is None:
        raise ValueError(
            f"{msg.msg_type!r} has no 'tracks' field: {sorted(decoded)}"
        )
    out = []
    for tr in tracks:
        row = {"timestamp": msg.timestamp}
        row.update(
            {k: v for k, v in tr.items() if isinstance(v, (int, float, bool))}
        )
        out.append(row)
    return out


# A plausible didi-era RadarTracks definition (the real package lived in
# the unvendored didi-competition submodule); used by fixtures/tests. Real
# bags override this via their embedded definition.
RADAR_TRACKS_DEFINITION = """\
Header header
Track[] tracks
================================================================================
MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id
================================================================================
MSG: radar_driver/Track
uint8 status
uint8 number
float32 range
float32 rate
float32 accel
float32 angle
float32 width
float32 late_rate
bool moving
float32 power
float32 absolute_rate
"""


# ---- writer (fixtures / tests) ----


def _header_bytes(fields: dict[str, bytes]) -> bytes:
    parts = []
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        parts.append(struct.pack("<I", len(item)) + item)
    return b"".join(parts)


def _record(fields: dict[str, bytes], data: bytes) -> bytes:
    h = _header_bytes(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


class BagWriter:
    """Writes a valid v2.0 bag (compression none/bz2/lz4), splitting
    chunks at `chunk_threshold` bytes like rosbag's writer does — the
    streaming reader's peak memory is one decompressed chunk, so a
    single-chunk multi-GB bag would defeat it. Connection records are
    replayed at the head of every chunk (the reference reader tolerates
    re-definitions; ours overwrites idempotently)."""

    def __init__(self, compression: str = "none",
                 chunk_threshold: int = 4 << 20):
        if compression not in ("none", "bz2", "lz4"):
            raise ValueError(f"unsupported compression {compression!r}")
        self.compression = compression
        self.chunk_threshold = int(chunk_threshold)
        self._conns = b""  # connection records, replayed per chunk
        self._chunk = b""
        self._chunks: list[bytes] = []  # finished raw (uncompressed) chunks
        self._count = 0

    def _roll_chunk(self):
        if self._chunk:
            self._chunks.append(self._chunk)
            self._chunk = b""

    def add_connection(
        self, conn_id: int, topic: str, msg_type: str,
        message_definition: str = "",
    ):
        self._conns += _record(
            {
                "op": bytes([_OP_CONN]),
                "conn": struct.pack("<I", conn_id),
                "topic": topic.encode(),
            },
            _header_bytes(
                {
                    "type": msg_type.encode(),
                    "md5sum": b"0" * 32,
                    "message_definition": message_definition.encode(),
                }
            ),
        )

    def add_message(self, conn_id: int, t_ns: int, raw: bytes):
        sec, nsec = divmod(t_ns, 1_000_000_000)
        self._chunk += _record(
            {
                "op": bytes([_OP_MSG]),
                "conn": struct.pack("<I", conn_id),
                "time": struct.pack("<II", sec, nsec),
            },
            raw,
        )
        self._count += 1
        if len(self._chunk) >= self.chunk_threshold:
            self._roll_chunk()

    def write(self, path: str):
        self._roll_chunk()
        chunks = self._chunks or [b""]
        with open(path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            f.write(
                _record(
                    {
                        "op": bytes([_OP_BAGHDR]),
                        "index_pos": struct.pack("<Q", 0),
                        "conn_count": struct.pack("<I", 1),
                        "chunk_count": struct.pack("<I", len(chunks)),
                    },
                    b" " * 4096,  # bag headers are padded
                )
            )
            for raw in chunks:
                raw = self._conns + raw
                if self.compression == "bz2":
                    payload = bz2.compress(raw)
                elif self.compression == "lz4":
                    from tpufusion_torch.data.lz4 import lz4_frame_compress

                    payload = lz4_frame_compress(raw)
                else:
                    payload = raw
                f.write(
                    _record(
                        {
                            "op": bytes([_OP_CHUNK]),
                            "compression": self.compression.encode(),
                            "size": struct.pack("<I", len(raw)),
                        },
                        payload,
                    )
                )


def serialize_pointcloud2(points: np.ndarray, frame_id: str = "velodyne"):
    """(N, 4) float32 -> PointCloud2 raw bytes (x, y, z, intensity)."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    buf = struct.pack("<I", 0) + struct.pack("<II", 0, 0)
    buf += struct.pack("<I", len(frame_id)) + frame_id.encode()
    buf += struct.pack("<II", 1, n)  # height=1, width=n
    buf += struct.pack("<I", 4)
    for i, name in enumerate(("x", "y", "z", "intensity")):
        buf += struct.pack("<I", len(name)) + name.encode()
        buf += struct.pack("<IBI", i * 4, 7, 1)  # offset, FLOAT32, count
    buf += struct.pack("<B", 0)  # little endian
    buf += struct.pack("<II", 16, 16 * n)  # point_step, row_step
    raw = pts.tobytes()
    buf += struct.pack("<I", len(raw)) + raw
    buf += struct.pack("<B", 1)  # is_dense
    return buf


def serialize_image(img: np.ndarray, encoding: str = "mono8",
                    frame_id: str = "camera") -> bytes:
    """(H, W[, C]) uint8 -> sensor_msgs/Image raw bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    buf = struct.pack("<I", 0) + struct.pack("<II", 0, 0)
    buf += struct.pack("<I", len(frame_id)) + frame_id.encode()
    buf += struct.pack("<II", h, w)
    buf += struct.pack("<I", len(encoding)) + encoding.encode()
    buf += struct.pack("<BI", 0, w * c)  # is_bigendian, step
    raw = img.tobytes()
    buf += struct.pack("<I", len(raw)) + raw
    return buf


def serialize_radar_tracks(tracks: list[dict], t_ns: int = 0) -> bytes:
    """Track dicts -> RadarTracks raw bytes per RADAR_TRACKS_DEFINITION
    (fixture/test helper; fields default to 0)."""
    from tpufusion_torch.data.rosmsg import encode_message

    defaults = {
        "status": 0, "number": 0, "range": 0.0, "rate": 0.0, "accel": 0.0,
        "angle": 0.0, "width": 0.0, "late_rate": 0.0, "moving": False,
        "power": 0.0, "absolute_rate": 0.0,
    }
    msg = {
        "header": {"seq": 0, "stamp": t_ns, "frame_id": "radar"},
        "tracks": [{**defaults, **t} for t in tracks],
    }
    return encode_message(msg, RADAR_TRACKS_DEFINITION)


def extract_bag_points(
    bag_path: str, topic: str = "/velodyne_points"
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-bag read: (frames padded (F, Nmax, 4) with NaN, timestamps)."""
    reader = BagReader(bag_path)
    clouds, stamps = [], []
    for msg in reader.read_messages(topics=[topic]):
        clouds.append(parse_pointcloud2(msg.raw))
        stamps.append(msg.timestamp)
    if not clouds:
        return np.zeros((0, 0, 4), np.float32), np.zeros((0,), np.int64)
    nmax = max(len(c) for c in clouds)
    out = np.full((len(clouds), nmax, 4), np.nan, np.float32)
    for i, c in enumerate(clouds):
        out[i, : len(c)] = c
    return out, np.asarray(stamps, np.int64)
