"""Generic ROS1 message (de)serializer driven by embedded definitions
(a copy of `tpufusion/data/rosmsg.py`).

Every rosbag connection record embeds the full `.msg` definition text
(`message_definition` field), including all nested types. The reference
leaned on the ROS python stack to turn that into objects
(`modules/lidar/process/radar_tracks.py:10-33` duck-types the result);
here a small interpreter does the same without ROS: parse the definition
into field lists, then decode the little-endian wire format directly.

Supports all ROS primitive types, strings, time/duration, fixed and
variable-length arrays, and nested message types (resolved within the
definition blob, like rosbag does). This is what makes the radar-track
extraction work against real bags regardless of the exact Track layout —
the didi-competition radar message package was a git submodule the
reference never vendored, so the wire layout must come from the bag.
"""

from __future__ import annotations

import re
import struct

import numpy as np

_PRIMITIVES: dict[str, str] = {
    "bool": "<B",
    "int8": "<b", "uint8": "<B", "char": "<B", "byte": "<b",
    "int16": "<h", "uint16": "<H",
    "int32": "<i", "uint32": "<I",
    "int64": "<q", "uint64": "<Q",
    "float32": "<f", "float64": "<d",
}

_SEPARATOR = re.compile(r"^=+\s*$", re.MULTILINE)
_ARRAY = re.compile(r"^(?P<base>[\w/]+)\s*(\[(?P<len>\d*)\])?$")


class Field:
    __slots__ = ("name", "type", "array_len", "is_array")

    def __init__(self, name: str, type_: str, is_array: bool, array_len):
        self.name = name
        self.type = type_
        self.is_array = is_array
        self.array_len = array_len  # None = variable length


def parse_definition(text: str) -> dict[str, list[Field]]:
    """Definition blob -> {type name: [Field]}. The root type is stored
    under the key ''. Constants and comments are dropped."""
    sections = _SEPARATOR.split(text)
    out: dict[str, list[Field]] = {}
    for idx, section in enumerate(sections):
        lines = section.strip().splitlines()
        name = ""
        if idx > 0:
            # nested sections start with "MSG: pkg/Type"
            while lines and not lines[0].strip():
                lines = lines[1:]
            if lines and lines[0].strip().startswith("MSG:"):
                name = lines[0].split(":", 1)[1].strip()
                lines = lines[1:]
        fields: list[Field] = []
        for line in lines:
            line = line.split("#", 1)[0].strip()
            if not line or "=" in line:  # blank or constant
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            m = _ARRAY.match(parts[0])
            if not m:
                continue
            base = m.group("base")
            is_array = m.group(2) is not None
            alen = int(m.group("len")) if m.group("len") else None
            fields.append(Field(parts[1], base, is_array, alen))
        out[name] = fields
    return out


def _resolve(type_: str, defs: dict[str, list[Field]]) -> list[Field] | None:
    if type_ in _PRIMITIVES or type_ in ("string", "time", "duration"):
        return None
    if type_ in defs:
        return defs[type_]
    # unqualified references resolve by base name (rosbag semantics:
    # same-package first; the blob only contains reachable types)
    if type_ == "Header":
        type_ = "std_msgs/Header"
        if type_ in defs:
            return defs[type_]
    base = type_.rsplit("/", 1)[-1]
    for k, v in defs.items():
        if k.rsplit("/", 1)[-1] == base:
            return v
    raise KeyError(f"message type {type_!r} not found in definition")


def _decode_value(buf: bytes, pos: int, type_: str, defs):
    if type_ in _PRIMITIVES:
        fmt = _PRIMITIVES[type_]
        v = struct.unpack_from(fmt, buf, pos)[0]
        if type_ == "bool":
            v = bool(v)
        return v, pos + struct.calcsize(fmt)
    if type_ == "string":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return buf[pos : pos + n].decode(errors="replace"), pos + n
    if type_ in ("time", "duration"):
        sec, nsec = struct.unpack_from("<II" if type_ == "time" else "<ii", buf, pos)
        return sec * 1_000_000_000 + nsec, pos + 8
    sub = _resolve(type_, defs)
    return _decode_fields(buf, pos, sub, defs)


def _decode_fields(buf: bytes, pos: int, fields: list[Field], defs):
    out = {}
    for f in fields:
        if f.is_array:
            n = f.array_len
            if n is None:
                (n,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            if f.type in _PRIMITIVES and f.type != "bool":
                dt = np.dtype(_PRIMITIVES[f.type][1:]).newbyteorder("<")
                width = dt.itemsize
                vals = np.frombuffer(buf, dt, count=n, offset=pos)
                pos += n * width
                out[f.name] = vals
            else:
                items = []
                for _ in range(n):
                    v, pos = _decode_value(buf, pos, f.type, defs)
                    items.append(v)
                out[f.name] = items
        else:
            out[f.name], pos = _decode_value(buf, pos, f.type, defs)
    return out, pos


def decode_message(raw: bytes, definition: str) -> dict:
    """Deserialize a full message given its connection's definition text."""
    defs = parse_definition(definition)
    value, pos = _decode_fields(raw, 0, defs[""], defs)
    if pos != len(raw):
        raise ValueError(
            f"message decode consumed {pos} of {len(raw)} bytes"
        )
    return value


# ---- encoder (fixtures / bag writer) ----


def _encode_value(out: bytearray, v, type_: str, defs) -> None:
    if type_ in _PRIMITIVES:
        out += struct.pack(_PRIMITIVES[type_], int(v) if type_ == "bool" else v)
        return
    if type_ == "string":
        b = v.encode() if isinstance(v, str) else bytes(v)
        out += struct.pack("<I", len(b)) + b
        return
    if type_ in ("time", "duration"):
        sec, nsec = divmod(int(v), 1_000_000_000)
        out += struct.pack("<II" if type_ == "time" else "<ii", sec, nsec)
        return
    _encode_fields(out, v, _resolve(type_, defs), defs)


def _encode_fields(out: bytearray, value: dict, fields: list[Field], defs):
    for f in fields:
        v = value[f.name]
        if f.is_array:
            if f.array_len is None:
                out += struct.pack("<I", len(v))
            for item in v:
                _encode_value(out, item, f.type, defs)
        else:
            _encode_value(out, v, f.type, defs)


def encode_message(value: dict, definition: str) -> bytes:
    defs = parse_definition(definition)
    out = bytearray()
    _encode_fields(out, value, defs[""], defs)
    return bytes(out)
