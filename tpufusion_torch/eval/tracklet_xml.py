"""KITTI / boost-serialization tracklet XML, byte-compatible with the
reference emitter (`modules/lidar/common/tracklet_generator.py`) so the
challenge scorer accepts either.

Format quirks reproduced deliberately: tab indentation, %f (6-decimal)
floats, the class_id counter that advances once per pose even though only
the first pose item carries attributes, fixed `<state>1</state>` /
`occlusion -1` fields, and the trailing spaces after
`<item_version>1</item_version>` and `</boost_serialization>`.

The parser replaces the reference's xmljson+rosbag flow
(`modules/lidar/common/tracket_parser.py`) with xml.etree, returning the
same flattened per-frame pose dicts.

The port's copy of `tpufusion/eval/tracklet_xml.py` (numpy only);
`tests/test_torch_imports.py` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import IO


@dataclasses.dataclass
class Tracklet:
    object_type: str
    l: float
    w: float
    h: float
    first_frame: int = 0
    poses: list = dataclasses.field(default_factory=list)

    def write_xml(self, f: IO[str], class_id: int, tab: int = 0) -> int:
        def line(s: str, t: int) -> None:
            f.write("\t" * t + s + "\n")

        line(f'<item class_id="{class_id}" tracking_level="0" version="1">', tab)
        tab += 1
        class_id += 1
        line(f"<objectType>{self.object_type}</objectType>", tab)
        line("<h>%f</h>" % self.h, tab)
        line("<w>%f</w>" % self.w, tab)
        line("<l>%f</l>" % self.l, tab)
        line("<first_frame>%d</first_frame>" % self.first_frame, tab)
        line(f'<poses class_id="{class_id}" tracking_level="0" version="0">', tab)
        class_id += 1
        tab += 1
        line("<count>%d</count>" % len(self.poses), tab)
        line("<item_version>2</item_version>", tab)
        for i, p in enumerate(self.poses):
            if i == 0:
                line(
                    f'<item class_id="{class_id}" tracking_level="0" version="2">',
                    tab,
                )
            else:
                line("<item>", tab)
            tab += 1
            class_id += 1
            line("<tx>%f</tx>" % p["tx"], tab)
            line("<ty>%f</ty>" % p["ty"], tab)
            line("<tz>%f</tz>" % p["tz"], tab)
            line("<rx>%f</rx>" % p["rx"], tab)
            line("<ry>%f</ry>" % p["ry"], tab)
            line("<rz>%f</rz>" % p["rz"], tab)
            line("<state>1</state>", tab)
            line("<occlusion>-1</occlusion>", tab)
            line("<occlusion_kf>-1</occlusion_kf>", tab)
            line("<truncation>-1</truncation>", tab)
            line("<amt_occlusion>0.0</amt_occlusion>", tab)
            line("<amt_occlusion_kf>-1</amt_occlusion_kf>", tab)
            line("<amt_border_l>0.0</amt_border_l>", tab)
            line("<amt_border_r>0.0</amt_border_r>", tab)
            line("<amt_border_kf>-1</amt_border_kf>", tab)
            tab -= 1
            line("</item>", tab)
        tab -= 1
        line("</poses>", tab)
        line("<finished>1</finished>", tab)
        tab -= 1
        line("</item>", tab)
        return class_id


@dataclasses.dataclass
class TrackletCollection:
    tracklets: list = dataclasses.field(default_factory=list)

    def write_xml(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write('<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>\n')
            f.write("<!DOCTYPE boost_serialization>\n")
            f.write(
                '<boost_serialization signature="serialization::archive" '
                'version="9">\n'
            )
            f.write('<tracklets class_id="0" tracking_level="0" version="0">\n')
            tab = 1
            f.write("\t" * tab + "<count>%d</count>\n" % len(self.tracklets))
            f.write("\t" * tab + "<item_version>1</item_version> \n")
            class_id = 1
            for obj in self.tracklets:
                class_id = obj.write_xml(f, class_id, tab)
            f.write("</tracklets>\n")
            f.write("</boost_serialization> \n")


def parse_tracklet_xml(text_or_path: str) -> list[Tracklet]:
    """Parse tracklet XML (ours or the reference emitter's or KITTI's)."""
    if "\n" in text_or_path or "<" in text_or_path:
        text = text_or_path
    else:
        with open(text_or_path) as f:
            text = f.read()
    # boost's doctype confuses ElementTree; strip prolog lines
    lines = [
        ln
        for ln in text.splitlines()
        if not ln.startswith("<?xml") and not ln.startswith("<!DOCTYPE")
    ]
    root = ET.fromstring("\n".join(lines))
    tracklets_el = root.find("tracklets") if root.tag != "tracklets" else root
    out = []
    for item in tracklets_el.findall("item"):
        t = Tracklet(
            object_type=item.findtext("objectType", "Car"),
            l=float(item.findtext("l", "0")),
            w=float(item.findtext("w", "0")),
            h=float(item.findtext("h", "0")),
            first_frame=int(item.findtext("first_frame", "0")),
        )
        poses_el = item.find("poses")
        if poses_el is not None:
            for p in poses_el.findall("item"):
                t.poses.append(
                    {
                        k: float(p.findtext(k, "0"))
                        for k in ("tx", "ty", "tz", "rx", "ry", "rz")
                    }
                )
        out.append(t)
    return out


def flatten_tracklets(
    tracklets: list[Tracklet], timestamps: list[int] | None = None
) -> list[dict]:
    """Per-frame pose dicts with frame ids (and timestamps when given) —
    the shape the reference's clean_items_list + put_timestamps_with_frame_ids
    produce (`tracket_parser.py:19-93`)."""
    rows = []
    for t in tracklets:
        for i, p in enumerate(t.poses):
            frame = t.first_frame + i
            row = dict(p)
            row["frame"] = frame
            row["l"], row["w"], row["h"] = t.l, t.w, t.h
            if timestamps is not None and frame < len(timestamps):
                row["timestamp"] = int(timestamps[frame])
            rows.append(row)
    return rows
