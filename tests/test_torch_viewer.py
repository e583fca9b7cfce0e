"""The live viewer against the reference: the port's JPEG encoder
(`serve/jpeg.py`) against `cv2.imencode`, the HTTP server, and
`view_dataset` against JAX's on the same files, the arrays each side pushes
to its windows captured by patching `LiveViewer.push`.

Tolerances: the encoder's bytes equal cv2's (libjpeg-turbo's, quality 88)
at every size tried, so they are held exactly, the stored golden's bytes
included. The pushed range view is equal; the BEV may differ by 1 grey
level (its density channel carries log1p's ulps, at most 1.526e-5 of 255,
ROADMAP Queue 3); the class mask of a network carried across
(`models/io.py`) may flip at most 0.1 % of its pixels (the FCN's sums run
in another order in the two frameworks, and a pixel whose probability
sits at 0.5 rounds either way).
"""

import ast
import os
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest

from tests.torch_golden import GOLDEN_VIEWER, REPO, load_npz, random_arrays
from tpufusion_torch._golden import (
    VIEWER_QUALITY,
    VIEWER_SHAPES,
    viewer_frame_digest,
    viewer_golden_frames,
)
from tpufusion_torch.serve import jpeg
from tpufusion_torch.serve import viewer as port_viewer


def _segments(data: bytes) -> dict:
    """marker -> list of the marker segments' bytes, up to the scan data."""
    out, i = {}, 2
    while True:
        marker, length = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        out.setdefault(marker, []).append(data[i:i + 2 + length])
        if marker == 0xDA:
            return out
        i += 2 + length


def _cv2_jpeg(frame: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, VIEWER_QUALITY])
    assert ok
    return bytes(buf)


def _frames():
    rng = np.random.default_rng(8)
    out = {}
    for shape in [(32, 1801, 3), (1199, 180, 3), (17, 23, 3), (31, 33, 3), (9, 16, 3), (1, 1, 3),
                  (32, 1801), (23, 17), (1, 1), (5, 7, 1)]:
        rows, cols = np.mgrid[:shape[0], :shape[1]]
        smooth = (np.sin(rows / 4.0) * np.cos(cols / 9.0) * 100 + 128).astype(np.int64)
        if len(shape) == 3:
            smooth = smooth[..., None] * np.arange(1, shape[2] + 1) % 256
        noise = rng.integers(-30, 31, shape)
        out[f"{shape} smooth"] = np.clip(smooth + noise, 0, 255).astype(np.uint8)
        out[f"{shape} noise"] = rng.integers(0, 256, shape, dtype=np.uint8)
    out["flat 255"] = np.full((24, 40, 3), 255, np.uint8)
    out["flat 0"] = np.zeros((24, 40), np.uint8)
    return out


FRAMES = _frames()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_jpeg_bytes_equal_cv2(name):
    """DQT, SOF0 and DHT segments, then every byte: the port's encoder
    writes what cv2 writes (4:2:0 for three channels, one component for
    grey); cv2 decodes it to the same pixels."""
    frame = FRAMES[name]
    got, want = jpeg.encode_jpeg(frame), _cv2_jpeg(frame)
    seg_got, seg_want = _segments(got), _segments(want)
    for marker in (0xE0, 0xDB, 0xC0, 0xC4, 0xDA):
        assert seg_got[marker] == seg_want[marker], hex(marker)
    assert got == want
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_UNCHANGED),
                                  cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_UNCHANGED))


def test_jpeg_sampling_is_the_reference_viewers():
    sof3 = _segments(jpeg.encode_jpeg(FRAMES["(17, 23, 3) noise"]))[0xC0][0]
    assert sof3[-10:] == bytes.fromhex("03012200021101031101")
    sof1 = _segments(jpeg.encode_jpeg(FRAMES["(23, 17) noise"]))[0xC0][0]
    assert sof1[-4:] == bytes.fromhex("01011100")


def test_golden_viewer_file_is_current():
    """tests/data/torch_port_golden_viewer.npz holds cv2's bytes of the
    seeded frames (rerun tests/make_torch_port_golden.py viewer if not);
    the port's encoder writes them, and cv2 decodes both alike."""
    golden = load_npz(GOLDEN_VIEWER)
    frames = viewer_golden_frames()
    assert [f.shape for f in frames] == list(VIEWER_SHAPES)
    assert [viewer_frame_digest(f) for f in frames] == golden["frame_sha256"].tolist()
    for i, frame in enumerate(frames):
        stored = golden[f"jpeg_{i}"].tobytes()
        assert stored == _cv2_jpeg(frame)
        ours = jpeg.encode_jpeg(frame)
        assert ours == stored
        decoded = cv2.imdecode(golden[f"jpeg_{i}"], cv2.IMREAD_UNCHANGED)
        assert decoded.shape == frame.shape
        np.testing.assert_array_equal(
            decoded, cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_UNCHANGED))


def test_jpeg_is_integer_arithmetic_only():
    """No float literal, no true division, no float dtype in the encoder:
    the bytes cannot depend on a machine's float rounding."""
    tree = ast.parse(open(os.path.join(REPO, "tpufusion_torch", "serve", "jpeg.py")).read())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.Constant) and isinstance(node.value, float)), node.lineno
        assert not isinstance(node, (ast.Div, ast.Pow)), node.lineno
        if isinstance(node, ast.Attribute):
            assert "float" not in node.attr, node.lineno
        if isinstance(node, ast.keyword):  # bincount's weights are float64
            assert node.arg != "weights", node.lineno


@pytest.mark.parametrize("frame", [np.zeros((8, 8), np.float32), np.zeros((8, 8, 2), np.uint8),
                                   np.zeros((0, 8, 3), np.uint8), np.zeros((4,), np.uint8)])
def test_jpeg_refuses_what_it_cannot_encode(frame):
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(frame)


def test_quant_tables_at_quality_88():
    luma = jpeg.quant_table(jpeg._LUMA_Q, 88)
    assert luma[:8].tolist() == [4, 3, 2, 4, 6, 10, 12, 15] and luma.max() <= 255
    with pytest.raises(ValueError):
        jpeg.quant_table(jpeg._LUMA_Q, 0)


def test_live_viewer_serves_frames_and_stream():
    """The reference's viewer test on the port: the index lists pushed
    windows, /frame returns the latest JPEG (cv2 reads the pushed frame's
    size from it), /stream yields an MJPEG part, an unknown window 404s."""
    frame = np.random.default_rng(0).uniform(0, 1, (32, 64, 3))
    with port_viewer.LiveViewer(port=0, host="127.0.0.1") as v:
        v.push("range_view", frame)
        base = f"http://127.0.0.1:{v.port}"
        html = urllib.request.urlopen(f"{base}/", timeout=5).read()
        assert b"range_view" in html
        jpg = urllib.request.urlopen(f"{base}/frame/range_view", timeout=5).read()
        assert jpg[:2] == b"\xff\xd8"
        assert cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_UNCHANGED).shape == (32, 64, 3)
        r = urllib.request.urlopen(f"{base}/stream/range_view", timeout=5)
        head = r.read(200)
        assert b"--frame" in head and b"image/jpeg" in head
        r.close()
        for path in ("/frame/nope", "/stream/nope", "/other"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}{path}", timeout=5)
            assert err.value.code == 404


def test_viewer_encodes_like_the_reference():
    """`_encode_jpeg` scales a float frame to 8 bits as the reference does
    and writes cv2's bytes."""
    from tpufusion.serve import viewer as jax_viewer

    frame = np.random.default_rng(1).uniform(-3, 9, (32, 181, 3)).astype(np.float32)
    assert port_viewer._encode_jpeg(frame) == jax_viewer._encode_jpeg(frame)
    flat = np.full((8, 8), 2.5)
    assert port_viewer._encode_jpeg(flat) == jax_viewer._encode_jpeg(flat)


# -- view_dataset against the reference's --------------------------------------------


def _capture(monkeypatch, module) -> list:
    pushed = []

    def push(self, name, frame):
        pushed.append((name, np.array(frame)))

    monkeypatch.setattr(module.LiveViewer, "push", push)
    return pushed


def _windows(pushed) -> dict:
    out = {}
    for name, frame in pushed:
        out.setdefault(name, []).append(frame)
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A raw points npz (3 frames, NaN padding), its extracted dir, and a
    seeded FCN(DEFAULT.model) as the port's .pt checkpoint and as the
    npz both packages load."""
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.data.etl import extract_dataset
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import load_arrays, save_state_npz
    from tpufusion_torch.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("view")
    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(4), 3, 8192)
    pts = np.where(valid[..., None], pts, np.nan).astype(np.float32)
    raw = str(root / "raw.npz")
    np.savez(raw, points=pts, timestamps=np.arange(3) * 100_000_000)
    ds = str(root / "ds")
    extract_dataset(ds, pts, np.arange(3) * 100_000_000, device="cpu")
    model = FCN(DEFAULT.model, in_channels=3, seed=0)
    load_arrays(model, random_arrays(model, 7))
    CheckpointManager(str(root / "ckpt")).save(0, model)
    save_state_npz(str(root / "weights.npz"), model)
    return {"raw": raw, "ds": ds, "ckpt": str(root / "ckpt"), "npz": str(root / "weights.npz")}


def _run_both(monkeypatch, path, dataset, with_model: bool):
    from tpufusion.models import io as jax_io
    from tpufusion.serve import viewer as jax_viewer
    from tpufusion.train import checkpoint as jax_checkpoint

    class NpzWeights:
        """The reference's CheckpointManager, restoring the npz the port
        wrote (`models/io.py`) in place of an orbax checkpoint."""

        def __init__(self, directory):
            pass

        def restore(self, model):
            jax_io.load_state_npz(dataset["npz"], model)

    monkeypatch.setattr(jax_checkpoint, "CheckpointManager", NpzWeights)
    ckpt = dataset["ckpt"] if with_model else None
    pushed_jax, pushed_port = _capture(monkeypatch, jax_viewer), _capture(monkeypatch, port_viewer)
    jax_viewer.view_dataset(path, checkpoint=ckpt, port=0, rate_hz=1000.0)
    port_viewer.view_dataset(path, checkpoint=ckpt, port=0, rate_hz=1000.0, device="cpu")
    return _windows(pushed_jax), _windows(pushed_port)


@pytest.mark.parametrize("source", ["raw", "ds"])
def test_view_dataset_pushes_the_references_frames(monkeypatch, dataset, source):
    want, got = _run_both(monkeypatch, dataset[source], dataset, with_model=source == "ds")
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["bev", "range_view"] if source == "raw" else ["class_mask", "range_view"])
    for name in got:
        assert len(got[name]) == len(want[name]) == 3, name
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape, name
            diff = np.abs(g.astype(int) - w)
            if name == "range_view":
                assert diff.max() == 0
            elif name == "bev":
                assert diff.max() <= 1
            else:
                flipped = (diff.max(axis=-1) > 0).mean()
                assert flipped <= 1e-3, flipped
                assert 0 < (g[..., 0] == 255).mean() < 1, "a constant class mask tests nothing"


def test_view_dataset_raw_with_a_checkpoint(monkeypatch, dataset):
    want, got = _run_both(monkeypatch, dataset["raw"], dataset, with_model=True)
    assert sorted(got) == sorted(want) == ["bev", "class_mask", "range_view"]
    for g, w in zip(got["class_mask"], want["class_mask"]):
        assert (np.abs(g.astype(int) - w).max(axis=-1) > 0).mean() <= 1e-3


def test_view_dataset_serves_over_http(dataset):
    """The reference's end-to-end viewer test on the port: one pass at a
    fast rate on an ephemeral port, the windows' JPEGs cached."""
    grabbed = {}
    orig_start = port_viewer.LiveViewer.start

    def start_and_grab(self):
        orig_start(self)
        grabbed["viewer"] = self
        return self

    port_viewer.LiveViewer.start = start_and_grab
    try:
        t = threading.Thread(target=port_viewer.view_dataset, args=(dataset["raw"],),
                             kwargs={"port": 0, "rate_hz": 1000.0, "device": "cpu"})
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        port_viewer.LiveViewer.start = orig_start
    frames = grabbed["viewer"]._frames
    assert set(frames) == {"range_view", "bev"}
    shape = cv2.imdecode(np.frombuffer(frames["range_view"], np.uint8), cv2.IMREAD_UNCHANGED).shape
    assert shape == (32, 1801, 3)
