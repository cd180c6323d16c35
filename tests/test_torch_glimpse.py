"""The port's Glimpse ingest (``tapqir_tpu_torch.imscroll``,
``csrc/glimpse_native.py``) against the original Tapqir's golden and the
JAX package's reader on the same raw folders: the golden's synthetic
folder, tests/test_glimpse.py's folder, two channels, a frame range and a
plain-text AOI table; frame reads, ``bin_hist``, the native decoder against
its numpy version, and ``data.tpqr`` read across the packages."""

import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import savemat

from tapqir_tpu.imscroll import GlimpseDataset as JaxGlimpseDataset
from tapqir_tpu.imscroll import bin_hist as jax_bin_hist
from tapqir_tpu.imscroll import read_glimpse as jax_read_glimpse
from tapqir_tpu.utils.dataset import load as jax_load
from tapqir_tpu.utils.dataset import save as jax_save
import tapqir_tpu_torch.csrc.native as native_layer
from tapqir_tpu_torch.csrc import glimpse_native
from tapqir_tpu_torch.imscroll import GlimpseDataset, bin_hist, read_glimpse
from tapqir_tpu_torch.imscroll.glimpse_reader import _load_header
from tapqir_tpu_torch.utils.dataset import load

GOLDEN = Path(__file__).resolve().parent / "golden"
sys.path.insert(0, str(GOLDEN))
from glimpse_synth import synthesize  # noqa: E402

FIELDS = ("images", "xy", "is_ontarget", "mask", "labels", "time1", "ttb")


@pytest.fixture(autouse=True)
def _no_plots(monkeypatch):
    monkeypatch.setenv("CI", "true")


def _write_raw(root, frames, aoi_on, aoi_off, drift, aoiinfo_frame=1, split=None,
               ttb=None, time1=12345.0):
    """A raw Glimpse folder under ``root``: ``frames`` (F, H, W) in one
    ``.glimpse`` file (two when ``split`` gives the first frame of the
    second), header.mat, the driftlist ``drift`` (F, 3) and the AOI tables
    of 0-based (y, x) centres ``aoi_on`` / ``aoi_off`` (MATLAB 1-based)."""
    gdir = root / "glimpse"
    gdir.mkdir(parents=True)
    F, H, W = frames.shape
    parts = [(0, range(F))] if split is None else [(0, range(split)), (1, range(split, F))]
    filenumber, offsets = [], []
    for number, fr in parts:
        with open(gdir / f"{number}.glimpse", "wb") as fh:
            for f in fr:
                filenumber.append(number)
                offsets.append(fh.tell())
                (frames[f] - 2**15).astype(">i2").tofile(fh)
    savemat(gdir / "header.mat", {"vid": {
        "height": H, "width": W, "nframes": F, "filenumber": np.asarray(filenumber),
        "offset": np.asarray(offsets),
        "ttb": np.arange(F) * 100.0 if ttb is None else ttb, "time1": time1}})
    savemat(root / "driftlist.mat", {"driftlist": drift})
    for name, centers in (("aoi_on.mat", aoi_on), ("aoi_off.mat", aoi_off)):
        rows = np.array([[aoiinfo_frame, 1.0, y + 1, x + 1, 7, i + 1]
                         for i, (y, x) in enumerate(centers)], float)
        savemat(root / name, {"aoiinfo2": rows})
    return {
        "name": root.name, "glimpse-folder": str(gdir),
        "driftlist": str(root / "driftlist.mat"),
        "ontarget-aoiinfo": str(root / "aoi_on.mat"),
        "offtarget-aoiinfo": str(root / "aoi_off.mat"),
        "ontarget-labels": None, "offtarget-labels": None,
    }


def _config(channels, **overrides):
    cfg = {"P": 14, "num-channels": len(channels), "dataset": "synthetic",
           "offset-P": 8, "bin-size": 1, "frame-range": False, "frame-start": None,
           "frame-end": None, "use-offtarget": True, "labels": False,
           "channels": channels, "offset-x": 0, "offset-y": 38}
    cfg.update(overrides)
    return cfg


def glimpse_test_folder(root):
    """tests/test_glimpse.py's folder: 48 x 64 frames, 6 frames in one
    file, no drift, 2 + 1 AOIs picked on frame 1."""
    H, W, F = 48, 64, 6
    rng = np.random.default_rng(0)
    frames = rng.integers(88, 93, size=(F, H, W))
    aoi_centers = [(20, 12), (30, 40)]
    for f in range(F):
        for y, x in aoi_centers:
            frames[f, y - 3 : y + 4, x - 3 : x + 4] += 400
    drift = np.zeros((F, 3))
    drift[:, 0] = np.arange(1, F + 1)
    on = [(y + 0.3, x + 0.4) for y, x in aoi_centers]
    ch = _write_raw(root, frames, on, [(10.3, 50.4)], drift)
    return _config([ch])


def drifting_folder(root, seed, n_frames=9, anchor=4, split=5):
    """A folder with fractional drift around the middle frame, two files,
    hot pixels and 3 + 2 AOIs."""
    H, W = 48, 64
    rng = np.random.default_rng(seed)
    frames = rng.integers(88, 97, size=(n_frames, H, W))
    frames += np.where(rng.random(frames.shape) > 0.995, rng.integers(40, 200, frames.shape),
                       0)
    on = [(20.3, 12.4), (30.7, 40.2), (14.1, 52.6)]
    for f in range(n_frames):
        for y, x in on:
            frames[f, round(y) - 3 : round(y) + 4, round(x) - 3 : round(x) + 4] += 300
    drift = np.column_stack([np.arange(1, n_frames + 1),
                             rng.uniform(-0.2, 0.2, (n_frames, 2))])
    ch = _write_raw(root, frames, on, [(10.2, 30.8), (36.4, 18.3)], drift,
                    aoiinfo_frame=anchor, split=split, ttb=np.arange(n_frames) * 50.0 + seed,
                    time1=1000.0 + seed)
    return ch


def golden_folder(root):
    return synthesize(root)


def two_channel_folder(root):
    return _config([drifting_folder(root / "green", 1), drifting_folder(root / "red", 2)],
                   **{"offset-x": 2, "offset-y": 36, "offset-P": 10, "bin-size": 2})


def frame_range_folder(root):
    return _config([drifting_folder(root / "blue", 3)],
                   **{"frame-range": True, "frame-start": 3, "frame-end": 7,
                      "offset-x": 2, "offset-y": 36, "offset-P": 10})


def text_table_folder(root):
    cfg = _config([drifting_folder(root / "blue", 4)], **{"use-offtarget": False})
    ch = cfg["channels"][0]
    rows = np.array([[4, 1.0, y + 1, x + 1, 7, i + 1]
                     for i, (y, x) in enumerate([(20.3, 12.4), (30.7, 40.2)])])
    np.savetxt(root / "aoi_on.dat", rows)
    ch["ontarget-aoiinfo"] = str(root / "aoi_on.dat")
    ch["offtarget-aoiinfo"] = None
    return cfg


FOLDERS = {
    "golden": golden_folder,
    "test_glimpse": glimpse_test_folder,
    "two-channel": two_channel_folder,
    "frame-range": frame_range_folder,
    "text-table": text_table_folder,
}


def _assert_same_dataset(got, want):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("samples", "weights"):
        a, b = getattr(got.offset, k), getattr(want.offset, k)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.name == want.name and got.channels == want.channels


def test_read_glimpse_matches_reference(tmp_path):
    """The original Tapqir's output on the golden's folder, at
    tests/test_reference_goldens.py's tolerances."""
    data = read_glimpse(tmp_path, **synthesize(tmp_path))
    ref = dict(np.load(GOLDEN / "reference_glimpse.npz"))
    np.testing.assert_array_equal(data.images, ref["images"])
    np.testing.assert_allclose(data.xy, ref["xy"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(data.is_ontarget, ref["is_ontarget"].astype(bool))
    for field in ("z", "spotpicker", "aoi", "frame"):
        np.testing.assert_array_equal(data.labels[field], ref[f"labels_{field}"])
    np.testing.assert_array_equal(data.offset.samples, ref["offset_samples"])
    np.testing.assert_allclose(data.offset.weights, ref["offset_weights"], rtol=1e-6)
    assert abs(float(data.offset.weights.sum()) - 1.0) < 1e-9
    np.testing.assert_allclose(data.time1, ref["time1"])
    np.testing.assert_allclose(data.ttb, ref["ttb"])


@pytest.mark.parametrize("folder", list(FOLDERS))
def test_read_glimpse_matches_jax(tmp_path, folder):
    """Every array and dtype of the dataset, the float64 offset weights
    included, equal to the JAX package's reader on the same folder."""
    cfg = FOLDERS[folder](tmp_path / "raw")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = read_glimpse(tmp_path / "port", **cfg)
    want = jax_read_glimpse(tmp_path / "jax", **cfg)
    _assert_same_dataset(got, want)
    _assert_same_dataset(load(tmp_path / "port"), want)
    if folder == "frame-range":
        assert got.F == 5
    if folder == "two-channel":
        assert got.C == 2 and got.ttb.shape == (9, 2) and got.time1.tolist() == [1001, 1002]


def test_glimpse_dataset_matches_jax(tmp_path):
    cfg = synthesize(tmp_path)
    kwargs = {k: v for k, v in cfg.items()
              if k not in ("P", "num-channels", "dataset", "offset-P", "bin-size", "channels")}
    g = GlimpseDataset(**kwargs, **cfg["channels"][0])
    j = JaxGlimpseDataset(**kwargs, **cfg["channels"][0])
    assert (g.N, g.Nc, g.F, len(g), g.height, g.width) == (j.N, j.Nc, j.F, len(j), 48, 64)
    assert repr(g) == repr(j)
    np.testing.assert_array_equal(g.frames, j.cumdrift.index.values)
    np.testing.assert_array_equal(g.cumdrift, j.cumdrift[["dx", "dy"]].values)
    np.testing.assert_array_equal(g.ttb, j.cumdrift["ttb"].values)
    for dtype in ("ontarget", "offtarget"):
        np.testing.assert_array_equal(g.aoiinfo[dtype].aoi, j.aoiinfo[dtype].index.values)
        np.testing.assert_array_equal(g.aoiinfo[dtype].xy, j.aoiinfo[dtype][["x", "y"]].values)
        np.testing.assert_array_equal(g.labels[dtype], j.labels[dtype])
    for key in (2, 9, slice(2, 11), slice(1, 12, 3)):
        got, want = g[key], j[key]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # frames 1-7 and 8-12 live in two files: a batch across both
    np.testing.assert_array_equal(g.read_frames([12, 1, 7, 8]), j.read_frames([12, 1, 7, 8]))


@pytest.mark.parametrize("n, s", [(10, 3), (10, 1), (17, 2), (9, 4), (1, 3), (6, 10)])
def test_bin_hist_matches_jax(n, s):
    rng = np.random.default_rng(n * s)
    samples = np.sort(rng.choice(200, n, replace=False)) + 80
    weights = rng.random(n)
    weights /= weights.sum()
    got, want = bin_hist(samples, weights, s), jax_bin_hist(samples, weights, s)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0][0] == samples[0] and got[1][0] == weights[0]  # the first sample whole
    np.testing.assert_allclose(got[1].sum(), 1.0)


def test_native_decoder_matches_numpy(tmp_path):
    """read_frame (as stored), read_frames (shifted) and crop_aois of the
    native decoder against np.fromfile and slicing, on every frame of both
    files of the golden's folder."""
    synthesize(tmp_path)
    gdir = tmp_path / "glimpse"
    header = _load_header(gdir)
    numbers, offsets = header["filenumber"], header["offset"].astype(np.int64)
    H, W = int(header["height"]), int(header["width"])
    for number in (0, 1):
        path = gdir / f"{number}.glimpse"
        offs = offsets[numbers == number]
        native = glimpse_native.read_frames(path, offs, H, W)
        np.testing.assert_array_equal(native, glimpse_native.read_frames_plain(path, offs, H, W))
        with open(path, "rb") as fid:
            fid.seek(int(offs[-1]))
            stored = np.fromfile(fid, dtype=">i2", count=H * W).reshape(H, W)
        one = glimpse_native.read_frame(path, offs[-1], H, W)
        assert one.dtype == native.dtype == np.int32
        np.testing.assert_array_equal(one, stored)  # unshifted, as the JAX package's
        np.testing.assert_array_equal(native[-1], stored.astype(np.int32) + 2**15)
    crops = glimpse_native.crop_aois(native[0], [5, 20, 50], [3, 10, 34], 14)
    for crop, (sx, sy) in zip(crops, [(5, 3), (20, 10), (50, 34)]):
        np.testing.assert_array_equal(crop, native[0][sy : sy + 14, sx : sx + 14])


def test_native_decoder_raises_and_never_falls_back(tmp_path, monkeypatch):
    """A missing file, a frame past the end of the file, a crop outside
    the frame and a failed build raise with the reader's or g++'s
    message."""
    synthesize(tmp_path)
    path = tmp_path / "glimpse" / "0.glimpse"
    with pytest.raises(OSError, match="cannot open the file .No such file"):
        glimpse_native.read_frames(tmp_path / "missing.glimpse", [0], 48, 64)
    with pytest.raises(OSError, match="ends before the frame"):
        glimpse_native.read_frames(path, [path.stat().st_size - 10], 48, 64)
    with pytest.raises(OSError, match="ends before the frame"):
        glimpse_native.read_frames_plain(path, [path.stat().st_size - 10], 48, 64)
    with pytest.raises(ValueError, match="outside"):
        glimpse_native.crop_aois(np.zeros((48, 64), np.int32), [60], [0], 14)

    broken = tmp_path / "broken.cpp"
    broken.write_text("int read_frame_i32( {\n")
    monkeypatch.setattr(native_layer, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native_layer, "LIBRARIES", [])  # not in the process's registry
    monkeypatch.setattr(glimpse_native, "library", native_layer.Library(
        broken, "glimpse_io", glimpse_native.library.signatures, use_errno=True))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error:"):
        glimpse_native.read_frames(path, [0], 48, 64)
    assert list((tmp_path / "build").iterdir()) == []  # no half-built file left
    # the reader goes through the native decoder: no quiet numpy fallback
    cfg = synthesize(tmp_path / "again")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        read_glimpse(tmp_path / "again", **cfg)
    assert not (tmp_path / "again" / "data.tpqr").exists()


def test_native_build_lands_in_build_dir(tmp_path):
    lib = glimpse_native.library
    lib.get()
    assert lib.path.parent == Path(glimpse_native.__file__).resolve().parent.parent / "_build"
    assert lib.path.name.startswith("libglimpse_io_") and lib.path.suffix == ".so"


def test_data_tpqr_across_packages(tmp_path):
    """The JAX package's load reads the port's data.tpqr, and the port's
    load the JAX package's, array for array and dtype for dtype."""
    cfg = synthesize(tmp_path / "raw")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = read_glimpse(tmp_path / "port", **cfg)
    jax_data = jax_read_glimpse(tmp_path / "jax", **cfg)
    _assert_same_dataset(jax_load(tmp_path / "port"), port)
    _assert_same_dataset(load(tmp_path / "jax"), jax_data)
    # and a dataset the JAX package saved itself, without labels
    jax_data.labels = None
    jax_save(jax_data, tmp_path / "jax" / "nolabels.tpqr")
    _assert_same_dataset(load(tmp_path / "jax" / "nolabels.tpqr"), jax_data)


def test_dataset_members_match_jax(tmp_path):
    """x, y, vmin, vmax (float32 quantiles, cached) and fetch of the port's
    CosmosDataset against the JAX package's on two channels."""
    cfg = two_channel_folder(tmp_path / "raw")
    port = read_glimpse(tmp_path, **cfg)
    want = jax_load(tmp_path)
    np.testing.assert_array_equal(port.x, want.x)
    np.testing.assert_array_equal(port.y, want.y)
    for k in ("vmin", "vmax"):
        got = getattr(port, k)
        assert got.dtype == getattr(want, k).dtype == np.float32 and got.shape == (2,)
        np.testing.assert_array_equal(got, getattr(want, k))
        assert getattr(port, k) is got  # cached
    ndx, fdx, cdx = [0, 4, 2], [8, 0], [1]
    for a, b in zip(port.fetch(ndx, fdx, cdx), want.fetch(ndx, fdx, cdx)):
        np.testing.assert_array_equal(a, b)
