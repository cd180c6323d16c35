"""Glimpse ingest: extract AOIs from raw Glimpse movies into ``data.tpqr``
(the port's copy of tapqir_tpu/imscroll/glimpse_reader.py, in numpy and
scipy without pandas).

The file formats and the arithmetic are the JAX package's:

* ``header.mat`` (the MATLAB ``vid`` struct); a driftlist of per-frame
  (dy, dx) increments, made cumulative relative to the frame the AOIs were
  picked on; AOI tables (``aoiinfo2`` or ``aoifits`` in a .mat file, or a
  plain-text export); optional spot-picker label intervals;
* raw frames: big-endian int16 at per-frame byte offsets of
  ``<filenumber>.glimpse``, shifted by 2^15, decoded by the native decoder
  (``csrc/glimpse_native.py``) in chunks of ``FRAME_CHUNK`` frames with
  one open per file;
* P x P AOI crops at banker's-rounded drift-corrected corners, and the
  sub-pixel target inside each crop;
* the offset histogram of a dark region of the field of view: the
  min-data floor bin, the trim above a cumulative weight of 0.995 and
  ``bin_hist`` thinning, in float64.

Where the JAX package keeps pandas DataFrames, an AOI table is an
:class:`AoiTable` (an id array and float columns) and the cumulative drift
a frame-number array beside an (F, 2) array. The QC plots need
matplotlib; they are skipped under the ``CI`` environment variable, and
without matplotlib with a logged warning, as in the JAX package.
"""

import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
from scipy.io import loadmat

from tapqir_tpu_torch.csrc import glimpse_native
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData, save

logger = logging.getLogger(__name__)

__all__ = ["AoiTable", "bin_hist", "GlimpseDataset", "read_glimpse"]

AOI_COLUMNS = ["frame", "ave", "y", "x", "pixnum", "aoi"]

# spot-picker interval codes (Friedman-Gelles): absent vs present
_SPOTPICKER_ABSENT = (-2.0, 0.0, 2.0)
_SPOTPICKER_PRESENT = (-3.0, 1.0, 3.0)

# frames decoded per batch in read_glimpse; bounds the raw frames held in
# memory at FRAME_CHUNK * H * W * 4 bytes (64 * 512 * 512 * 4 = 64 MiB)
FRAME_CHUNK = 64


def bin_hist(samples: np.ndarray, weights: np.ndarray, s: int):
    """Thin an offset histogram: keep the first sample intact, then merge
    every ``s`` consecutive samples into one bin represented by its middle
    sample."""
    samples = np.asarray(samples)
    weights = np.asarray(weights)
    tail_s, tail_w = samples[1:], weights[1:]
    if len(tail_s) == 0:
        return samples.astype(int), np.asarray(weights, dtype=float)
    edges = np.arange(0, len(tail_s), s)
    sizes = np.diff(np.append(edges, len(tail_s)))
    representatives = tail_s[edges + sizes // 2]
    merged_w = np.add.reduceat(np.asarray(tail_w, dtype=float), edges)
    new_samples = np.concatenate([samples[:1], representatives]).astype(int)
    new_weights = np.concatenate([np.asarray(weights[:1], float), merged_w])
    return new_samples, new_weights


@dataclass(frozen=True)
class AoiTable:
    """AOI locations: ``aoi`` the (N,) integer ids, the other columns of
    ``AOI_COLUMNS`` (N,) floats, with ``x`` and ``y`` 0-based pixels."""

    aoi: np.ndarray
    frame: np.ndarray
    ave: np.ndarray
    y: np.ndarray
    x: np.ndarray
    pixnum: np.ndarray

    def __len__(self):
        return len(self.aoi)

    @property
    def xy(self) -> np.ndarray:
        """(N, 2) target coordinates (x, y)."""
        return np.stack([self.x, self.y], -1)


def _load_header(folder):
    """``header.mat`` holds a MATLAB ``vid`` struct; flatten it to a dict."""
    record = loadmat(Path(folder) / "header.mat")["vid"][0, 0]
    return {name: np.squeeze(record[name]) for name in record.dtype.names}


def _load_aoi_table(path) -> AoiTable:
    """AOI locations from any of the three formats in the wild: an
    ``aoiinfo2`` matrix in a .mat file, an ``aoifits`` struct wrapping it,
    or a plain-text export. MATLAB's 1-based coordinates become 0-based."""
    try:
        mat = loadmat(path)
    except ValueError:
        rows = np.loadtxt(path)  # plain-text .dat export
    else:
        if "aoiinfo2" in mat:
            rows = mat["aoiinfo2"]
        elif "aoifits" in mat:
            rows = mat["aoifits"]["aoiinfo2"][0, 0]
        else:
            raise ValueError(f"{path}: no aoiinfo2/aoifits variable in .mat file")
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != len(AOI_COLUMNS):
        raise ValueError(f"{path}: an AOI table has {len(AOI_COLUMNS)} columns "
                         f"{AOI_COLUMNS}, got an array of shape {rows.shape}")
    col = dict(zip(AOI_COLUMNS, rows.T))
    return AoiTable(
        aoi=col["aoi"].astype(int),
        frame=col["frame"],
        ave=col["ave"],
        y=col["y"] - 1.0,  # MATLAB 1-based -> python 0-based pixels
        x=col["x"] - 1.0,
        pixnum=col["pixnum"],
    )


def _cumulative_drift(deltas: np.ndarray, anchor_pos: int) -> np.ndarray:
    """Per-frame drift increments -> drift relative to the anchor frame.

    Frames after the anchor accumulate forward, frames before it backward
    (negated); the anchor row keeps its raw increment, as the JAX package's
    (and the original Tapqir's) slicing arithmetic does.
    """
    cum = np.empty_like(deltas)
    cum[anchor_pos] = deltas[anchor_pos]
    cum[anchor_pos + 1 :] = np.cumsum(deltas[anchor_pos + 1 :], axis=0)
    if anchor_pos > 0:
        cum[:anchor_pos] = -np.cumsum(deltas[anchor_pos:0:-1], axis=0)[::-1]
    return cum


def _decode_spotpicker_labels(path, aoi_ids, frame_ids):
    """Spot-picker ``Intervals`` as a structured (N, F) label array with
    aoi / frame / z / spotpicker fields."""
    intervals = loadmat(path)["Intervals"]["CumulativeIntervalArray"][0, 0]
    aoi_ids = np.asarray(aoi_ids)
    frame_ids = np.asarray(frame_ids)
    row_of = {int(a): i for i, a in enumerate(aoi_ids)}
    z = np.zeros((len(aoi_ids), len(frame_ids)))
    for interval in intervals:
        code, start, stop, aoi = (
            float(interval[0]),
            int(interval[1]),
            int(interval[2]),
            int(interval[-1]),
        )
        row = row_of.get(aoi)
        if row is None:
            continue
        in_range = (frame_ids >= start) & (frame_ids <= stop)
        if code in _SPOTPICKER_ABSENT:
            z[row, in_range] = 0
        elif code in _SPOTPICKER_PRESENT:
            z[row, in_range] = 1
    labels = np.zeros(
        z.shape,
        dtype=[("aoi", int), ("frame", int), ("z", bool), ("spotpicker", float)],
    )
    labels["aoi"] = aoi_ids[:, None]
    labels["frame"] = frame_ids
    labels["spotpicker"] = z
    labels["z"] = z
    return labels


class GlimpseDataset:
    """One channel's raw movie: the header, the AOI tables, the cumulative
    drift and the optional label intervals.

    Config keys (hyphenated, as persisted in config.yaml): glimpse-folder,
    ontarget-aoiinfo, offtarget-aoiinfo, use-offtarget, driftlist,
    frame-range, frame-start, frame-end, labels, ontarget-labels,
    offtarget-labels, offset-x, offset-y, name.

    ``frames`` holds the (F,) 1-based frame numbers kept, ``cumdrift`` the
    (F, 2) cumulative drift (dx, dy) of each and ``ttb`` its time stamp. A
    frame range keeps the frames ``frame-start <= frame <= frame-end`` (the
    driftlist's frame numbers ascend).
    """

    def __init__(self, c=0, **kwargs):
        dtypes = ["ontarget"] + (["offtarget"] if kwargs.get("use-offtarget") else [])
        header = _load_header(kwargs["glimpse-folder"])
        aoiinfo = {dtype: _load_aoi_table(kwargs[f"{dtype}-aoiinfo"]) for dtype in dtypes}

        raw_drift = loadmat(kwargs["driftlist"])["driftlist"][:, :3]
        frames = raw_drift[:, 0].astype(int)
        # drift relative to the frame the AOIs were picked on
        aoiinfo_frame = int(aoiinfo["ontarget"].frame[0])
        anchor_pos = int(np.nonzero(frames == aoiinfo_frame)[0][0])
        # driftlist columns are (frame, dy, dx)
        cum_dydx = _cumulative_drift(raw_drift[:, 1:3], anchor_pos)
        ttb = np.atleast_1d(header["ttb"])
        if len(ttb) != len(frames):
            raise ValueError(f"header.mat has {len(ttb)} time stamps (ttb) for the "
                             f"driftlist's {len(frames)} frames")
        keep = np.ones(len(frames), bool)
        if kwargs.get("frame-range"):
            keep = (frames >= int(kwargs["frame-start"])) & (frames <= int(kwargs["frame-end"]))

        self.frames = frames[keep]
        self.cumdrift = cum_dydx[keep][:, ::-1]  # (dx, dy)
        self.ttb = ttb[keep]
        labels = {dtype: None for dtype in dtypes}
        if kwargs.get("labels"):
            for dtype in dtypes:
                if kwargs.get(f"{dtype}-labels") is not None:
                    labels[dtype] = _decode_spotpicker_labels(
                        kwargs[f"{dtype}-labels"], aoiinfo[dtype].aoi, self.frames)

        self.height, self.width = int(header["height"]), int(header["width"])
        self.config = kwargs
        self.header = header
        self.dtypes = dtypes
        self.aoiinfo = aoiinfo
        self.labels = labels
        self.name = kwargs.get("name")
        self.c = c
        self.offset_x = kwargs["offset-x"]
        self.offset_y = kwargs["offset-y"]

    def __len__(self):
        return self.F

    def read_frames(self, frames) -> np.ndarray:
        """Decode a batch of raw frames (1-based frame numbers), grouped by
        Glimpse file so that each file is opened once. Returns (B, H, W)
        int32 with the 2^15 unsigned shift applied."""
        frames = np.atleast_1d(np.asarray(frames, dtype=int))
        file_numbers = np.atleast_1d(self.header["filenumber"])[frames - 1]
        byte_offsets = np.atleast_1d(self.header["offset"])[frames - 1].astype(np.int64)
        out = np.empty((len(frames), self.height, self.width), dtype=np.int32)
        folder = Path(self.config["glimpse-folder"])
        for number in np.unique(file_numbers):
            in_file = file_numbers == number
            out[in_file] = glimpse_native.read_frames(
                folder / f"{number}.glimpse", byte_offsets[in_file], self.height,
                self.width)
        return out

    def __getitem__(self, key):
        """Raw frame(s) by 1-based frame number; a slice gives a batch."""
        if isinstance(key, slice):
            step = 1 if key.step is None else key.step
            return self.read_frames(np.arange(key.start, key.stop, step))
        return self.read_frames(key)[0]

    @property
    def N(self):
        return len(self.aoiinfo["ontarget"])

    @property
    def Nc(self):
        return len(self.aoiinfo["offtarget"]) if "offtarget" in self.dtypes else 0

    @property
    def F(self):
        return len(self.frames)

    def __repr__(self):
        return f"{self.__class__.__name__}(N={self.N}, Nc={self.Nc}, F={self.F})"

    def plot(self, dtypes, P, n=None, f=0, save=False, path=None, ax=None,
             item=None, title=None):
        """The field of view of frame index ``f`` with the AOIs' (or the
        offset region's) rectangles. Never fails the pipeline: a failure,
        matplotlib missing included, is a logged warning."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from matplotlib.patches import Rectangle

            colors = {"ontarget": "#AA3377", "offtarget": "#CCBB44"}
            if ax is None:
                fig = plt.figure(figsize=(10, 10 * self.height / self.width))
                ax = fig.add_subplot(1, 1, 1)
            fov = self[int(self.frames[f])]
            vmin, vmax = np.percentile(fov, 1), np.percentile(fov, 99)
            ax.imshow(fov, vmin=vmin, vmax=vmax, cmap="gray")
            dx, dy = self.cumdrift[f]
            for dtype in dtypes:
                if dtype in ("ontarget", "offtarget"):
                    table = self.aoiinfo[dtype]
                    for x, y in zip(table.x, table.y):
                        y_pos = round(y + dy - 0.5 * (P - 1)) - 0.5
                        x_pos = round(x + dx - 0.5 * (P - 1)) - 0.5
                        ax.add_patch(Rectangle((x_pos, y_pos), P, P, edgecolor=colors[dtype],
                                               lw=1, facecolor="none"))
                elif dtype == "offset":
                    ax.add_patch(Rectangle((self.offset_x, self.offset_y), P, P,
                                           edgecolor="#CCBB44", lw=1, facecolor="none"))
            ax.set_title(title or f"AOI {n}, Frame {f}", fontsize=9)
            if save and path is not None:
                plt.savefig(Path(path) / f"{dtypes[0]}-channel{self.c}.png", dpi=300)
            plt.close("all")
        except Exception as err:  # plotting must never fail the pipeline
            logger.warning(f"FOV plotting failed: {err}")


def _crop_all_aois(img, raw_xy_f, P):
    """P x P crops of every AOI of one frame.

    :param img: (H, W) frame.
    :param raw_xy_f: (N, 2) drift-corrected float target positions (x, y).
    :return: crops (N, P, P) and sub-pixel targets (N, 2).
    """
    # banker's rounding, as the original Tapqir's python round()
    shift = np.round(raw_xy_f - 0.5 * (P - 1)).astype(int)  # (N, 2) x, y
    rows = shift[:, 1][:, None, None] + np.arange(P)[None, :, None]
    cols = shift[:, 0][:, None, None] + np.arange(P)[None, None, :]
    return img[rows, cols], raw_xy_f - shift


def _plot_offset_qc(path, offset_samples, offset_weights, offset_medians, images, vmax):
    """The offset and per-channel pixel distributions and the offset's
    median per frame; a failure (matplotlib missing included) is a logged
    warning."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(3, 3))
        plt.bar(offset_samples, offset_weights, alpha=0.5, label="Offset")
        for c in range(images.shape[2]):
            vals, counts = np.unique(images[:, :, c], return_counts=True)
            plt.bar(vals, counts / counts.sum(), alpha=0.5, label=f"Channel {c}")
        plt.title("Empirical Distribution")
        plt.xlim(offset_samples.min(), float(vmax.max()))
        plt.legend()
        plt.tight_layout()
        plt.savefig(path / "offset-distribution.png", dpi=300)

        plt.figure(figsize=(5, 3))
        plt.plot(offset_medians, label="Offset Median")
        plt.title("Offset drift")
        plt.ylim(offset_samples.min(), offset_samples.max())
        plt.legend()
        plt.tight_layout()
        plt.savefig(path / "offset-medians.png", dpi=300)
        plt.close("all")
    except Exception as err:  # plotting must never fail the pipeline
        logger.warning(f"QC plotting failed: {err}")


def read_glimpse(path, progress_bar=None, stage_seconds=None, **kwargs):
    """Extract the AOIs of every channel into a :class:`CosmosDataset`,
    save it as ``<path>/data.tpqr`` and return it.

    ``kwargs`` are the ``glimpse`` command's config keys (``P``,
    ``num-channels``, ``dataset``, ``channels``, ``offset-P``, ``bin-size``
    and those of :class:`GlimpseDataset`). ``progress_bar``, if given, is
    called with the frame numbers of each channel and advanced per frame.
    ``stage_seconds``, if given, is a dict that receives the wall seconds of
    each stage: parse, decode, crop, histogram, assemble and save."""
    if progress_bar is None:
        progress_bar = lambda it: it  # noqa: E731
    seconds = {} if stage_seconds is None else stage_seconds
    seconds.update(dict.fromkeys(
        ("parse", "decode", "crop", "histogram", "assemble", "save"), 0.0))
    path = Path(path)
    P = kwargs.pop("P")
    C = kwargs.pop("num-channels")
    name = kwargs.pop("dataset", None)
    channels = kwargs.pop("channels")
    offset_P = kwargs.pop("offset-P")
    bin_size = kwargs.pop("bin-size")
    plots = not os.environ.get("CI")

    offset_counts = {}
    offset_medians = []
    data = {}
    target_xy = {}
    labels = {}
    time1 = []
    ttb = []
    for c in range(C):
        logger.info(f"Channel #{c} ({channels[c]['name']})")
        t0 = time.perf_counter()
        glimpse = GlimpseDataset(**kwargs, **channels[c], c=c)
        seconds["parse"] += time.perf_counter() - t0

        time1.append(float(glimpse.header["time1"]))
        ttb.append(glimpse.ttb)
        raw_target_xy = {}
        for dtype in glimpse.dtypes:
            N, F = len(glimpse.aoiinfo[dtype]), glimpse.F
            # (N, F, 2)
            raw_target_xy[dtype] = glimpse.aoiinfo[dtype].xy[:, None] + glimpse.cumdrift
            target_xy.setdefault(dtype, []).append(np.zeros((N, F, 2)))
            data.setdefault(dtype, []).append(np.zeros((N, F, P, P), dtype=int))
            labels.setdefault(dtype, []).append(glimpse.labels[dtype])
            if plots:
                glimpse.plot((dtype,), P, path=path, save=True,
                             title=f"{dtype} locations for channel {c}")
        if plots:
            glimpse.plot(("offset",), offset_P, path=path, save=True,
                         title=f"offset location for channel {c}")

        oy, ox = glimpse.offset_y, glimpse.offset_x
        frame_iter = iter(progress_bar(glimpse.frames))
        for start in range(0, glimpse.F, FRAME_CHUNK):
            chunk = glimpse.frames[start : start + FRAME_CHUNK]
            t0 = time.perf_counter()
            imgs = glimpse.read_frames(chunk)  # one open per file
            t1 = time.perf_counter()
            offset_imgs = imgs[:, oy : oy + offset_P, ox : ox + offset_P]
            offset_medians.extend(np.median(offset_imgs, axis=(1, 2)))
            values, counts = np.unique(offset_imgs, return_counts=True)
            for value, count in zip(values.tolist(), counts.tolist()):
                offset_counts[value] = offset_counts.get(value, 0) + count
            t2 = time.perf_counter()
            for b in range(len(chunk)):
                next(frame_iter, None)  # drive the progress bar
                f = start + b
                for dtype in glimpse.dtypes:
                    crops, targets = _crop_all_aois(imgs[b], raw_target_xy[dtype][:, f], P)
                    data[dtype][c][:, f] = crops
                    target_xy[dtype][c][:, f] = targets
            seconds["decode"] += t1 - t0
            seconds["histogram"] += t2 - t1
            seconds["crop"] += time.perf_counter() - t2

        for dtype in glimpse.dtypes:
            xy_c = target_xy[dtype][c]
            if not ((xy_c > 0.5 * P - 1).all() and (xy_c < 0.5 * P).all()):
                raise ValueError(f"channel {c} {dtype}: a target lies outside the "
                                 "central pixel of its crop")

    logger.info("Processing extracted AOIs ...")
    t0 = time.perf_counter()
    min_data = np.inf
    for dtype in data:
        data[dtype] = np.stack(data[dtype], -3)  # (N, F, C, P, P)
        target_xy[dtype] = np.stack(target_xy[dtype], -2)  # (N, F, C, 2)
        min_data = min(min_data, data[dtype].min())
        if any(label is None for label in labels[dtype]):
            labels[dtype] = None
        else:
            labels[dtype] = np.stack(labels[dtype], -1)
    t1 = time.perf_counter()

    # the offset histogram: min-data floor bin, trim, thinning
    offset_samples = np.array(sorted(offset_counts))
    offset_weights = np.array([offset_counts[s] for s in offset_samples], dtype=float)
    if min_data <= offset_samples[0]:
        offset_samples = np.insert(offset_samples, 0, min_data - 1)
        offset_weights = np.insert(offset_weights, 0, 1)
    offset_weights = offset_weights / offset_weights.sum()
    high_mask = offset_weights.cumsum() > 0.995
    high_weights = offset_weights[high_mask].sum()
    offset_samples = offset_samples[~high_mask]
    offset_weights = offset_weights[~high_mask]
    offset_weights[-1] += high_weights
    offset_samples, offset_weights = bin_hist(offset_samples, offset_weights, bin_size)
    t2 = time.perf_counter()

    dtypes = list(data)
    is_ontarget = np.concatenate(
        [np.full(data[dtype].shape[0], dtype == "ontarget", bool) for dtype in dtypes])
    images = np.concatenate([data[dtype] for dtype in dtypes], 0)
    xy = np.concatenate([target_xy[dtype] for dtype in dtypes], 0)
    if all(labels[dtype] is None for dtype in dtypes):
        labels_all = None
    else:
        labels_all = np.concatenate(
            [labels[dtype] for dtype in dtypes if labels[dtype] is not None], 0)
    del data, target_xy

    dataset = CosmosDataset(
        images=images,
        xy=xy,
        is_ontarget=is_ontarget,
        labels=labels_all,
        offset=OffsetData(np.asarray(offset_samples, np.float64),
                          np.asarray(offset_weights, np.float64)),
        time1=np.asarray(time1),
        ttb=np.asarray(ttb).T,
        name=name,
        channels=tuple(channel["name"] for channel in channels),
    )
    t3 = time.perf_counter()
    seconds["assemble"] += (t1 - t0) + (t3 - t2)
    seconds["histogram"] += t2 - t1
    logger.info(
        f"Dataset: N={dataset.N} on-target AOIs, Nc={dataset.Nc} off-target AOIs, "
        f"F={dataset.F} frames, C={dataset.C} channels, P={dataset.P} pixels")
    save(dataset, path)
    seconds["save"] += time.perf_counter() - t3
    logger.info("Ingest seconds by stage: " + ", ".join(
        f"{stage} {s:.3f}" for stage, s in seconds.items()))

    if plots:
        _plot_offset_qc(path, offset_samples, offset_weights, offset_medians, images,
                        dataset.vmax)
    return dataset
