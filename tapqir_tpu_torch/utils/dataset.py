"""Dataset layer: CosmosDataset + OffsetData + save/load (the port keeps its
own copy of tapqir_tpu/utils/dataset.py; same npz ``data.tpqr`` format).

Arrays are numpy on the host; the model moves them to the device once at
load time. ``data.tpqr`` is a compressed npz archive (no pickle), read and
written by both packages.
"""

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tapqir_tpu_torch.exceptions import TapqirFileNotFoundError

logger = logging.getLogger(__name__)

__all__ = ["OffsetData", "CosmosDataset", "save", "load"]


@dataclass(frozen=True)
class OffsetData:
    """Empirical camera offset distribution (reference: dataset.py:18-37)."""

    samples: np.ndarray  # (J,)
    weights: np.ndarray  # (J,), sums to 1

    @property
    def min(self) -> float:
        return float(self.samples.min())

    @property
    def max(self) -> float:
        return float(self.samples.max())

    @property
    def logits(self) -> np.ndarray:
        w = np.clip(self.weights, np.finfo(np.float64).tiny, None)
        return np.log(w / w.sum())

    @property
    def mean(self) -> float:
        return float((self.samples * self.weights).sum())

    @property
    def var(self) -> float:
        return float((self.samples**2 * self.weights).sum() - self.mean**2)


@dataclass
class CosmosDataset:
    """Stack of AOI images plus target locations and offset statistics.

    Shapes (reference: tapqir/utils/dataset.py:40-151):

    * images       (N + Nc, F, C, P, P) - raw counts
    * xy           (N + Nc, F, C, 2)    - sub-pixel target locations
    * is_ontarget  (N + Nc,) bool       - on-target AOIs come first
    * mask         (N + Nc,) bool       - AOI inclusion mask
    * labels       structured array (N, F, C?) with fields aoi/frame/z, or None
    """

    images: np.ndarray
    xy: np.ndarray
    is_ontarget: np.ndarray
    mask: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    offset: OffsetData = None
    time1: Optional[np.ndarray] = None
    ttb: Optional[np.ndarray] = None
    name: Optional[str] = None
    channels: Optional[Tuple[str, ...]] = None
    _cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.images = np.asarray(self.images)
        self.xy = np.asarray(self.xy)
        self.is_ontarget = np.asarray(self.is_ontarget, dtype=bool)
        if self.mask is None:
            self.mask = np.ones_like(self.is_ontarget, dtype=bool)
        else:
            self.mask = np.asarray(self.mask, dtype=bool)
        if self.channels is None:
            self.channels = tuple(f"channel{c}" for c in range(self.C))

    # -- derived sizes ------------------------------------------------------
    @property
    def N(self) -> int:
        """Number of on-target AOIs."""
        return int(self.is_ontarget.sum())

    @property
    def Nc(self) -> int:
        """Number of off-target (control) AOIs."""
        return int((~self.is_ontarget).sum())

    @property
    def Nt(self) -> int:
        """Total number of AOIs."""
        return self.images.shape[0]

    @property
    def F(self) -> int:
        return self.images.shape[1]

    @property
    def C(self) -> int:
        return self.images.shape[2]

    @property
    def P(self) -> int:
        Px, Py = self.images.shape[3], self.images.shape[4]
        assert Px == Py
        return Px

    @property
    def x(self) -> np.ndarray:
        return self.xy[..., 0]

    @property
    def y(self) -> np.ndarray:
        return self.xy[..., 1]

    @property
    def median(self) -> np.ndarray:
        """Per-channel median pixel value (reference: dataset.py:134-138)."""
        if "median" not in self._cache:
            self._cache["median"] = np.stack(
                [np.median(self.images[:, :, c]) for c in range(self.C)]
            )
        return self._cache["median"]

    def _channel_quantile(self, q) -> np.ndarray:
        return np.stack([np.quantile(self.images[:, :, c].astype(np.float32), q)
                         for c in range(self.C)])

    @property
    def vmin(self) -> np.ndarray:
        """Per-channel 5% quantile of the pixel values, as float32 (display
        range; cached)."""
        if "vmin" not in self._cache:
            self._cache["vmin"] = self._channel_quantile(0.05)
        return self._cache["vmin"]

    @property
    def vmax(self) -> np.ndarray:
        """Per-channel 99% quantile of the pixel values, as float32 (display
        range; cached)."""
        if "vmax" not in self._cache:
            self._cache["vmax"] = self._channel_quantile(0.99)
        return self._cache["vmax"]

    def fetch(self, ndx, fdx, cdx):
        """Host-side batch gather (images, xy, is_ontarget) of AOIs ``ndx``
        x frames ``fdx`` x channels ``cdx``, for host tools; the training
        path gathers on the device."""
        ndx = np.asarray(ndx)
        fdx = np.asarray(fdx)
        cdx = np.asarray(cdx)
        return (
            self.images[ndx[:, None, None], fdx[:, None], cdx],
            self.xy[ndx[:, None, None], fdx[:, None], cdx],
            self.is_ontarget[ndx],
        )

    def __repr__(self):
        return (
            f"CosmosDataset: {self.name}\n"
            f"  images  (N={self.N} on-target AOIs, Nc={self.Nc} off-target AOIs, "
            f"F={self.F} frames, C={self.C} channels, P={self.P} pixels)\n"
            f"  offset  ({len(self.offset.samples)} bins, "
            f"mean={self.offset.mean:.2f}, var={self.offset.var:.2f})"
        )


def save(obj: CosmosDataset, path) -> None:
    """Write ``data.tpqr`` (npz archive) (reference API: dataset.py:195-213)."""
    path = Path(path)
    if path.is_dir():
        path = path / "data.tpqr"
    payload = {
        "images": obj.images,
        "xy": obj.xy,
        "is_ontarget": obj.is_ontarget,
        "mask": obj.mask,
        "offset_samples": np.asarray(obj.offset.samples),
        "offset_weights": np.asarray(obj.offset.weights),
    }
    if obj.labels is not None:
        payload["labels"] = obj.labels
    if obj.time1 is not None:
        payload["time1"] = np.asarray(obj.time1)
    if obj.ttb is not None:
        payload["ttb"] = np.asarray(obj.ttb)
    if obj.name is not None:
        payload["name"] = np.asarray(obj.name)
    payload["channels"] = np.asarray(list(obj.channels))
    # atomic write: a fit killed mid-save must not leave a truncated archive
    # that poisons every later load of this workspace
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    tmp.replace(path)
    logger.info(f"Data is saved in {path}")


def _load_npz(path: Path) -> CosmosDataset:
    data = np.load(path, allow_pickle=False)
    kwargs = {}
    for opt in ("labels", "time1", "ttb"):
        if opt in data:
            kwargs[opt] = data[opt]
    name = str(data["name"]) if "name" in data else None
    channels = tuple(str(c) for c in data["channels"]) if "channels" in data else None
    return CosmosDataset(
        images=data["images"],
        xy=data["xy"],
        is_ontarget=data["is_ontarget"],
        mask=data["mask"] if "mask" in data else None,
        offset=OffsetData(
            np.asarray(data["offset_samples"], np.float64),
            np.asarray(data["offset_weights"], np.float64),
        ),
        name=name,
        channels=channels,
        **kwargs,
    )


def load(path) -> CosmosDataset:
    """Load ``data.tpqr`` from an analysis folder (or a direct file path)."""
    path = Path(path)
    if path.is_dir():
        path = path / "data.tpqr"
    if not path.exists():
        raise TapqirFileNotFoundError("data", path)
    return _load_npz(path)
