"""Glimpse raw-data ingest (counterpart of tapqir_tpu/imscroll)."""

from tapqir_tpu_torch.imscroll.glimpse_reader import (  # noqa: F401
    GlimpseDataset,
    bin_hist,
    read_glimpse,
)
