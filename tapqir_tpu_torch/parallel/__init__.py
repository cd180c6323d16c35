"""Scaling beyond one SVI chain on one device: batched random restarts
(``restarts``) and the ("aoi", "frame") mesh of processes (``sharding``)."""

from tapqir_tpu_torch.parallel.restarts import fit_restarts  # noqa: F401
