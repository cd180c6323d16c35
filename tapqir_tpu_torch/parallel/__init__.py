"""Scaling beyond one SVI chain: batched random restarts."""

from tapqir_tpu_torch.parallel.restarts import fit_restarts  # noqa: F401
