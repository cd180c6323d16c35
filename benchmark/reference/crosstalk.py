"""Plain reference of a crosstalk fit's first SVI steps.

crosstalk is cosmos with Q dyes bleeding into C channels through a
crosstalk matrix alpha (Q, C) under a Dirichlet(1 + 9I) prior per dye: the
alpha site joins the global sites, and the likelihood runs over all
2^(K*Q) global spot configurations, every present spot of every dye scaled
by alpha[q, c] in channel c; each dye keeps cosmos's discrete tables, mapped
onto the global configurations. Those parts sit in ``cosmos.py`` under
``Spec.crosstalk``, which a configuration with ``"model": "crosstalk"``
turns on; this file is the name the harness finds.
"""

from benchmark.reference.cosmos import Spec, likelihood_shape, run_steps  # noqa: F401
