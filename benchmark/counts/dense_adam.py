"""Bytes of one dense Adam update (optax's ``adam``) of every parameter
leaf: the least traffic any implementation needs, whatever implements it.

Each element reads its parameter, gradient and two moments and writes its
parameter and two moments once: 7 accesses of its leaf's itemsize. The
bias corrections and the step count are scalars.
"""

import math

ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}
ACCESSES = 7


def step_bytes(leaves):
    """Bytes of one update of ``leaves``, {name: (shape, dtype name)}."""
    return sum(ACCESSES * ITEMSIZE[dt] * math.prod(shape) for shape, dt in leaves.values())


def least_seconds(nbytes, peaks):
    """The least time: the bytes at the memory peak."""
    return nbytes / peaks["bytes_per_s"]
