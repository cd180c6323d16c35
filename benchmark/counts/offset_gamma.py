"""Operations and bytes of the offset-marginalized Gamma likelihood of one
step, forward and backward: the least work the function needs for its
shapes, whatever implements it.

The arithmetic is ``chip_smoke.bound_ms`` with its statistics (the forward
that also yields d/dconcentration and d/drate, so that the backward is
element-wise), plus the backward's element-wise work:

* per (pixel, bin) pair with the pixel above the bin - the masked pairs
  need no work: 3 operations (difference, log, weight) and per config 6
  (exponent, max, exp, sum, and the two statistics' sums);
* per (pixel, config): 4 (log of the sum, rate term, lgamma, event sum) +
  5 for the statistics, and 3 in the backward (the concentration's
  gradient, the rate's product and sum).

Bytes count each input read once and each output written once: the images
and the concentrations over the real pixels and the (config, image) sums
forward; the sums' gradients read and the concentrations' gradient written
backward.
"""


def forward_backward(M, nb, ev, J, live_fraction, itemsize=4):
    """(operations, bytes) for M configs over nb images of ev real pixels
    and J offset bins, ``live_fraction`` of the (pixel, bin) pairs live."""
    pairs = nb * ev * J * live_fraction
    ops = pairs * (3 + 6 * M) + nb * ev * M * (4 + 5) + nb * ev * M * 3
    nbytes = itemsize * (nb * ev * (1 + M) + M * nb + M * nb + M * nb * ev)
    return ops, nbytes


def least_seconds(ops, nbytes, peaks):
    """The least time: the larger of the operations at the float32 peak and
    the bytes at the memory peak."""
    return max(ops / peaks["fp32_flops_per_s"], nbytes / peaks["bytes_per_s"])
