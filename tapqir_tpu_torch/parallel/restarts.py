"""Batched random restarts: R SVI chains stepped at once (counterpart of
tapqir_tpu/parallel/restarts.py).

The JAX package ``vmap``s its chunked train step over R chains. Here the
chain axis is written out: every variational parameter and Adam moment
gains a leading axis of R, one step gathers each chain's own minibatch,
takes all R ELBOs in one pass - one likelihood-kernel launch for all
chains, each with its own rate 1/gain - and updates every chain with the
JAX package's dense ``optax.adam``. So R chains cost about the launches of
one. The best chain (lowest trailing mean -ELBO) is handed to the model,
which continues it with the minibatch-sparse step of ``Model.run``.
"""

import zlib

import numpy as np
import torch

__all__ = ["fit_restarts", "DEFAULT_SEED"]

# the JAX package's default key is PRNGKey(0)
DEFAULT_SEED = 0
_MASK64 = (1 << 64) - 1
_MULT = 6364136223846793005  # the model's seed stream (models/model.py)


def _derived_seed(seed, salt):
    return (seed * _MULT + salt) & _MASK64


def stack_params(params, num_restarts, perturb=0.0, seed=DEFAULT_SEED):
    """The (R, ...) initial parameters: R copies of ``params``, chains 1..R-1
    jittered by Gaussian noise of std ``perturb`` (chain 0 keeps the
    unperturbed init), each parameter's noise from a generator keyed by
    ``zlib.crc32`` of its name (stable across processes, as the JAX
    package's ``fold_in``)."""
    out = {}
    for name, v in params.items():
        base = v.detach().unsqueeze(0).repeat((num_restarts,) + (1,) * v.dim())
        if perturb > 0:
            gen = torch.Generator(device=v.device)
            gen.manual_seed(_derived_seed(seed, zlib.crc32(name.encode())))
            noise = torch.randn(base.shape, generator=gen, device=v.device, dtype=v.dtype)
            noise[0] = 0.0
            base += perturb * noise
        out[name] = base.contiguous()
    return out


def fit_restarts(model, num_restarts=4, num_iter=2000, lr=None, perturb=0.0,
                 chunk=200, seed=None, progress=None, params=None, batches=None,
                 draws=None):
    """Run ``num_restarts`` SVI chains for ``num_iter`` steps at once and keep
    the best.

    The model must be loaded and initialized (``model.init(...)``); on a
    mesh (``parallel.sharding.fit_restarts_sharded``) ``params`` are this
    rank's blocks and the losses are summed over the mesh. On
    return ``model.params`` and ``model.opt_state`` hold the winning chain
    (its per-row step counts set to ``num_iter``), ``model.iter`` has grown
    by ``num_iter`` and ``model.iter_loss`` is the winner's last loss.

    :param perturb: std of the Gaussian jitter added to the unconstrained
        initial parameters of chains 1..R-1 (chain 0 keeps the init).
    :param chunk: steps between host reads of the losses (one sync each);
        ``progress(done, min over chains of the last loss)`` is called after
        each chunk.
    :param seed: seeds the jitter and the run's generator (default
        :data:`DEFAULT_SEED`).
    :param params: the (R, ...) initial parameters, replacing the stacked
        and jittered ones; ``batches[i]`` = (ndx (R, n), fidx (R, f) or
        None, f) and ``draws[i]`` (R, N) replace step i's random batch and
        draws. Tests use them to take the JAX package's.
    :return: the (R, num_iter) numpy array of -ELBO per chain and step, and
        the index of the best chain: the lowest mean over the last
        max(1, min(50, num_iter // 10)) steps.
    """
    lr = model.lr if lr is None else lr
    seed = DEFAULT_SEED if seed is None else seed
    if params is None:
        params = stack_params(model.params, num_restarts, perturb, seed)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    gen, row_gen = model._generators(_derived_seed(seed, 1))

    losses_all, done = [], 0
    while done < num_iter:
        n = min(chunk, num_iter - done)
        losses = torch.empty((num_restarts, n), dtype=model.dtype, device=model.device)
        for i in range(n):
            step = done + i
            losses[:, i] = model._restart_step(
                params, mu, nu, step + 1, lr, gen,
                batch=None if batches is None else batches[step],
                draws=None if draws is None else draws[step], row_generator=row_gen,
            )
        host = losses.cpu().numpy()  # one sync per chunk
        losses_all.append(host)
        done += n
        if progress is not None:
            progress(done, float(host[:, -1].min()))

    losses_all = np.concatenate(losses_all, axis=1)  # (R, num_iter)
    # select by the trailing-window mean of -ELBO (robust to MC noise)
    tail = max(1, min(50, num_iter // 10))
    best = int(np.argmin(losses_all[:, -tail:].mean(1)))
    model.adopt_chain(params, mu, nu, best, num_iter)
    model.iter = getattr(model, "iter", 0) + num_iter
    model.iter_loss = float(losses_all[best, -1])
    return losses_all, best
