"""Model base class: the SVI lifecycle in PyTorch (counterpart of
tapqir_tpu/models/model.py).

Parameters are a dict of unconstrained tensors; the optimizer is the JAX
package's minibatch-sparse Adam in window space: only the subsampled AOI
rows (and frames) of each parameter are read, stepped and written back,
with per-row bias-correction step counts (``ops/sparse_adam.py``: on a card
one kernel launch gathers the parameter windows and one steps and writes
back every window). The train loop is a plain Python
loop over checkpoint chunks of ``checkpoint_interval`` steps (default 200);
losses stay on the device during a chunk and are checked once per chunk, so
the host never waits on the card inside a chunk.

Retained reference behaviors:

* a checkpoint after every chunk with the rolling-window convergence test
  std(last 100 ckpts) / std(last 50 ckpts) < 1.05 on -ELBO and conv_params;
  with ``full_checkpoint_every = k`` only every k-th one (and the last, and
  the one that converges) writes the full state, the others only check,
  extend the rolling series and log the metrics;
* non-finite loss or parameters -> reload the last checkpoint, reseed,
  continue, at most MAX_CONSECUTIVE_RESTARTS times in a row;
* device out-of-memory -> CudaOutOfMemoryError with batch-size advice;
* :meth:`Model.profile_trace` traces a chunk of steps (``fit --profile``)
  and leaves the model as it found it; its trace is a ``torch.profiler``
  Chrome trace where the JAX package writes an XProf directory.

Batched random restarts (``tapqir_tpu_torch.parallel.restarts``) step R
chains at once with a leading chain axis on every parameter: the
:meth:`Model._restart_step` gathers each chain's windows, takes every
chain's ELBO in one pass (one kernel launch), and updates the (R, ...)
parameters with the JAX package's dense ``optax.adam`` (every row decays
every step); :meth:`Model.adopt_chain` hands the winner to the sparse step.

On an ("aoi", "frame") mesh (``parallel/sharding.py``: one process per
shard), :meth:`Model.use_mesh` pads the AOI axis with masked dead rows to a
multiple of the mesh's, keeps this rank's block of the data, of every
per-AOI / per-frame parameter and of its Adam moments, and switches to the
dense step of the JAX package's mesh: the rank's ELBO with ``n_shards`` and
``frame_shards``, the gradients summed over the axes each parameter is
replicated on, and ``optax.adam`` with one step count. ``run``'s decisions
(the NaN guard, convergence, a new seed) are taken from all-reduced values,
so no rank takes a branch the others do not; checkpoints are gathered to the
first rank and written by it at the real AOI count.

Checkpoints (``.tapqir/<model>_model.tpqr``) use the JAX package's npz keys
(``p::``, ``mu::``, ``nu::``, ``count::``, ``rng::key``, ``meta``), so each
package resumes the other's checkpoints.

The fit loop, the step and the ELBO open spans of
:mod:`tapqir_tpu_torch.tracing` (``fit.*``, ``checkpoint.*``, ``step.*``,
``elbo.*``), which cost one flag check each while tracing is off.
"""

import json
import logging
import random
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from tapqir_tpu_torch import __version__ as tapqir_version
from tapqir_tpu_torch import tracing
from tapqir_tpu_torch.device import resolve_device, resolve_dtype
from tapqir_tpu_torch.exceptions import CudaOutOfMemoryError, TapqirFileNotFoundError
from tapqir_tpu_torch.ops import sparse_adam
from tapqir_tpu_torch.parallel import sharding
from tapqir_tpu_torch.parallel.restarts import _derived_seed
from tapqir_tpu_torch.utils.dataset import load as load_dataset
from tapqir_tpu_torch.utils.stats import read_summary, save_stats

logger = logging.getLogger(__name__)

CHECKPOINT_INTERVAL = 200
MAX_CONSECUTIVE_RESTARTS = 10
_ADAM_B1, _ADAM_B2, _ADAM_EPS = sparse_adam.ADAM_B1, sparse_adam.ADAM_B2, sparse_adam.ADAM_EPS
_SEED_MULT, _SEED_INC = 6364136223846793005, 1442695040888963407


def seed_to_key(seed: int) -> np.ndarray:
    """A 64-bit seed as the uint32[2] ``rng::key`` checkpoint entry."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def key_to_seed(key) -> int:
    """A ``rng::key`` entry (the port's seed, or a JAX PRNG key) as a seed."""
    k = np.asarray(key, np.uint64).reshape(-1)
    return int((int(k[0]) << 32) | int(k[-1]))


def _take_rows(v, axis, idx):
    """out[r] = v[r].index_select(axis - 1, idx[r]) for v (R, ...) and idx
    (R, k), as one ``torch.gather``."""
    shape = [1] * v.dim()
    shape[0], shape[axis] = idx.shape
    size = list(v.shape)
    size[axis] = idx.shape[1]
    return torch.gather(v, axis, idx.reshape(shape).expand(size))


def _dense_adam(params, grads, mu, nu, t, lr):
    """``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)`` on lists of tensors in
    place, at step count ``t``: mu and nu decay on every element, and the
    bias correction 1 - b^t is the same for all (multi-tensor launches)."""
    b1, b2, eps = _ADAM_B1, _ADAM_B2, _ADAM_EPS
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(nu, 1.0 - b2**t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mu, 1.0 - b1**t)
    torch._foreach_div_(step, denom)
    torch._foreach_add_(params, step, alpha=-lr)


class Model:
    """Base class for the port's models.

    Derived models implement :meth:`param_spec`, :meth:`param_partition`,
    :meth:`_draw_batch` and :meth:`elbo_from_windows`.
    """

    name = "base"
    # steps per chunk (one checkpoint each), and every how many checkpoints
    # the full state is written; set on an instance to change them
    checkpoint_interval = CHECKPOINT_INTERVAL
    full_checkpoint_every = 1
    # the rank's view of an ("aoi", "frame") mesh (use_mesh), the masked
    # dead AOI rows it padded, and whether compute_stats shards the
    # posterior marginals over it
    _mesh = None
    _aoi_pad = 0
    shards_posteriors = True

    def __init__(
        self,
        S: int = 1,
        K: int = 2,
        Q: Optional[int] = None,
        device=None,
        dtype: str = "float32",
        priors: Optional[dict] = None,
    ):
        self.S = S
        self.K = K
        self._Q = Q
        self.priors = dict(priors or {})
        self.nbatch_size = None
        self.fbatch_size = None
        # "random": an independent sorted uniform frame subset per step (the
        # default); "window": a cyclic contiguous window at a random offset
        self.frame_sampling = "random"
        self.path = None
        self.run_path = None
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self._layouts = {}  # the sparse step's window layouts, by batch shape

    # -- data ----------------------------------------------------------------
    @property
    def Q(self):
        return self._Q or self.data.C

    def load(self, path: Union[str, Path], data_only: bool = True) -> None:
        """Load data (and, unless ``data_only``, the saved fit results
        ``<model>_params.tpqr`` and ``<model>_summary.csv``) from an analysis
        folder."""
        self.path = Path(path)
        self.run_path = self.path / ".tapqir"
        self.data = load_dataset(self.path)
        logger.debug(f"Loaded data from {self.path / 'data.tpqr'}")
        if not data_only:
            params_path = self.path / f"{self.name}_params.tpqr"
            if not params_path.exists():
                raise TapqirFileNotFoundError("parameter", params_path)
            with np.load(params_path, allow_pickle=False) as z:
                self.params_stats = {k: z[k] for k in z.files}
            summary_path = self.path / f"{self.name}_summary.csv"
            if not summary_path.exists():
                raise TapqirFileNotFoundError("summary", summary_path)
            self.summary = read_summary(summary_path)

    def _device_image_stack(self):
        """Flat device stack (Nt, F, C, EVP = ceil(P*P/128)*128). Padded
        pixels hold offset.max + 1 so their masked log-probs stay finite."""
        d = self.data
        Nt, F, C, P = d.Nt, d.F, d.C, d.P
        ev = P * P
        ev_pad = -(-ev // 128) * 128
        imgs = torch.as_tensor(np.asarray(d.images)).to(self.device)
        imgs = imgs.reshape(Nt, F, C, ev).to(self.dtype)
        if ev_pad > ev:
            pad_val = float(np.max(np.asarray(d.offset.samples))) + 1.0
            pad = torch.full((Nt, F, C, ev_pad - ev), pad_val, dtype=self.dtype,
                             device=self.device)
            imgs = torch.cat([imgs, pad], -1)
        return imgs

    def _data_device_arrays(self):
        d = self.data

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

        return dict(
            images=self._device_image_stack(),
            xy=put(d.xy, self.dtype),
            is_ontarget=put(d.is_ontarget, torch.long),
            mask=put(d.mask, self.dtype),
            offset_samples=put(d.offset.samples, self.dtype),
            offset_logits=put(d.offset.logits, self.dtype),
        )

    # -- to be provided by subclasses -----------------------------------------
    def param_spec(self) -> dict:
        """name -> (init_constrained_value: np.ndarray, Transform)."""
        raise NotImplementedError

    def param_partition(self) -> dict:
        """name -> tuple of axis names ("aoi", "frame" or None)."""
        raise NotImplementedError

    # -- parameters -------------------------------------------------------------
    def init_parameters(self):
        spec = self.param_spec()
        self._transforms = {k: t for k, (v, t) in spec.items()}
        self.params = {
            k: t.inverse(torch.as_tensor(np.asarray(v, np.float64)))
            .to(device=self.device, dtype=self.dtype)
            .contiguous()
            for k, (v, t) in spec.items()
        }

    def constrained(self, params=None) -> dict:
        params = self.params if params is None else params
        return {k: self._transforms[k](v) for k, v in params.items()}

    def param(self, name):
        """Constrained value of a variational parameter, as numpy."""
        with torch.no_grad():
            return self._transforms[name](self.params[name]).cpu().numpy()

    # -- SVI ----------------------------------------------------------------------
    def init(self, lr: float = 0.005, nbatch_size: int = 5,
             fbatch_size: int = 512) -> None:
        """Initialize the SVI state, resuming from a checkpoint if present."""
        self.lr = lr
        self.nbatch_size = min(nbatch_size, self.data.Nt)
        self.fbatch_size = min(fbatch_size, self.data.F)
        self._data_dev = self._data_device_arrays()
        spec = self.param_spec()
        self._transforms = {k: t for k, (v, t) in spec.items()}
        self._build_constants()

        seed = None
        try:
            seed = self.load_checkpoint()
        except TapqirFileNotFoundError:
            self.init_parameters()
            self.iter = 0
            self.converged = False
            self._rolling = {}
            self.opt_state = self._init_opt_state()
        # resume continues the seed stream from the checkpoint
        self._seed = seed if seed is not None else 0
        if self._mesh is not None:  # a reload of run's NaN guard
            self._apply_mesh()

    def _build_constants(self):
        """Constant tables the ELBO reads every step, made once on the
        device (a host-to-device copy inside a step would wait on the card)."""
        self._const = {}

    def _row_groups(self):
        """``("af", ax)`` for per-AOI-frame parameters (axes ``ax``/``ax+1``
        are Nt/F), ``("a", ax)`` for per-AOI ones, ``("g", None)`` for
        globals, from :meth:`param_partition`."""
        groups = {}
        for name, axes in self.param_partition().items():
            if "aoi" not in axes:
                groups[name] = ("g", None)
                continue
            ax = axes.index("aoi")
            if "frame" in axes:
                if axes.index("frame") != ax + 1:
                    raise ValueError(f"{name}: frame axis must follow the aoi axis")
                groups[name] = ("af", ax)
            else:
                groups[name] = ("a", ax)
        return groups

    def _window_spec(self):
        """name -> (aoi_axis, frame_axis or None) for batched parameters."""
        spec = {}
        for name, axes in self.param_partition().items():
            if "aoi" not in axes:
                continue
            spec[name] = (axes.index("aoi"), axes.index("frame") if "frame" in axes else None)
        return spec

    def gather_windows(self, tree, ndx, fidx):
        """Minibatch windows of a parameter-shaped dict: AOI rows ``ndx`` x
        frames ``fidx`` (``None``: every frame). Globals pass through."""
        return sparse_adam.gather_plain(tree, self._window_spec(), ndx, fidx)

    def gather_chain_windows(self, tree, ndx, fidx):
        """:meth:`gather_windows` with a leading chain axis: values (R,
        ...), AOI rows ``ndx`` (R, n) and frames ``fidx`` (R, f) (or None),
        each chain its own rows. A ``torch.gather`` per axis, so the
        gradient of a window is a full-size, dense (R, ...) gradient."""
        wspec = self._window_spec()
        out = {}
        for name, v in tree.items():
            if name not in wspec:
                out[name] = v
                continue
            a_ax, f_ax = wspec[name]
            rows = _take_rows(v, a_ax + 1, ndx)
            if fidx is not None and f_ax is not None:
                rows = _take_rows(rows, f_ax + 1, fidx)
            out[name] = rows
        return out

    def _init_opt_state(self):
        """Adam moments plus per-row-group step counts: one scalar for
        globals, (Nt,) for per-AOI and (Nt*F,) for per-AOI-frame rows."""
        groups = self._row_groups()
        Nt, F = self.data.Nt, self.data.F
        dev = self.device
        counts = {"g": torch.zeros((), dtype=torch.int32, device=dev)}
        if any(k == "a" for k, _ in groups.values()):
            counts["a"] = torch.zeros((Nt,), dtype=torch.int32, device=dev)
        if any(k == "af" for k, _ in groups.values()):
            counts["af"] = torch.zeros((Nt * F,), dtype=torch.int32, device=dev)
        return {
            "mu": {k: torch.zeros_like(v) for k, v in self.params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in self.params.items()},
            "count": counts,
        }

    def _sparse_step(self, generator, batch=None, draws=None):
        """One minibatch-sparse Adam step (JAX: ``one_step_sparse``).

        ``batch`` = (ndx, fidx, f_b) and ``draws`` (the packed standard-Gamma
        vector) replace the random batch and draws; tests use them to take
        the JAX step's batch and draws. Returns the loss as a 0-dim tensor
        on the device."""
        data = self._data_dev
        with tracing.span("step.batch"):
            if batch is None:
                batch = self._draw_batch(generator)
        ndx, fidx, f_b = batch
        with tracing.span("step.gather"):
            layout = self._window_layout(ndx, fidx)
            win = sparse_adam.window_gather(self.params, layout, ndx, fidx)
        with tracing.span("elbo.forward"):
            loss = -self.elbo_from_windows(win, generator, ndx, fidx, f_b, data,
                                           draws=draws)
        with tracing.span("elbo.backward"):
            grads = torch.autograd.grad(loss, list(win.values()))
        with tracing.span("step.update"):
            sparse_adam.window_adam(self.params, self.opt_state, win, grads, layout, ndx,
                                    fidx, self.lr)
        return loss.detach()

    def _window_layout(self, ndx, fidx):
        """The :class:`~tapqir_tpu_torch.ops.sparse_adam.WindowLayout` of
        the parameters' windows at this batch's shape, made once per shape."""
        f = None if fidx is None else fidx.shape[0]
        key = (ndx.shape[0], f, tuple((k, v.shape) for k, v in self.params.items()))
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = sparse_adam.WindowLayout(
                self.params, self._row_groups(), self._window_spec(), self.data.Nt,
                self.data.F, ndx.shape[0], f)
        return layout

    def _restart_step(self, params, mu, nu, t, lr, generator, batch=None,
                      draws=None, row_generator=None):
        """One SVI step of R chains at once (JAX: ``one_step`` of
        ``fit_restarts`` under ``vmap``): each chain's batch, every chain's
        ELBO in one pass, gradients of the (R, ...) parameters, then the
        dense Adam of ``optax.adam`` at learning rate ``lr`` and step count
        ``t`` (1 for the first step) on ``params``, ``mu`` and ``nu`` in
        place. As in the JAX package the gradients are taken as they are
        (no zeroing of non-finite elements) and no NaN check runs.

        ``batch`` = (ndx (R, n), fidx (R, f) or None, f) and ``draws`` (R,
        N) replace the random batch and draws. Returns the (R,) losses on
        the device. On a mesh the rows come from ``row_generator``, the
        losses are summed over the mesh and the gradients over the axes
        each parameter is replicated on."""
        data = self._data_dev
        R = next(iter(params.values())).shape[0]
        if batch is None:
            batch = self._draw_batch(generator, chains=R, row_generator=row_generator)
        ndx, fidx, f_b = batch
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        win = self.gather_chain_windows(leaves, ndx, fidx)
        losses = -self.elbo_from_windows(win, generator, ndx, fidx, f_b, data,
                                         draws=draws, **self._mesh_elbo_kwargs())
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        if self._mesh is not None:
            specs = sharding.restart_param_specs(self.param_partition())
            losses, g = sharding.reduce_gradients(self._mesh, specs, losses.detach(),
                                                  dict(zip(leaves, grads)))
            grads = [g[k] for k in leaves]
        with torch.no_grad():
            _dense_adam(list(params.values()), list(grads), list(mu.values()),
                        list(nu.values()), t, lr)
        return losses.detach()

    def adopt_chain(self, params, mu, nu, best, count):
        """The restart handoff (JAX: the end of ``fit_restarts`` and
        ``_coerce_opt_state``): chain ``best`` of the (R, ...) parameters
        and Adam moments becomes the model's, and every per-row step count
        (``g``, ``a``, ``af``) is the restarts' step count ``count`` (on a
        mesh: the one count of its dense Adam)."""
        self.params = {k: v[best].clone() for k, v in params.items()}
        if self._mesh is None:
            counts = {k: torch.full_like(v, count)
                      for k, v in self._init_opt_state()["count"].items()}
        else:
            self._mesh_t = int(count)
            counts = {"g": torch.full((), count, dtype=torch.int32, device=self.device)}
        self.opt_state = {
            "mu": {k: v[best].clone() for k, v in mu.items()},
            "nu": {k: v[best].clone() for k, v in nu.items()},
            "count": counts,
        }

    def _next_seed(self) -> int:
        self._seed = (self._seed * _SEED_MULT + _SEED_INC) % (1 << 64)
        return self._seed

    def _generators(self, seed):
        """(generator, row generator) seeded from ``seed``: one generator,
        and no row generator, off a mesh; on a mesh a generator of the
        rank's own and a row generator shared by the frame shards of its
        mesh row, which draws the AOI rows."""
        gen = torch.Generator(device=self.device)
        mesh = self._mesh
        if mesh is None:
            gen.manual_seed(seed)
            return gen, None
        gen.manual_seed(_derived_seed(seed, 1 + mesh.rank))
        row = torch.Generator(device=self.device)
        row.manual_seed(_derived_seed(seed, (1 << 32) + mesh.aoi_index))
        return gen, row

    def _run_chunk(self, nsteps: int) -> torch.Tensor:
        """``nsteps`` SVI steps with the generators of one seed of the seed
        stream; returns the (nsteps,) device tensor of losses."""
        with tracing.span("fit.chunk"):
            gen, row = self._generators(self._next_seed())
            losses = torch.empty((nsteps,), dtype=self.dtype, device=self.device)
            for i in range(nsteps):
                if self._mesh is None:
                    losses[i] = self._sparse_step(gen)
                else:
                    losses[i] = self._mesh_step(gen, row)
        return losses

    # -- the mesh ----------------------------------------------------------------
    def mesh_aoi_padding(self, mesh) -> int:
        """The AOI count padded to a multiple of the mesh's "aoi" axis."""
        n_aoi = int(mesh.shape["aoi"])
        return -(-self.data.Nt // n_aoi) * n_aoi

    def pad_for_mesh(self, mesh) -> None:
        """Pad the AOI axis of the parameters, the Adam state and the device
        data with masked dead rows, so that any AOI count shards over the
        mesh (JAX: ``pad_for_mesh``). Dead rows carry ``mask = 0``, which
        zeroes every per-AOI term of the ELBO, images at offset.max + 1
        (finite masked log-probs) and the last real row's parameters. The
        frame axis is never padded (the hmm chain would score dead frames):
        the mesh's frame axis must divide F. Idempotent."""
        Nt, F = self.data.Nt, self.data.F
        n_frame = int(mesh.shape["frame"])
        if F % n_frame:
            raise ValueError(
                f"mesh frame axis {n_frame} must divide F={F} (the frame axis is "
                "not padded); use an AOI-only mesh"
            )
        pad = self.mesh_aoi_padding(mesh) - Nt
        if pad == 0:
            return
        wspec = self._window_spec()

        def pad_edge(v, ax):
            if v.shape[ax] != Nt:  # already padded
                return v
            edge = v.narrow(ax, Nt - 1, 1)
            return torch.cat([v, edge.expand(*v.shape[:ax], pad, *v.shape[ax + 1:])], ax)

        def pad_tree(tree):
            return {k: pad_edge(v, wspec[k][0]) if k in wspec else v for k, v in tree.items()}

        self.params = pad_tree(self.params)
        opt = self.opt_state
        counts = dict(opt["count"])
        if "a" in counts and counts["a"].shape[0] == Nt:
            counts["a"] = torch.nn.functional.pad(counts["a"], (0, pad))
        if "af" in counts and counts["af"].shape[0] == Nt * F:
            counts["af"] = torch.nn.functional.pad(counts["af"], (0, pad * F))
        self.opt_state = {"mu": pad_tree(opt["mu"]), "nu": pad_tree(opt["nu"]),
                          "count": counts}

        d = self._data_dev
        if d["mask"].shape[0] == Nt:
            imgs = d["images"]
            pad_val = float(d["offset_samples"].max()) + 1.0
            self._data_dev = dict(
                d,
                images=torch.cat([imgs, torch.full((pad,) + tuple(imgs.shape[1:]), pad_val,
                                                   dtype=imgs.dtype, device=imgs.device)]),
                xy=pad_edge(d["xy"], 0),
                is_ontarget=torch.nn.functional.pad(d["is_ontarget"], (0, pad)),
                mask=torch.nn.functional.pad(d["mask"], (0, pad)),  # zeros: dead rows
            )
        self._aoi_pad = pad
        logger.info(f"Padded {Nt} AOIs with {pad} masked dead rows for the "
                    f"{dict(mesh.shape)} mesh")

    def _unpad_aoi(self, tree):
        """A parameter-shaped dict of full arrays with the mesh's AOI padding
        sliced off."""
        Nt = self.data.Nt
        wspec = self._window_spec()
        return {k: v.narrow(wspec[k][0], 0, Nt) if k in wspec and v.shape[wspec[k][0]] > Nt
                else v for k, v in tree.items()}

    def use_mesh(self, mesh) -> None:
        """Train on an ("aoi", "frame") mesh (JAX: ``use_mesh``): ``mesh``
        is this rank's :class:`~tapqir_tpu_torch.parallel.sharding.RankMesh`
        (every rank of the mesh calls this, after :meth:`init`). Pads the
        AOI axis (:meth:`pad_for_mesh`), keeps this rank's block of the
        data, the parameters and their Adam moments, takes the replicated
        ones from the first rank of their group so that every replica
        starts bitwise equal, and switches ``run`` to the dense mesh step
        (``optax.adam`` with one step count, the sparse per-row count
        ``g``). ``run``'s NaN reload re-applies the mesh."""
        self._mesh = mesh
        self._apply_mesh()

    def _apply_mesh(self):
        mesh = self._mesh
        self.pad_for_mesh(mesh)
        specs = self.param_partition()
        dspec = sharding.data_partition()
        opt = self.opt_state
        self._mesh_t = int(opt["count"]["g"])
        self.params = {k: sharding.shard_block(v, specs[k], mesh) for k, v in self.params.items()}
        self.opt_state = {
            "mu": {k: sharding.shard_block(v, specs[k], mesh) for k, v in opt["mu"].items()},
            "nu": {k: sharding.shard_block(v, specs[k], mesh) for k, v in opt["nu"].items()},
            "count": {"g": torch.full((), self._mesh_t, dtype=torch.int32, device=self.device)},
        }
        self._data_dev = {k: sharding.shard_block(v, dspec[k], mesh)
                          for k, v in self._data_dev.items()}
        with torch.no_grad():
            sharding.sync_replicated([self.params, self.opt_state["mu"], self.opt_state["nu"]],
                                     specs, mesh)

    def _mesh_elbo_kwargs(self):
        """The ELBO's mesh arguments: ``n_shards`` and ``frame_shards``, and
        for a frame-coupled model (hmm) the mesh row as ``frame_axis``."""
        mesh = self._mesh
        if mesh is None:
            return {}
        kwargs = {"n_shards": mesh.size, "frame_shards": mesh.shape["frame"]}
        if getattr(self, "frame_coupled", False) and mesh.shape["frame"] > 1:
            kwargs["frame_axis"] = mesh.row
        return kwargs

    def _mesh_loss_and_grads(self, generator, row_generator=None, batch=None, draws=None):
        """The mesh's loss (summed over the ranks) and this rank's gradients
        (summed over the axes each parameter is replicated on) of one step
        (JAX: ``make_sharded_grads_fn``); ``batch`` and ``draws`` replace the
        rank's random batch and draws. Gradients are dense and taken as they
        are, as the JAX package's mesh step takes them."""
        if batch is None:
            batch = self._draw_batch(generator, row_generator=row_generator)
        ndx, fidx, f_b = batch
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        win = self.gather_windows(leaves, ndx, fidx)
        loss = -self.elbo_from_windows(win, generator, ndx, fidx, f_b, self._data_dev,
                                       draws=draws, **self._mesh_elbo_kwargs())
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return sharding.reduce_gradients(self._mesh, self.param_partition(), loss.detach(),
                                         dict(zip(leaves, grads)))

    def _mesh_step(self, generator, row_generator=None, batch=None, draws=None):
        """One step on the mesh: :meth:`_mesh_loss_and_grads`, then the dense
        Adam of ``optax.adam`` on this rank's parameters. Returns the loss
        summed over the mesh, a 0-dim device tensor."""
        loss, grads = self._mesh_loss_and_grads(generator, row_generator, batch, draws)
        opt = self.opt_state
        self._mesh_t += 1
        opt["count"]["g"].fill_(self._mesh_t)
        names = list(self.params)
        with torch.no_grad():
            _dense_adam([self.params[k] for k in names], [grads[k] for k in names],
                        [opt["mu"][k] for k in names], [opt["nu"][k] for k in names],
                        self._mesh_t, self.lr)
        return loss

    def gather_tree(self, tree):
        """The full arrays, at the real AOI count, of a parameter-shaped
        dict of this rank's blocks, as numpy arrays on the first rank (None
        on the others). Collective: every rank calls it."""
        specs = self.param_partition()
        out = {}
        with torch.no_grad():
            for k, v in tree.items():
                full = sharding.gather_blocks(v, specs[k], self._mesh)
                if self._mesh.is_main:
                    out[k] = self._unpad_aoi({k: full})[k].cpu().numpy()
        return out if self._mesh.is_main else None

    def leave_mesh(self) -> bool:
        """Gather the parameters and Adam moments to the first rank and
        continue there on one device (the full data at the real AOI count,
        per-row step counts equal to the mesh's count); the other ranks are
        done with the model. Collective. Returns True on the first rank."""
        opt = self.opt_state
        trees = [self.gather_tree(t) for t in (self.params, opt["mu"], opt["nu"])]
        main = self._mesh.is_main
        self._mesh, self._aoi_pad = None, 0
        if not main:
            self.params = self.opt_state = self._data_dev = None
            return False

        def dev(tree):
            return {k: torch.as_tensor(v).to(self.device).contiguous() for k, v in tree.items()}

        self.params = dev(trees[0])
        self._data_dev = self._data_device_arrays()
        self.opt_state = {
            "mu": dev(trees[1]), "nu": dev(trees[2]),
            "count": {k: torch.full_like(v, self._mesh_t)
                      for k, v in self._init_opt_state()["count"].items()},
        }
        return True

    def profile_trace(self, num_steps: int = 20, log_dir=None) -> Path:
        """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity)
        of ``num_steps`` training steps, written as a Chrome trace
        ``<log_dir>/<model>_trace.json`` (default ``log_dir``:
        ``<run_path>/profile``); returns its path. A first chunk of
        ``num_steps`` steps runs outside the trace, so that the kernels'
        build and first launches stay out of it. Tracing
        (:mod:`tapqir_tpu_torch.tracing`) is on for the traced chunk, so its
        spans are ``span::<name>`` ranges in the trace, and is then left as it
        was. The steps update the parameters and the Adam state in place, so
        the parameters, the moments, the per-row counts, the iteration and
        the seed are put back afterwards: the model is left as it was
        found."""
        log_dir = Path(log_dir) if log_dir else self.run_path / "profile"
        log_dir.mkdir(parents=True, exist_ok=True)
        trees = [self.params, self.opt_state["mu"], self.opt_state["nu"],
                 self.opt_state["count"]]
        saved = [{k: v.detach().clone() for k, v in tree.items()} for tree in trees]
        iteration, seed = self.iter, self._seed
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = log_dir / f"{self.name}_trace.json"
        was_tracing = tracing.enabled()
        try:
            self._run_chunk(num_steps).cpu()  # warm-up; .cpu() waits for the card
            tracing.enable()
            with torch.profiler.profile(activities=acts) as prof:
                self._run_chunk(num_steps).cpu()
            prof.export_chrome_trace(str(out))
        finally:
            if not was_tracing:
                tracing.disable()
            with torch.no_grad():
                for tree, old in zip(trees, saved):
                    for k, v in tree.items():
                        v.copy_(old[k])
            self.iter, self._seed = iteration, seed
        logger.info(f"Saved a profiler trace of {num_steps} steps in {out}")
        return out

    def run(self, num_iter: int = 0, progress_bar=None) -> None:
        """Run SVI until ``num_iter`` or convergence.

        ``progress_bar`` is called once with ``range(num_iter)`` and the
        iterable it returns is advanced chunk by chunk (a ``set_postfix``
        method, as tqdm's, gets the -ELBO); without one, each checkpoint
        logs its iteration and -ELBO at INFO."""
        use_crit = num_iter == 0
        if use_crit:
            num_iter = 100000
        logger.debug(f"tapqir-tpu-torch version - {tapqir_version}")
        logger.debug(f"Model - {self.name}")
        logger.debug(f"Device - {self.device}")
        logger.debug(f"Floating precision - {self.dtype}")
        logger.debug(f"Optimizer - Adam, lr {self.lr}")
        logger.debug(f"AOI batch size - {self.nbatch_size}")
        logger.debug(f"Frame batch size - {self.fbatch_size}")

        remaining = num_iter
        pbar = progress_bar(range(num_iter)) if progress_bar is not None else None
        pbar_iter = iter(pbar) if pbar is not None else None
        consecutive_failures = 0
        full_every = max(1, int(self.full_checkpoint_every))
        n_ckpts = 0
        while remaining > 0:
            chunk = min(self.checkpoint_interval, remaining)
            try:
                try:
                    losses = self._run_chunk(chunk)
                    with tracing.span("fit.device_wait"):
                        losses = losses.cpu().numpy()  # one sync
                except torch.cuda.OutOfMemoryError as err:
                    raise CudaOutOfMemoryError() from err
                if not np.isfinite(losses).all():
                    raise ValueError(
                        f"Iteration #{self.iter}. Detected NaN/Inf loss values"
                    )
                self.iter += chunk
                remaining -= chunk
                self.iter_loss = float(losses[-1])
                if pbar is None:
                    logger.info(f"Iteration #{self.iter}: -ELBO {self.iter_loss:.1f}")
                else:
                    for _ in range(chunk):
                        next(pbar_iter, None)
                    if hasattr(pbar, "set_postfix"):
                        pbar.set_postfix({"-ELBO": f"{self.iter_loss:.1f}"})
                n_ckpts += 1
                save_full = n_ckpts % full_every == 0 or remaining == 0
                self.save_checkpoint(save_full=save_full)
                consecutive_failures = 0
                if use_crit and self.converged:
                    if not save_full:
                        self._write_checkpoint()
                    logger.info(f"Iteration #{self.iter} model converged.")
                    break
            except ValueError as err:
                logger.warning(str(err))
                consecutive_failures += 1
                if consecutive_failures >= MAX_CONSECUTIVE_RESTARTS:
                    raise RuntimeError(
                        f"Iteration #{self.iter}: loss is non-finite after "
                        f"{consecutive_failures} checkpoint-reload restarts; "
                        "the checkpointed state appears numerically "
                        "degenerate. Try a lower learning rate or "
                        "--dtype double."
                    ) from err
                # the step updates in place: reload the last checkpoint
                # (or fresh parameters) and reseed
                self.init(lr=self.lr, nbatch_size=self.nbatch_size,
                          fbatch_size=self.fbatch_size)
                new_seed = random.randint(0, 100)
                if self._mesh is not None:  # the first rank's seed on every rank
                    new_seed = int(sharding.from_first(
                        torch.tensor([new_seed], device=self.device), self._mesh.world)[0])
                self._seed = new_seed
                logger.warning(
                    f"Iteration #{self.iter} restarting with a new seed: {new_seed}."
                )
        else:
            if use_crit:
                logger.warning(f"Iteration #{self.iter} model has not converged.")

    # -- checkpointing --------------------------------------------------------
    @property
    def _checkpoint_path(self):
        return self.run_path / f"{self.name}_model.tpqr"

    def _small_params(self):
        """Names of scalar/small constrained params logged per checkpoint."""
        names = []
        for name in self._transforms:
            shp = tuple(self.params[name].shape)
            if len(shp) == 0 or (len(shp) == 1 and shp[0] <= self.Q * 2):
                names.append(name)
        return names

    def save_checkpoint(self, save_full=True):
        """Checkpoint params + optimizer + convergence state; one device to
        host transfer per array. ``save_full=False`` runs only the finite
        check, the rolling convergence series and the metrics log, and
        writes no file (``Model.run`` passes it per
        ``full_checkpoint_every``). Collective on a mesh: the finite check
        counts every rank's parameters, the convergence verdict is the
        first rank's, and the first rank writes the gathered state."""
        with tracing.span("fit.checkpoint"):
            with torch.no_grad(), tracing.span("checkpoint.check"):
                finite = torch.stack(
                    [torch.isfinite(v).all() for v in self.params.values()]
                ).to(self.dtype)
                if self._mesh is not None:
                    finite = sharding.all_reduce(finite, self._mesh.world) == self._mesh.size
                finite = finite.cpu().numpy() > 0
                for ok, k in zip(finite, self.params):
                    if not bool(ok):
                        raise ValueError(f"Iteration #{self.iter}. Detected NaN values in {k}")
                small_h = {
                    n: self._transforms[n](self.params[n]).cpu().numpy()
                    for n in self._small_params()
                }

            # update rolling convergence series (constrained values)
            rolling_max = 100
            for name in self.conv_params:
                if name == "-ELBO":
                    self._rolling.setdefault("-ELBO", []).append(float(self.iter_loss))
                else:
                    val = np.asarray(small_h[name])
                    if val.ndim == 1:
                        for i in range(len(val)):
                            self._rolling.setdefault(f"{name}_{i}", []).append(float(val[i]))
                    else:
                        self._rolling.setdefault(name, []).append(float(val))
            for k in self._rolling:
                self._rolling[k] = self._rolling[k][-rolling_max:]

            self.converged = False
            if len(self._rolling["-ELBO"]) == rolling_max:
                crit = all(
                    np.std(v, ddof=1) / np.std(v[-50:], ddof=1) < 1.05
                    for v in self._rolling.values()
                )
                if crit:
                    self.converged = True
            if self._mesh is not None:
                self.converged = bool(sharding.from_first(
                    torch.tensor([float(self.converged)], device=self.device),
                    self._mesh.world)[0])

            if save_full:
                self._write_checkpoint()
            if self._mesh is None or self._mesh.is_main:
                self._log_metrics(small_h)
            logger.debug(f"Iteration #{self.iter}: Successful.")

    def _write_checkpoint(self):
        """Write the parameters, the optimizer state, the seed and the
        convergence state to ``.tapqir/<model>_model.tpqr``. On a mesh the
        arrays are gathered at the real AOI count (collective) and the
        first rank writes them, with the dense Adam's one ``count`` as the
        JAX package's mesh writes it."""
        with tracing.span("checkpoint.write"):
            opt = self.opt_state
            trees = (("p", self.params), ("mu", opt["mu"]), ("nu", opt["nu"]))
            flat = {}
            if self._mesh is not None:
                trees = [(prefix, self.gather_tree(tree)) for prefix, tree in trees]
                if not self._mesh.is_main:
                    return
                flat["count"] = np.asarray(self._mesh_t, np.int32)
            else:
                trees = [(prefix, {k: v.detach().cpu().numpy() for k, v in tree.items()})
                         for prefix, tree in trees + (("count", opt["count"]),)]
            self.run_path.mkdir(parents=True, exist_ok=True)
            for prefix, tree in trees:
                for k, v in tree.items():
                    flat[f"{prefix}::{k}"] = v
            flat["rng::key"] = seed_to_key(self._seed)
            meta = {
                "iter": self.iter,
                "rolling": self._rolling,
                "convergence_status": bool(self.converged),
                "version": tapqir_version,
            }
            flat["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
            tmp = self._checkpoint_path.with_name(self._checkpoint_path.name + ".tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            tmp.replace(self._checkpoint_path)

    def _log_metrics(self, small_h):
        """Append scalar metrics to ``.tapqir/logs/<model>/metrics.csv``."""
        with tracing.span("checkpoint.log"):
            log_dir = self.run_path / "logs" / self.name
            log_dir.mkdir(parents=True, exist_ok=True)
            csv_path = log_dir / "metrics.csv"
            scalars = {"iter": self.iter, "-ELBO": self.iter_loss}
            for name, val in small_h.items():
                val = np.asarray(val)
                if val.ndim == 0:
                    scalars[name] = float(val)
                elif val.ndim == 1 and val.size <= self.Q * 2:
                    for i, x in enumerate(val.ravel()):
                        scalars[f"{name}_{i}"] = float(x)
            write_header = not csv_path.exists()
            with open(csv_path, "a") as f:
                if write_header:
                    f.write(",".join(scalars.keys()) + "\n")
                f.write(",".join(str(v) for v in scalars.values()) + "\n")

    def load_checkpoint(self, path=None, param_only=False, warnings=False):
        """Load a checkpoint written by either package from ``path`` (default:
        the workspace's ``.tapqir``): the parameters and, unless
        ``param_only``, the optimizer and convergence state. ``warnings``
        logs a warning for a fit that has not converged. Returns the
        checkpoint's seed."""
        path = Path(path) if path else self.run_path
        model_path = path / f"{self.name}_model.tpqr"
        if not model_path.exists():
            raise TapqirFileNotFoundError("model", model_path)
        with np.load(model_path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads(bytes(flat.pop("meta")).decode())
        key = flat.pop("rng::key", None)

        def tree(prefix, dtype):
            n = len(prefix)
            return {
                k[n:]: torch.as_tensor(v).to(device=self.device, dtype=dtype).contiguous()
                for k, v in flat.items()
                if k.startswith(prefix)
            }

        self.params = tree("p::", self.dtype)
        if not param_only:
            counts = tree("count::", torch.int32)
            if not counts:  # a dense-Adam checkpoint: one scalar count
                fresh = self._init_opt_state()["count"]
                c = int(flat["count"])
                counts = {k: torch.full_like(v, c) for k, v in fresh.items()}
            self.opt_state = {
                "mu": tree("mu::", self.dtype),
                "nu": tree("nu::", self.dtype),
                "count": counts,
            }
            self.converged = meta["convergence_status"]
            self._rolling = meta["rolling"]
            self.iter = meta["iter"]
            logger.info(f"Iteration #{self.iter}. Loaded a model checkpoint from {model_path}")
        if warnings and not meta["convergence_status"]:
            logger.warning(f"Model at {path} has not been fully trained")
        return None if key is None else key_to_seed(key)

    # -- stats -------------------------------------------------------------------
    def compute_stats(self, CI: float = 0.95, save_matlab: bool = False):
        """Credible intervals and summary statistics, written into the
        analysis folder (see :func:`tapqir_tpu_torch.utils.stats.save_stats`).
        On a mesh (collective) the posterior marginals of a model with
        ``shards_posteriors`` are computed shard by shard, then the model
        leaves the mesh (:meth:`leave_mesh`) and the first rank writes the
        statistics; the others return None."""
        if self._mesh is not None:
            probs = self.compute_probs_arrays() if self.shards_posteriors else None
            if not self.leave_mesh():
                return None
            if probs is not None:
                self._probs_cache = probs
        summary = save_stats(self, self.path, CI=CI, save_matlab=save_matlab)
        logger.debug("Computing stats: Successful.")
        return summary
