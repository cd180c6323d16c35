"""Mesh sharding on ``torch.distributed``: one process per shard of an
("aoi", "frame") mesh (counterpart of tapqir_tpu/parallel/sharding.py).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
``shard_map`` place the arrays and issue the collectives. Here every shard
is a process of its own:

* :func:`make_mesh` describes the mesh: its shape and one device per shard,
  row-major over (aoi, frame) - shard ``a * n_frame + f`` - from a device
  list that may name one card several times (the port's counterpart of
  XLA's virtual devices);
* :func:`launch` spawns one process per shard, joins them in a process
  group that meets through a file in a temporary directory - NCCL when
  every shard has a card of its own, gloo when shards share a card or run
  on the CPU - and runs a function in each with its :class:`RankMesh`: the
  rank, its (aoi, frame) indices, its device, and the groups of its mesh
  row (the frame axis) and column (the aoi axis);
* every collective is an ``all_reduce``, the one collective gloo runs on
  CUDA tensors besides ``broadcast``: a gather is the ``all_reduce`` of a
  zero-filled (n, ...) buffer in which each rank writes its own slot, and
  the hmm chain's shift by one shard is that gather's slot rank - 1. Both
  are differentiable (:func:`all_gather`, :func:`shift_from_previous`);
* each process holds its AOI x frame block of the data and of every
  per-AOI / per-frame parameter and Adam moment, and a full copy of the
  global parameters (``Model.use_mesh``). After the backward pass each
  gradient is summed over exactly the mesh axes its parameter is
  replicated on (:func:`reduce_gradients`), which JAX's vma-typed AD does
  inside ``shard_map``; the loss is summed over the world, and the update
  is the dense Adam of ``optax.adam`` on every rank.

Random streams: each rank draws its frames and packed Gammas from a
generator of its own and its AOI rows from a generator shared by the frame
shards of its mesh row (the counterparts of ``fold_in(key, shard_id)`` and
``fold_in(key, aoi_index)``), so the frame shards of a row gather the same
AOI rows in the same order.
"""

import datetime
import logging
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from tapqir_tpu_torch.csrc import native

__all__ = [
    "Mesh",
    "MeshError",
    "RankMesh",
    "all_gather",
    "data_partition",
    "fit_restarts_sharded",
    "gather_blocks",
    "launch",
    "make_mesh",
    "reduce_gradients",
    "restart_param_specs",
    "shard_block",
    "shift_from_previous",
]

logger = logging.getLogger(__name__)

# seconds a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT = 600.0


class MeshError(RuntimeError):
    """A rank of a mesh run raised; the message holds its traceback."""


class Mesh:
    """An ("aoi", "frame") mesh: its shape and the device of each shard,
    row-major (shard ``a * n_frame + f``). Plain data, so it crosses into
    the spawned ranks."""

    def __init__(self, n_aoi, n_frame, devices):
        self.shape = {"aoi": int(n_aoi), "frame": int(n_frame)}
        self.devices = [str(torch.device(d)) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"{self.size} shards need {self.size} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self):
        return self.shape["aoi"] * self.shape["frame"]

    @property
    def backend(self):
        """NCCL when every shard has a card of its own (gloo then carries
        any collective of CPU tensors); gloo when shards share a card (NCCL
        refuses two ranks on one card) or run on the CPU."""
        cuda = all(torch.device(d).type == "cuda" for d in self.devices)
        return "nccl" if cuda and len(set(self.devices)) == self.size else "gloo"

    def __repr__(self):
        return (f"Mesh(aoi={self.shape['aoi']}, frame={self.shape['frame']}, "
                f"devices={self.devices}, backend={self.backend})")


def make_mesh(n_aoi, n_frame=1, devices=None):
    """An ("aoi", "frame") mesh of ``n_aoi`` x ``n_frame`` shards over
    ``devices`` (default: every visible card, one per shard). ``devices`` may
    repeat a card, or be one device name for every shard (``"cpu"``)."""
    n = n_aoi * n_frame
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = list(devices)
    if len(devices) < n:  # the JAX package's make_mesh asserts this
        raise AssertionError(f"need {n} devices, have {len(devices)}")
    return Mesh(n_aoi, n_frame, devices[:n])


def data_partition():
    """Mesh axes of the device-resident dataset arrays (JAX:
    ``data_partition``); the frame axis is never extended or padded."""
    return {
        "images": ("aoi", "frame", None, None),
        "xy": ("aoi", "frame", None, None),
        "is_ontarget": ("aoi",),
        "mask": ("aoi",),
        "offset_samples": (),
        "offset_logits": (),
    }


def restart_param_specs(param_specs):
    """Parameter axes with the leading (mesh-replicated) chain axis."""
    return {k: (None,) + tuple(s) for k, s in param_specs.items()}


# ---------------------------------------------------------------------------
# the process group of one rank
# ---------------------------------------------------------------------------


class _Axis:
    """A group of ranks along one mesh axis (or the world): its process
    group (None: the default group), its size and this rank's index in it."""

    def __init__(self, group, size, rank):
        self.group, self.size, self.rank = group, size, rank


class RankMesh:
    """The mesh as one rank sees it: ``rank``, ``aoi_index``,
    ``frame_index``, ``device``, and the groups ``world``, ``row`` (the
    ranks of this rank's mesh row: its frame axis) and ``col`` (its
    column: the aoi axis). Made by :func:`launch` in every rank."""

    def __init__(self, mesh, rank, device):
        self.mesh = mesh
        self.shape = dict(mesh.shape)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = mesh.backend
        n_aoi, n_frame = self.shape["aoi"], self.shape["frame"]
        self.aoi_index, self.frame_index = divmod(rank, n_frame)
        self.world = _Axis(None, mesh.size, rank)
        # every rank creates every subgroup, in the same order
        self.row = self._subgroups([[a * n_frame + f for f in range(n_frame)]
                                    for a in range(n_aoi)], self.aoi_index, self.frame_index)
        self.col = self._subgroups([[a * n_frame + f for a in range(n_aoi)]
                                    for f in range(n_frame)], self.frame_index, self.aoi_index)

    def _subgroups(self, groups, mine, index):
        size = len(groups[0])
        if size == 1:
            return _Axis(None, 1, 0)
        if size == self.world.size:
            return self.world
        handles = [dist.new_group(g) for g in groups]
        return _Axis(handles[mine], size, index)

    @property
    def size(self):
        return self.world.size

    @property
    def is_main(self):
        return self.rank == 0

    def reshaped(self, n_aoi, n_frame):
        """The same ranks as an ``n_aoi`` x ``n_frame`` mesh (a new set of
        row and column groups on the same world)."""
        mesh = Mesh(n_aoi, n_frame, self.mesh.devices)
        return RankMesh(mesh, self.rank, self.device)



# ---------------------------------------------------------------------------
# collectives, each an all_reduce
# ---------------------------------------------------------------------------


def all_reduce(t, axis):
    """Sum ``t`` over ``axis`` in place (nothing on an axis of one rank);
    returns ``t``."""
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def from_first(t, axis):
    """``t`` of the first rank of ``axis`` on every rank of it (an
    all_reduce in which the other ranks add zeros)."""
    if axis.size == 1:
        return t
    out = t.clone() if axis.rank == 0 else torch.zeros_like(t)
    return all_reduce(out, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        buf = x.new_zeros((axis.size,) + tuple(x.shape))
        buf[axis.rank] = x
        return all_reduce(buf, axis)

    @staticmethod
    def backward(ctx, grad):
        # every rank's cotangent of this rank's slot, summed: a reduce-scatter
        total = all_reduce(grad.contiguous().clone(), ctx.axis)
        return total[ctx.axis.rank], None


def all_gather(x, axis):
    """(axis.size, *x.shape): every rank's ``x`` of ``axis``, in rank
    order. Differentiable: the gradient of a rank's ``x`` is the sum over
    the ranks of their cotangents of its slot."""
    if axis.size == 1:
        return x.unsqueeze(0)
    return _Gather.apply(x, axis)


def shift_from_previous(x, axis):
    """The ``x`` of the previous rank of ``axis`` (the last rank's on the
    first): JAX's ``ppermute`` by one, built from :func:`all_gather`."""
    return all_gather(x, axis)[(axis.rank - 1) % axis.size]


# ---------------------------------------------------------------------------
# blocks of the mesh
# ---------------------------------------------------------------------------


def _block_slices(shape, spec, mesh):
    n = mesh.shape
    index = {"aoi": mesh.aoi_index, "frame": mesh.frame_index}
    out = []
    for d, ax in enumerate(spec):
        if ax in ("aoi", "frame"):
            if shape[d] % n[ax]:
                raise ValueError(f"axis {d} of size {shape[d]} does not split over "
                                 f"{n[ax]} {ax} shards")
            b = shape[d] // n[ax]
            out.append((d, index[ax] * b, b))
    return out


def shard_block(v, spec, mesh):
    """This rank's block of the full array ``v`` with mesh axes ``spec``
    (JAX: ``shard_params_and_data``), as a tensor of its own."""
    for d, start, size in _block_slices(v.shape, spec, mesh):
        v = v.narrow(d, start, size)
    return v.clone(memory_format=torch.contiguous_format)


def gather_blocks(v, spec, mesh):
    """The full array from every rank's block ``v`` with mesh axes
    ``spec``, on every rank. A global (no mesh axis) is returned as it is."""
    axes = [ax for ax in spec if ax in ("aoi", "frame")]
    if not axes:
        return v
    slots = all_gather(v.contiguous(), mesh.world)
    n_aoi, n_frame = mesh.shape["aoi"], mesh.shape["frame"]
    rows = []
    for a in range(n_aoi):
        blocks = [slots[a * n_frame + f] for f in range(n_frame)]
        rows.append(torch.cat(blocks, spec.index("frame")) if "frame" in axes else blocks[0])
    return torch.cat(rows, spec.index("aoi")) if "aoi" in axes else rows[0]


def _replicated_on(spec):
    """The group a parameter of mesh axes ``spec`` is replicated on:
    "world" (a global), "row" (sharded over aoi only), "col" (over frame
    only), or None (sharded over both)."""
    axes = set(spec)
    if "aoi" in axes:
        return None if "frame" in axes else "row"
    return "col" if "frame" in axes else "world"


def _split(flat, like):
    """``flat`` cut into tensors shaped as those of ``like``."""
    out, o = [], 0
    for t in like:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def _sum_flat(tensors, axis):
    """All-reduce a list of tensors as one flat buffer; returns the sums."""
    if axis.size == 1 or not tensors:
        return tensors
    return _split(all_reduce(torch.cat([t.reshape(-1) for t in tensors]), axis), tensors)


def reduce_gradients(mesh, specs, loss, grads):
    """The loss summed over the world, and each gradient summed over the
    mesh axes its parameter (of mesh axes ``specs[name]``) is replicated on:
    globals over the world, per-AOI parameters over the mesh row, per-AOI-
    frame ones not at all. One all_reduce per group."""
    names = {"world": [], "row": [], "col": []}
    for k in grads:
        where = _replicated_on(specs[k])
        if where is not None:
            names[where].append(k)
    out = dict(grads)
    summed = _sum_flat([loss] + [grads[k] for k in names["world"]], mesh.world)
    loss = summed[0]
    out.update(zip(names["world"], summed[1:]))
    for where in ("row", "col"):
        out.update(zip(names[where], _sum_flat([grads[k] for k in names[where]],
                                               getattr(mesh, where))))
    return loss, out


def sync_replicated(trees, specs, mesh):
    """Copy every replicated tensor of ``trees`` (dicts keyed by parameter
    name) from the first rank of the group it is replicated on, in place,
    so that replicas start bitwise equal."""
    for where in ("world", "row", "col"):
        axis = getattr(mesh, where)
        ts = [t for tree in trees for k, t in tree.items() if _replicated_on(specs[k]) == where]
        if axis.size == 1 or not ts:
            continue
        first = from_first(torch.cat([t.reshape(-1) for t in ts]), axis)
        for t, s in zip(ts, _split(first, ts)):
            t.copy_(s)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _rank_main(rank, mesh, store, fn, args, kwargs, timeout):
    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    if rank != 0:  # the first rank alone logs
        logging.getLogger("tapqir_tpu_torch").setLevel(logging.ERROR)
    # with NCCL for the cards, a collective of CPU tensors goes over gloo
    backend = "cpu:gloo,cuda:nccl" if mesh.backend == "nccl" else "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{store}/rendezvous", world_size=mesh.size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(RankMesh(mesh, rank, device), *args, **kwargs)
        if rank == 0:
            with open(Path(store) / "result.pkl", "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        # when and where it failed: the first rank to fail holds the cause,
        # the others mostly lost their connection to it
        (Path(store) / f"rank{rank}.err").write_text(
            f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(store, mesh, err):
    """The traceback of the rank that failed first (``err`` if none wrote
    one: a rank killed by a signal)."""
    failed = []
    for path in Path(store).glob("rank*.err"):
        when, _, text = path.read_text().partition("\n")
        failed.append((float(when), int(path.stem[4:]), text))
    if not failed:
        return f"a rank of the {mesh} failed:\n{err}"
    when, rank, text = min(failed)
    return (f"rank {rank} of the {mesh} failed first ({len(failed)} of {mesh.size} "
            f"raised):\n{text}")


def launch(mesh, fn, *args, timeout=DEFAULT_TIMEOUT, **kwargs):
    """Run ``fn(rank_mesh, *args, **kwargs)`` in one spawned process per
    shard of ``mesh`` and return the first rank's return value (which must
    pickle, so hand back host data). ``fn`` must be importable by name (a
    module-level function); the arguments are pickled into each rank.

    The ranks start with ``torch.multiprocessing``'s ``spawn`` (CUDA may be
    live in the caller), meet through a ``file://`` store in a temporary
    directory (no port to collide), and wait at most ``timeout`` seconds in
    a collective. Each rank selects its card before anything runs on it.
    On a card mesh every CUDA library declared in this process (the
    models' modules declare them all) is built here, once, before the
    spawn (``native.build_cuda``). If any rank raises, the others are
    stopped and :class:`MeshError` is raised with that rank's traceback."""
    if any(torch.device(d).type == "cuda" for d in mesh.devices):
        native.build_cuda()
    logger.info(f"Mesh {mesh.shape['aoi']} aoi x {mesh.shape['frame']} frame on "
                f"{mesh.devices} over {mesh.backend}")
    with tempfile.TemporaryDirectory(prefix="tapqir_mesh_") as store:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(mesh, store, fn, args, kwargs, timeout), nprocs=mesh.size,
            join=False, start_method="spawn",
        )
        try:
            while not ctx.join():
                pass
        except ProcessException as err:
            raise MeshError(_first_failure(store, mesh, err)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        with open(Path(store) / "result.pkl", "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# batched random restarts over the mesh
# ---------------------------------------------------------------------------


def fit_restarts_sharded(model, mesh, num_restarts=4, num_iter=2000, lr=None,
                         perturb=0.0, chunk=200, seed=None, progress=None, params=None,
                         batches=None, draws=None):
    """R independent SVI chains, each sharded over the whole mesh (JAX:
    ``fit_restarts_sharded``); call in every rank with its
    :class:`RankMesh`. The chain axis is replicated over the mesh and each
    chain shards the data: the (R, ...) initial parameters are
    ``stack_params`` of the model's padded parameters, and every rank takes
    its block of each. The steps are ``fit_restarts``' (one chain-batched
    ELBO and one kernel launch per rank and step), with the mesh's gradient
    reductions; every rank selects the same chain from the world-summed
    losses, and on return the model holds its block of the winner on the
    mesh (``Model.use_mesh``) with a fresh Adam state (zero moments, step
    count 0), as the JAX package's mesh restarts hand it over.

    ``params`` replaces the stacked initial parameters with full-size (R,
    ...) arrays; ``batches[i]`` and ``draws[i]`` replace this rank's batch
    and draws of step i (see ``fit_restarts``)."""
    from tapqir_tpu_torch.parallel.restarts import DEFAULT_SEED, fit_restarts, stack_params

    seed = DEFAULT_SEED if seed is None else seed
    model.pad_for_mesh(mesh)
    if params is None:
        params = stack_params(model.params, num_restarts, perturb, seed)
    model.use_mesh(mesh)
    specs = restart_param_specs(model.param_partition())
    local = {k: shard_block(torch.as_tensor(v).to(model.device, model.dtype), specs[k], mesh)
             for k, v in params.items()}
    del params
    losses, best = fit_restarts(model, num_restarts=num_restarts, num_iter=num_iter, lr=lr,
                                chunk=chunk, seed=seed, progress=progress, params=local,
                                batches=batches, draws=draws)
    opt = model.opt_state
    with torch.no_grad():
        for v in [*opt["mu"].values(), *opt["nu"].values(), opt["count"]["g"]]:
            v.zero_()
    model._mesh_t = 0
    return losses, best

