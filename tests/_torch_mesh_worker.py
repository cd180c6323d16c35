"""Rank functions of the port's mesh tests (tests/test_torch_sharding*.py).

``launch`` spawns its ranks, and spawn imports the module of the function
it runs in every rank: so this module imports the port and torch only,
never JAX or the JAX package. Each rank function runs a list of cases on
one process group, reshaping the mesh per case, and the first rank returns
every case's result as numpy arrays. The inputs (datasets, parameters, and
the JAX run's per-shard batches and draws) arrive as numpy arrays."""

import numpy as np
import torch

from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.ops.scan import sharded_cumulative_logmatmulexp
from tapqir_tpu_torch.parallel import sharding


def port_model(spec):
    """A float64 CPU model of ``spec``: its dataset, batch sizes, route and
    (unconstrained) parameters, with a fresh optimizer state."""
    m = models[spec["model"]](device="cpu", dtype="double")
    m.data = spec["data"]
    m.nbatch_size, m.fbatch_size = spec["nbatch"], spec["fbatch"]
    m.use_factored = spec.get("factored", False)
    m.lr = 0.005
    m.init_parameters()
    m._data_dev = m._data_device_arrays()
    m._build_constants()
    m.params = {k: torch.tensor(np.asarray(v, np.float64)) for k, v in spec["params"].items()}
    m.opt_state = m._init_opt_state()
    m.iter = 0
    return m


def _batch(b):
    ndx, fidx, f = b
    return (torch.as_tensor(ndx, dtype=torch.long),
            None if fidx is None else torch.as_tensor(fidx, dtype=torch.long), f)


def _gathered(m, tree, mesh, specs=None):
    """Every rank's blocks of ``tree`` as full (padded) numpy arrays."""
    specs = specs or m.param_partition()
    return {k: sharding.gather_blocks(v, specs[k], mesh).numpy() for k, v in tree.items()}


def case_step(mesh, c):
    """One sharded step with this rank's injected batch and draws: the
    mesh's loss and the full (padded) reduced gradients."""
    m = port_model(c["spec"])
    m.use_mesh(mesh)
    loss, grads = m._mesh_loss_and_grads(
        None, batch=_batch(c["batches"][mesh.rank]),
        draws=torch.as_tensor(c["draws"][mesh.rank]))
    return {"loss": float(loss), "grads": _gathered(m, grads, mesh),
            "padded": m._aoi_pad, "mask": m._data_dev["mask"].numpy()}


def case_probs(mesh, c):
    """The sharded posterior marginals with this rank's injected draws."""
    m = port_model(c["spec"])
    m.use_mesh(mesh)
    draws = {k: torch.as_tensor(v) for k, v in c["draws"][mesh.rank].items()}
    z, th = m.compute_probs_arrays(num_particles=c["num_particles"], draws=draws)
    return {"z": z, "theta": th}


def case_scan(mesh, c):
    """The frame-sharded prefix scan of the rank's block of ``log_mats``
    (n, F, S, S) and its gradient against ``weights``, both gathered."""
    F_l = c["log_mats"].shape[1] // mesh.shape["frame"]
    sl = slice(mesh.frame_index * F_l, (mesh.frame_index + 1) * F_l)
    x = torch.tensor(c["log_mats"][:, sl]).requires_grad_(True)
    out = sharded_cumulative_logmatmulexp(x, 1, mesh.row)
    (grad,) = torch.autograd.grad((out * torch.tensor(c["weights"][:, sl])).sum(), x)
    spec = (None, "frame", None, None)
    return {"out": sharding.gather_blocks(out.detach(), spec, mesh).numpy(),
            "grad": sharding.gather_blocks(grad, spec, mesh).numpy()}


def case_collectives(mesh, c):
    """The gather and the shift of a rank-dependent vector, each under a
    rank-dependent weighted sum: values and gradients, gathered."""
    r = mesh.rank
    x = (torch.arange(3, dtype=torch.float64) + 10.0 * r).requires_grad_(True)
    g = sharding.all_gather(x, mesh.world)
    s = sharding.shift_from_previous(x, mesh.world)
    w = torch.tensor(c["weights"][r])  # (world + 1, 3)
    (grad,) = torch.autograd.grad((w[:-1] * g).sum() + (w[-1] * s).sum(), x)
    return {"gather": g.detach().numpy(), "shift": sharding.all_gather(s.detach(), mesh.world)
            .numpy(), "grad": sharding.all_gather(grad, mesh.world).numpy()}


def case_restarts(mesh, c):
    """``fit_restarts_sharded`` with the JAX run's full-size initial chains
    and this rank's injected batches and draws: the losses, the best chain
    and the winner's gathered parameters, moments and count."""
    m = port_model(c["spec"])
    R = c["R"]
    batches, draws = [], []
    for step in c["steps"]:
        ndx, fidx, f = step["batches"][mesh.rank]
        batches.append((torch.as_tensor(ndx), None if fidx is None else torch.as_tensor(fidx),
                        f))
        draws.append(torch.as_tensor(step["draws"][mesh.rank]))
    losses, best = sharding.fit_restarts_sharded(
        m, mesh, num_restarts=R, num_iter=len(c["steps"]), chunk=c["chunk"],
        params={k: torch.tensor(v) for k, v in c["init"].items()},
        batches=batches, draws=draws)
    opt = m.opt_state
    trees = {name: m.gather_tree(t) for name, t in
             (("params", m.params), ("mu", opt["mu"]), ("nu", opt["nu"]))}
    return {"losses": losses, "best": best, **trees, "count": int(opt["count"]["g"]),
            "iter": m.iter, "iter_loss": m.iter_loss}


def case_checkpoint(mesh, c):
    """A mesh fit of the workspace ``c["path"]`` (4 steps, a checkpoint
    every 2), its posterior marginals, then a second model that resumes the
    checkpoint on the mesh for 2 more steps."""
    out = {}
    m = models["cosmos"](device="cpu")
    m.load(c["path"])
    m.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    m.use_mesh(mesh)
    out["padded_aois"] = m.mesh_aoi_padding(mesh)
    out["local_b_loc"] = tuple(m.params["b_loc"].shape)
    m.checkpoint_interval = 2
    m.run(4)
    out["z"], out["theta"] = m.compute_probs_arrays(num_particles=2)
    m2 = models["cosmos"](device="cpu")
    m2.load(c["path"])
    m2.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    out["resumed_iter"] = m2.iter
    m2.use_mesh(mesh)
    out["resumed_padded_aois"] = m2._aoi_pad + m2.data.Nt
    m2.checkpoint_interval = 2
    m2.run(2)
    out["final_iter"] = m2.iter
    return out


def case_nan_reload(mesh, c):
    """A mesh fit of ``c["path"]`` (2 steps, checkpointed), then a NaN put
    into one rank's block of b_loc: the next run's NaN guard must fire on
    every rank (the loss is summed over the mesh), reload the checkpoint on
    the mesh and reseed every rank alike, and finish its 2 steps."""
    m = models["cosmos"](device="cpu")
    m.load(c["path"])
    m.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    m.use_mesh(mesh)
    m.run(2)
    if mesh.rank == 1:
        m.params["b_loc"].fill_(float("nan"))
    m.run(2)
    seeds = sharding.all_gather(torch.tensor([m._seed], dtype=torch.float64), mesh.world)
    finite = all(bool(torch.isfinite(v).all()) for v in m.params.values())
    return {"iter": m.iter, "seeds": seeds.numpy(), "finite": finite,
            "local_b_loc": tuple(m.params["b_loc"].shape)}


def case_raise(mesh, c):
    """The second rank raises while the others wait in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    sharding.all_reduce(torch.ones(1), mesh.world)
    return {}


CASES = {f.__name__[5:]: f for f in (case_step, case_probs, case_scan, case_collectives,
                                     case_restarts, case_checkpoint, case_nan_reload,
                                     case_raise)}


def run_cases(mesh, cases):
    """Run ``cases`` (dicts with ``kind`` and ``shape`` (n_aoi, n_frame))
    in turn on this rank's process group; the first rank returns the list
    of their results."""
    torch.set_num_threads(1)
    out = []
    for c in cases:
        sub = mesh.reshaped(*c["shape"])
        out.append(CASES[c["kind"]](sub, c))
    return out
