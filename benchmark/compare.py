"""The comparison that decides ``correct``: the program's first SVI steps,
on the batches and standard-Gamma draws it made itself, against the plain
reference's over the same data, batches and draws.

Each number is held to a limit of its cell (``cells/<workload>.json``):

* ``loss_gap`` - the largest relative gap of a step's loss, |program -
  reference| / |reference|, over the checked steps;
* ``grad_gap`` - the first step's gradient as the optimizer got it, worked
  out from its first moments after one step (mu / (1 - b1)): per leaf the
  gap between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf; the worst leaf;
* ``change_gap`` - the parameters' change over the checked steps (after
  the last minus before the first): per leaf the same gap of norms, the
  worst leaf, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves them by round-off alone);
* ``change_median_gap`` - the same gaps' median leaf, which a fault in most
  leaves moves far above its floor;
* ``draw_z`` - the program's standard-Gamma draws against Gamma of the
  reference's concentrations: the largest |z| of their first and second
  moments over the steps (``reference.draw_moments``);
* ``draw_repeat`` - the largest share of draws that one step repeats, in
  place, from another;
* ``batch_repeat`` - the largest share of AOI rows, or of frames, that one
  step's batch shares with another's (frames drawn anew share about 65%
  by chance at 512 of 790);
* ``batch_size_gap`` - the largest share of a step's batch short of the
  configured rows and frames, all distinct and in range (0 when sound).
"""

import itertools

import numpy as np

B1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_median_gap", "draw_z",
           "draw_repeat", "batch_repeat", "batch_size_gap")
SILENT_LEAF = 1e-3


def norms(state):
    """Per-leaf norms of the first gradient and of the change, and the
    losses, of a state (``losses``, ``mu1``, ``p0``, ``p_end``)."""
    grad = {k: float(np.linalg.norm(np.asarray(v, np.float64).ravel())) / (1.0 - B1)
            for k, v in state["mu1"].items()}
    change = {k: float(np.linalg.norm((np.asarray(state["p_end"][k], np.float64)
                                       - np.asarray(state["p0"][k], np.float64)).ravel()))
              for k in state["p0"]}
    return [float(x) for x in state["losses"]], grad, change


def _gaps(prog, ref, leaves):
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else np.inf
            for k in leaves}


def _pairs_share(items, share):
    return max((share(a, b) for a, b in itertools.combinations(items, 2)), default=0.0)


def batch_numbers(state, sizes, extent):
    """``batch_repeat`` and ``batch_size_gap`` of a state's ``batches``
    ((rows, frames) per step) for the configured batch ``sizes`` (n, f)
    over the data's ``extent`` (Nt, F)."""
    batches = state["batches"]

    def overlap(a, b):
        rows = len(np.intersect1d(a[0], b[0])) / max(len(a[0]), 1)
        frames = len(np.intersect1d(a[1], b[1])) / max(len(a[1]), 1)
        return max(rows, frames)

    short = 0.0
    for ndx, fidx in batches:
        for idx, want, top in ((ndx, sizes[0], extent[0]), (fidx, sizes[1], extent[1])):
            valid = len(np.unique(idx[(idx >= 0) & (idx < top)]))
            short = max(short, abs(want - valid) / want, abs(len(idx) - want) / want)
    return _pairs_share(batches, overlap), short


def readings(program, reference, sizes, extent, detail=False):
    """The numbers of ``program`` against ``reference`` (states as
    :func:`norms` takes them, with ``batches`` and ``draws``; the
    reference's with ``draw_z``), for the configured batch ``sizes`` (n, f)
    over the data's ``extent`` (Nt, F)."""
    lp, gp, cp = norms(program)
    lr, gr, cr = norms(reference)
    if len(lp) != len(lr) or set(gp) != set(gr):
        raise ValueError("the program's steps or leaves differ from the reference's")
    loss = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    leaves = sorted(gr)
    g_gaps = _gaps(gp, gr, leaves)
    grad_leaf = max(g_gaps, key=g_gaps.get)
    med_g = float(np.median([gr[k] for k in leaves]))
    moving = [k for k in leaves if gr[k] >= SILENT_LEAF * med_g]
    c_gaps = _gaps(cp, cr, moving)
    change_leaf = max(c_gaps, key=c_gaps.get)
    draws = [np.asarray(d) for d in program["draws"]]
    repeat = _pairs_share(draws, lambda a, b: float(np.mean(a == b)) if a.shape == b.shape
                          else 0.0)
    batch_repeat, batch_short = batch_numbers(program, sizes, extent)
    out = {"loss_gap": loss, "grad_gap": g_gaps[grad_leaf], "change_gap": c_gaps[change_leaf],
           "change_median_gap": float(np.median(list(c_gaps.values()))),
           "draw_z": max(abs(z) for zs in reference["draw_z"] for z in zs),
           "draw_repeat": repeat, "batch_repeat": batch_repeat, "batch_size_gap": batch_short}
    if detail:
        out.update(grad_leaf=grad_leaf, change_leaf=change_leaf,
                   silent_leaves=sorted(set(leaves) - set(moving)),
                   draw_moments=reference["draw_z"],
                   losses_program=lp, losses_reference=lr,
                   grad_norms={k: [gp[k], gr[k]] for k in leaves},
                   change_norms={k: [cp[k], cr[k]] for k in leaves})
    return out


def batch_sizes(cfg):
    """The configured batch (AOI rows, frames) and the data's (Nt, F)."""
    g, fit = cfg["geometry"], cfg["fit"]
    return (min(fit["nbatch"], g["Nt"]), min(fit["fbatch"], g["F"])), (g["Nt"], g["F"])
