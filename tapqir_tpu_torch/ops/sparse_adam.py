"""The window-space sparse Adam of the sparse SVI step: its two CUDA kernels
(``csrc/sparse_adam.cu``), and their plain PyTorch versions.

The step (``Model._sparse_step``) reads, steps and writes back only the
minibatch's windows of the parameters and Adam moments: rows ``ndx`` x
frames ``fidx`` of a per-AOI-frame leaf ("af"), rows ``ndx`` of a per-AOI
leaf ("a"), a global leaf ("g") whole, with per-row-group step counts (one
for globals, one per AOI, one per (AOI, frame)). Two functions:

* :func:`window_gather` copies every leaf's window out of the parameters
  into the ELBO's leaves (``requires_grad``);
* :func:`window_adam` takes the Adam step of every window element from its
  gradient, writes the parameter and both moments back in place and bumps
  the step counts of the window.

On CUDA tensors each is one launch of a kernel (``gather`` / ``adam``, the
launch counts on their ``launches``); the gather's leaves are views of one
flat buffer. CPU tensors take the plain versions (``window_gather_plain``,
``window_adam_plain``): per-leaf ``index_select`` / ``index_copy_`` and
element-wise ops. There is no fallback from one to the other.

Both kernels take the window's layout from a :class:`WindowLayout`, made
once per model and window shape: each leaf's window shape and place in the
flat buffer, and on a card the slot table and group sizes of the kernels
(see the note atop the source).
"""

import ctypes
import math

import numpy as np
import torch

from tapqir_tpu_torch.csrc import native

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
THREADS = 256  # kThreads: a block's threads, and the most positions it takes
BLOCK_ELEMENTS = 512  # a block's share of elements: positions x slots
GROUPS = ("g", "a", "af")  # the kernels' group order


# ---------------------------------------------------------------------------
# plain versions (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------


def gather_plain(tree, wspec, ndx, fidx):
    """Windows of a parameter-shaped dict: AOI rows ``ndx`` x frames
    ``fidx`` (``None``: every frame). Globals pass through."""
    out = {}
    for name, v in tree.items():
        if name not in wspec:
            out[name] = v
            continue
        a_ax, f_ax = wspec[name]
        rows = v.index_select(a_ax, ndx)
        if fidx is not None and f_ax is not None:
            rows = rows.index_select(f_ax, fidx)
        out[name] = rows
    return out


def scatter_plain(tree, win, wspec, ndx, fidx):
    """Inverse of :func:`gather_plain`. Unlike the JAX package, which builds
    new arrays, this writes the windows back IN PLACE with ``index_copy_``:
    the full parameter and Adam arrays are never copied. Indices are
    unique, so the writes do not collide."""
    for name, v in tree.items():
        if name not in wspec:
            v.copy_(win[name])
            continue
        a_ax, f_ax = wspec[name]
        w = win[name]
        if fidx is not None and f_ax is not None:
            rows = v.index_select(a_ax, ndx)
            rows.index_copy_(f_ax, fidx, w)
            w = rows
        v.index_copy_(a_ax, ndx, w)


def window_gather_plain(params, layout, ndx, fidx):
    """The ELBO's leaves: a copy of each parameter's window, with
    ``requires_grad``."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in gather_plain(params, layout.wspec, ndx, fidx).items()}


def window_adam_plain(params, opt_state, win, grads, layout, ndx, fidx, lr):
    """One sparse Adam step in window space, in place: bumps the step counts
    of the window's rows, steps the windows ``win`` of ``params`` with the
    gradients ``grads`` (in ``win``'s order) and writes parameters and
    moments back."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    Nt, F, groups, wspec = layout.Nt, layout.F, layout.groups, layout.wspec
    mu_win = gather_plain(opt_state["mu"], wspec, ndx, fidx)
    nu_win = gather_plain(opt_state["nu"], wspec, ndx, fidx)
    # non-finite gradient elements become zero (see the JAX package)
    g_win = {
        k: torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        for k, g in zip(win, grads)
    }
    counts = opt_state["count"]

    # per-row-group step counts: bump the gathered window rows only
    counts["g"] += 1
    t_win = {}
    if "a" in counts:
        t_a = counts["a"].index_select(0, ndx) + 1
        counts["a"].index_copy_(0, ndx, t_a)
        t_win["a"] = t_a  # (n,)
    if "af" in counts:
        view = counts["af"].view(Nt, F)
        rows = view.index_select(0, ndx)  # (n, F)
        if fidx is not None:
            t_af = rows.index_select(1, fidx) + 1
            rows.index_copy_(1, fidx, t_af)
        else:
            t_af = rows + 1
            rows = t_af
        view.index_copy_(0, ndx, rows)
        t_win["af"] = t_af  # (n, f_b)
    # the bias correction of row groups is float32, as in the JAX package
    corr = {
        grp: (1.0 - b1 ** t.to(torch.float32), 1.0 - b2 ** t.to(torch.float32))
        for grp, t in t_win.items()
    }
    t_g = counts["g"]

    p_w, mu_w, nu_w = {}, {}, {}
    with torch.no_grad():
        for name, p in win.items():
            g, mu, nu = g_win[name], mu_win[name], nu_win[name]
            mu2 = b1 * mu + (1.0 - b1) * g
            nu2 = b2 * nu + (1.0 - b2) * g * g
            kind, _ = groups[name]
            if kind == "g":
                t = t_g.to(p.dtype)
                c1, c2 = 1.0 - b1**t, 1.0 - b2**t
            else:
                a_ax, f_ax = wspec[name]
                c1, c2 = corr[kind]
                bshape = [1] * p.ndim
                bshape[a_ax] = c1.shape[0]
                if kind == "af":
                    bshape[f_ax] = c1.shape[1]
                c1, c2 = c1.reshape(bshape), c2.reshape(bshape)
            p_w[name] = p.detach() - lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
            mu_w[name] = mu2
            nu_w[name] = nu2
        scatter_plain(params, p_w, wspec, ndx, fidx)
        scatter_plain(opt_state["mu"], mu_w, wspec, ndx, fidx)
        scatter_plain(opt_state["nu"], nu_w, wspec, ndx, fidx)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


class WindowLayout:
    """Where each leaf's window lies, for parameters shaped as ``params``,
    row groups ``groups`` and window axes ``wspec`` (``Model._row_groups``
    and ``Model._window_spec``), Nt AOIs x F frames, windows of ``n`` rows
    x ``f`` frames (``None``: every frame).

    ``shapes`` / ``sizes``: each leaf's window shape and element count, in
    the order of the leaves in the gather's flat buffer.
    ``slots`` (nslots, 4: leaf, stride, full base, window base) and
    ``meta`` (per group of ``GROUPS``: positions, positions a block,
    blocks, first and end slot; then f and F) describe the windows to the
    kernels; on a card ``slots`` is also kept on the device (``slots_dev``),
    put there once, after the library is built and its threads a block
    found equal to the ``THREADS`` the layout takes."""

    def __init__(self, params, groups, wspec, Nt, F, n, f=None):
        self.groups, self.wspec = groups, wspec
        self.Nt, self.F, self.n, self.f = Nt, F, n, f
        fw = F if f is None else f
        self.names = list(params)
        self.full_shapes = [tuple(v.shape) for v in params.values()]
        self.shapes, slots = [], {grp: [] for grp in GROUPS}
        for leaf, (name, v) in enumerate(params.items()):
            shape = list(v.shape)
            kind, ax = groups[name]
            if kind == "g":
                slots["g"] += [(leaf, 0, e, e) for e in range(v.numel())]
                self.shapes.append(tuple(shape))
                continue
            lead = math.prod(shape[:ax])
            rows = (Nt, F) if kind == "af" else (Nt,)
            wrows = (n, fw) if kind == "af" else (n,)
            trail = math.prod(shape[ax + len(rows):])
            full_rows, win_rows = math.prod(rows), math.prod(wrows)
            slots[kind] += [(leaf, trail, (l * full_rows) * trail + t, (l * win_rows) * trail + t)
                            for l in range(lead) for t in range(trail)]
            shape[ax:ax + len(rows)] = wrows
            self.shapes.append(tuple(shape))
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)
        npos = {"g": 1, "a": n, "af": n * fw}
        meta, table = [], []
        for grp in GROUPS:
            E = len(slots[grp])
            P = max(1, min(THREADS, BLOCK_ELEMENTS // max(E, 1)))
            blocks = -(-npos[grp] // P) if E else 0
            meta += [npos[grp], P, blocks, len(table), len(table) + E]
            table += slots[grp]
        meta += [fw, F]
        self.meta = meta
        self.slots = np.asarray(table, np.int64).reshape(-1, 4)
        self.blocks = sum(meta[2:15:5])
        self.slots_dev = None
        self._meta_c = (ctypes.c_longlong * len(meta))(*meta)
        dev = next(iter(params.values())).device
        if dev.type == "cuda":
            library.get()
            if library.limits["sa_threads"] != THREADS:
                raise RuntimeError(f"{library.path.name}: {library.limits['sa_threads']} "
                                   f"threads a block, the layout takes {THREADS}")
            self.slots_dev = torch.as_tensor(self.slots, device=dev)


# ---------------------------------------------------------------------------
# the library and its launchers
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
library = native.Library(
    "sparse_adam.cu", "sparse_adam",
    # adam, meta (host), slots, pointers (host), L, ndx, fidx, counts (host),
    # lr, stream
    {"sa_window": [ctypes.c_int, _ptr, _ptr, _ptr, ctypes.c_int, _ptr, _ptr, _ptr,
                   ctypes.c_double, _ptr]},
    probes=("sa_max_leaves", "sa_threads"),
)


class _Launcher(native.Kernel):
    """One of the two kernels: the gather, or with ``adam`` the Adam step."""

    def __init__(self, name, adam):
        super().__init__(name, library, "sa_window")
        self.adam = adam

    def __call__(self, layout, params, mu, nu, windows, ndx, fidx, counts=None, lr=0.0):
        """Launch over ``layout``: ``params``, ``mu``, ``nu`` and ``windows``
        are lists of tensors in the layout's leaf order (mu and nu None for
        the gather), ``windows`` the gather's output windows or the
        gradients; ``counts`` the step counts of ``GROUPS`` (None where the
        group has no leaf)."""
        first = params[0]
        fn = self.function(first)
        L, max_leaves = len(params), library.limits["sa_max_leaves"]
        if L != len(layout.names) or L > max_leaves:
            raise ValueError(f"{L} leaves for a layout of {len(layout.names)}; the kernel "
                             f"takes at most {max_leaves}")
        shapes = [(params, layout.full_shapes), (windows, layout.shapes)]
        if self.adam:
            shapes += [(mu, layout.full_shapes), (nu, layout.full_shapes)]
        for tree, want in shapes:
            if len(tree) != L:
                raise ValueError(f"{len(tree)} tensors for a layout of {L} leaves")
            native.check_tensors(tree, first, want)
        for idx, size in ((ndx, layout.n), (fidx, layout.f)):
            if idx is None and size is None:
                continue
            if idx is None or idx.dtype != torch.int64 or idx.device != first.device \
                    or idx.shape != (size,) or not idx.is_contiguous():
                raise TypeError(f"indices must be contiguous int64 ({size},) on {first.device}")
        cnt = (ctypes.c_void_p * 3)()
        if self.adam:
            for i, grp in enumerate(GROUPS):
                c = counts.get(grp)
                if c is None:
                    if layout.meta[5 * i + 2]:
                        raise ValueError(f"no step counts for the {grp!r} leaves")
                    continue
                if c.dtype != torch.int32 or c.device != first.device or not c.is_contiguous():
                    raise TypeError(f"the {grp!r} step counts must be contiguous int32 on "
                                    f"{first.device}")
                cnt[i] = c.data_ptr()
        ptrs = (ctypes.c_void_p * (4 * L))(
            *[t.data_ptr() for t in params],
            *([t.data_ptr() for t in mu] if self.adam else [None] * L),
            *([t.data_ptr() for t in nu] if self.adam else [None] * L),
            *[t.data_ptr() for t in windows],
        )
        self.launch(fn, first, int(self.adam), layout._meta_c, layout.slots_dev.data_ptr(),
                    ptrs, L, ndx.data_ptr(), None if fidx is None else fidx.data_ptr(), cnt,
                    float(lr))


gather = _Launcher("gather", adam=False)  # the parameter windows, before the ELBO
adam = _Launcher("adam", adam=True)  # the Adam step and write-back, after its gradient


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def window_gather(params, layout, ndx, fidx):
    """The ELBO's leaves (name -> window with ``requires_grad``): on a card
    views of one flat buffer filled by one launch, on the CPU
    :func:`window_gather_plain`."""
    if layout.slots_dev is None:
        return window_gather_plain(params, layout, ndx, fidx)
    first = next(iter(params.values()))
    buf = torch.empty((layout.total,), dtype=first.dtype, device=first.device)
    leaves = [v.view(s) for v, s in zip(buf.split(layout.sizes), layout.shapes)]
    gather(layout, [params[k] for k in layout.names], None, None, leaves, ndx, fidx)
    return {k: v.requires_grad_(True) for k, v in zip(layout.names, leaves)}


def window_adam(params, opt_state, win, grads, layout, ndx, fidx, lr):
    """The sparse Adam step of the windows ``win`` with gradients ``grads``,
    in place on ``params`` and ``opt_state``: on a card one launch, on the
    CPU :func:`window_adam_plain`."""
    if layout.slots_dev is None:
        return window_adam_plain(params, opt_state, win, grads, layout, ndx, fidx, lr)
    names = layout.names
    adam(layout, [params[k] for k in names], [opt_state["mu"][k] for k in names],
         [opt_state["nu"][k] for k in names],
         [g if g.is_contiguous() else g.contiguous() for g in grads], ndx, fidx,
         opt_state["count"], lr)
