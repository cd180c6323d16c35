"""The port's tracing (``tapqir_tpu_torch/tracing.py``) on the fit: off, it
records nothing and leaves the fit bitwise as it is; on, a fit records every
span of the fit loop, the step and the ELBO with its calls per step and per
chunk, nested in its parents; spans under a recording ``torch.profiler``
are ranges of its trace and are kept out of ``summary()``; the sync counter
counts the synchronizing-operation warnings against the innermost span.
The ``cuda``-marked test counts the syncs of a fit on the card:

    python -m pytest --noconftest tests/test_torch_tracing.py
"""

import json
import warnings

import pytest
import torch

from tapqir_tpu_torch import tracing
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate

torch.set_num_threads(1)
PARAMS = {"pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
          "offset": 90.0, "height": 3000, "background": 150}
XTALK = dict(PARAMS, pi=0.3, alpha=[[0.85, 0.15], [0.1, 0.9]])
CHUNK, STEPS = 3, 6  # two checkpoint chunks
# span -> (calls per step or per chunk, the parent it opens in)
PER_STEP = {"step.batch": (1, "fit.chunk"), "step.gather": (1, "fit.chunk"),
            "step.update": (1, "fit.chunk"),
            "elbo.forward": (1, "fit.chunk"), "elbo.backward": (1, "fit.chunk"),
            "elbo.sites": (1, "elbo.forward"), "elbo.tables": (1, "elbo.forward"),
            "elbo.likelihood": (1, "elbo.forward")}
PER_CHUNK = {"fit.chunk": (1, None), "fit.device_wait": (1, None),
             "fit.checkpoint": (1, None), "checkpoint.check": (1, "fit.checkpoint"),
             "checkpoint.write": (1, "fit.checkpoint"), "checkpoint.log": (1, "fit.checkpoint")}
# the spans that the benchmark sets on the program from outside
HARNESS_NAMES = {"step", "elbo_fwd", "elbo_bwd", "likelihood_fwd", "likelihood_bwd",
                 "checkpoint"}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _model(tmp_path, name="cosmos", device="cpu"):
    if name == "crosstalk":
        data = simulate("crosstalk", N=4, F=8, C=2, P=14, seed=0, params=XTALK, device=device)
    else:
        data = simulate("cosmos", N=4, F=8, C=1, P=14, seed=0, params=PARAMS, device=device)
    tmp_path.mkdir(exist_ok=True)
    save(data, tmp_path)
    model = models[name](device=device)
    model.load(tmp_path)
    model.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    model.checkpoint_interval = CHUNK
    model._seed = 11
    return model


def _span_ranges(trace_path):
    """name -> sorted (start, end) of the ``span::`` ranges of a Chrome trace."""
    ranges = {}
    for e in json.loads(trace_path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("span::"):
            ts = float(e["ts"])
            ranges.setdefault(e["name"][6:], []).append((ts, ts + float(e.get("dur", 0.0))))
    return {k: sorted(v) for k, v in ranges.items()}


def test_off_records_nothing_and_leaves_the_fit_bitwise_as_on(tmp_path):
    """Tracing off: no ``span::`` range in a profiler trace of the fit and
    nothing in ``summary()``; the parameters after ``Model.run`` are
    bitwise those of the same fit with tracing on."""
    off = _model(tmp_path / "off")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        off.run(STEPS)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert _span_ranges(tmp_path / "trace.json") == {}
    assert tracing.summary() == {} and tracing.summary(profiled=True) == {}

    on = _model(tmp_path / "on")
    tracing.enable()
    on.run(STEPS)
    tracing.disable()
    assert tracing.summary()["step.batch"]["calls"] == STEPS
    for k, v in off.params.items():
        assert torch.equal(v, on.params[k]), k
    for k, v in off.opt_state["mu"].items():
        assert torch.equal(v, on.opt_state["mu"][k]), k


@pytest.mark.parametrize("name", ["cosmos", "crosstalk"])
def test_on_records_every_span_of_the_fit(tmp_path, name):
    """A two-chunk ``Model.run`` with tracing on records each span of the
    fit loop, the step and the ELBO with its calls per step and per chunk,
    in its parent; self time is at most the total, and a parent's total
    less its self time is the total of its children."""
    model = _model(tmp_path, name)
    tracing.enable()
    model.run(STEPS)
    tracing.disable()
    spans = tracing.summary()
    assert not set(spans) & HARNESS_NAMES
    expected = {k: (n * STEPS, p) for k, (n, p) in PER_STEP.items()}
    expected.update({k: (n * STEPS // CHUNK, p) for k, (n, p) in PER_CHUNK.items()})
    assert set(spans) == set(expected)
    children = {}
    for k, (calls, parent) in expected.items():
        agg = spans[k]
        assert agg["calls"] == calls, k
        assert agg["parents"] == ({parent: calls} if parent else {}), k
        assert 0 < agg["self_ns"] <= agg["total_ns"], k
        assert agg["syncs"] == 0, k  # no count on the CPU
        if parent:
            children[parent] = children.get(parent, 0) + agg["total_ns"]
    for k, agg in spans.items():
        assert agg["total_ns"] - agg["self_ns"] == children.get(k, 0), k


# cosmos+hmm's ELBO spans -> the parent each opens in: the likelihood sits
# between the per-frame tables' statements (moving it would reorder the
# backward pass's sums), so its span opens inside ``elbo.tables``
HMM_ELBO = {"elbo.sites": "elbo.forward", "elbo.chain": "elbo.forward",
            "elbo.tables": "elbo.forward", "elbo.likelihood": "elbo.tables"}


def test_hmm_step_records_the_chain_spans(tmp_path):
    """One cosmos+hmm ``_sparse_step`` with tracing on records each ELBO
    span once a step, inside ``elbo.forward``, with no sync; the chain's
    span holds its own time (its scan and terms)."""
    model = _model(tmp_path, "cosmos+hmm")
    tracing.enable()
    model._sparse_step(torch.Generator().manual_seed(3))
    tracing.disable()
    spans = tracing.summary()
    assert set(HMM_ELBO) | {"elbo.forward"} <= set(spans)
    for k, parent in HMM_ELBO.items():
        agg = spans[k]
        assert agg["calls"] == 1 and agg["parents"] == {parent: 1}, k
        assert 0 < agg["self_ns"] <= agg["total_ns"] and agg["syncs"] == 0, k
    assert spans["elbo.forward"]["parents"] == {}
    assert spans["elbo.tables"]["total_ns"] - spans["elbo.tables"]["self_ns"] == \
        spans["elbo.likelihood"]["total_ns"]


def test_hmm_step_is_bitwise_the_same_with_tracing_off_and_on(tmp_path):
    """Two cosmos+hmm steps from the same state and seed, tracing off and
    on: the losses, parameters and moments are bitwise equal."""
    out = []
    for on in (False, True):
        model = _model(tmp_path / str(on), "cosmos+hmm")
        if on:
            tracing.enable()
        gen = torch.Generator().manual_seed(5)
        losses = [model._sparse_step(gen) for _ in range(2)]
        tracing.disable()
        out.append((losses, model.params, model.opt_state["mu"]))
    (l0, p0, m0), (l1, p1, m1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(m0[k], m1[k]), k


def test_spans_under_the_profiler_are_kept_out_of_the_summary(tmp_path):
    """A chunk run under a recording ``torch.profiler``: its spans are
    ``span::`` ranges of the trace, nested as they opened, and go to
    ``summary(profiled=True)``, as does a span open around the profiler;
    ``summary()`` holds only what ran outside it."""
    model = _model(tmp_path)
    tracing.enable()
    model._run_chunk(1)
    assert tracing.summary()["fit.chunk"]["calls"] == 1
    acts = [torch.profiler.ProfilerActivity.CPU]
    with tracing.span("fit.outer"):
        with torch.profiler.profile(activities=acts) as prof:
            model._run_chunk(CHUNK)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    tracing.disable()
    kept, profiled = tracing.summary(), tracing.summary(profiled=True)
    assert kept["fit.chunk"]["calls"] == 1 and kept["step.batch"]["calls"] == 1
    assert "fit.outer" not in kept and profiled["fit.outer"]["calls"] == 1
    assert profiled["step.update"]["calls"] == CHUNK
    assert profiled["fit.chunk"]["parents"] == {"fit.outer": 1}
    ranges = _span_ranges(tmp_path / "trace.json")
    assert len(ranges["step.update"]) == len(ranges["elbo.sites"]) == CHUNK
    (c0, c1), = ranges["fit.chunk"]
    assert all(c0 <= s <= t <= c1 for s, t in ranges["step.update"])
    for s, t in ranges["elbo.sites"]:
        assert any(f0 <= s <= t <= f1 for f0, f1 in ranges["elbo.forward"])


def test_syncs_count_against_the_innermost_span_and_are_not_shown(monkeypatch, recwarn):
    """On a CUDA machine ``enable`` sets the sync debug mode to "warn" and
    counts each synchronizing-operation warning against the innermost open
    span without showing it; other warnings pass; ``disable`` puts the mode
    and the warnings' handling back. (The card is stood in for here.)"""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    show, filters = warnings.showwarning, list(warnings.filters)
    tracing.enable()
    assert modes == [0, "warn"]
    sync = "called a synchronizing CUDA operation"
    with tracing.span("fit.outer"):
        warnings.warn(sync)
        with tracing.span("fit.inner"):
            for _ in range(3):
                warnings.warn(sync)
        warnings.warn("another warning")
    warnings.warn(sync)  # no span open: counted nowhere
    tracing.disable()
    assert modes == [0, "warn", 0]
    assert warnings.showwarning is show and warnings.filters == filters
    spans = tracing.summary()
    assert spans["fit.inner"]["syncs"] == 3 and spans["fit.outer"]["syncs"] == 1
    assert [str(w.message) for w in recwarn] == ["another warning"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cosmos", "cosmos+hmm"])
def test_the_step_makes_no_sync_and_the_chunk_waits_once(tmp_path, name):
    """On the card: a two-chunk fit's step and ELBO spans count no sync,
    and each chunk's ``fit.device_wait`` counts its one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync counter counts CUDA syncs")
    model = _model(tmp_path, name, device="cuda")
    model._run_chunk(1)  # the kernel's build and first launches
    torch.cuda.synchronize()
    tracing.enable()
    model.run(STEPS)
    tracing.disable()
    spans = tracing.summary()
    assert spans["step.batch"]["calls"] == STEPS
    step_syncs = {k: a["syncs"] for k, a in spans.items() if k.startswith(("step.", "elbo."))}
    assert sum(step_syncs.values()) == 0, step_syncs
    wait = spans["fit.device_wait"]
    assert wait["calls"] == STEPS // CHUNK and wait["syncs"] == wait["calls"]
