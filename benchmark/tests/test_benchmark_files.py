"""The harness finds its cells, configurations and metrics from their files,
and BENCHMARK.json keeps the form its readers require."""

import json
import re
import shutil

import pytest

from benchmark import compare, core
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"][0] == "python3" and b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(kind):
    b = bench()
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    for e in b[kind]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"fit_steps_per_s", "fit_device_ms_per_step", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25
    # every cell reports set-up and one other end-to-end metric
    for w in b["workloads"]:
        names = {m["name"] for m in core.Cell(ROOT, w["name"]).metrics("end_to_end")}
        assert "setup_s" in names and len(names) == 2


def test_per_layer_metrics_move_the_rate_in_both_cells():
    """Every per-layer metric moves an end-to-end metric that each cell it
    lists reports: the fit's rate where it holds a bound, the device's time
    per step in the other cell; every cell has metrics of every layer."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    layers = {"fit loop", "step", "ELBO", "likelihood kernel", "device"}
    seen = {c: set() for c in cells}
    for m in b["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["layer"] in layers
        for c in m["workloads"]:
            reported = {e["name"] for e in core.Cell(ROOT, c).metrics("end_to_end")}
            assert m["moves"] in reported - {"setup_s"}, (m["name"], c)
            seen[c].add(m["layer"])
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(s == layers for s in seen.values()), seen


def test_every_cell_loads_with_its_files():
    b = bench()
    for w in b["workloads"]:
        assert w["chips"] == 1
        cell = core.Cell(ROOT, w["name"])
        assert (ROOT / "benchmark" / "reference" / f"{cell.cfg['model']}.py").is_file()
        assert set(cell.limits) == set(compare.NUMBERS)
        assert hasattr(cell.entry, "Run") and hasattr(cell.reference, "run_steps")
        for m in cell.metrics("per_layer"):
            assert callable(cell.metric_reader(m["name"]).read)
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/configs/") and c["reduced"] == []


def test_a_new_cell_and_metric_are_found_from_new_files(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric
    as files and entries; the harness finds them with no other edit."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    cfg = json.loads((ROOT / "benchmark/configs/cosmos-elife.json").read_text())
    cfg["geometry"]["K"] = 3
    (tmp_path / "benchmark/configs/cosmos-elife-k3.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "cosmos-elife-k3", "source": "https://doi.org/10.7554/eLife.73860",
                         "file": "benchmark/configs/cosmos-elife-k3.json", "reduced": [],
                         "why": "three spots"})
    (tmp_path / "benchmark/traffic/fit-r4.json").write_text(
        (ROOT / "benchmark/traffic/fit.json").read_text())
    b["workloads"].append({"name": "cosmos-elife-k3-fit", "config": "cosmos-elife-k3",
                           "traffic": "fit-r4", "chips": 1, "why": "a new cell"})
    (tmp_path / "benchmark/cells/cosmos-elife-k3-fit.json").write_text(
        json.dumps({"limits": {k: 1 for k in compare.NUMBERS}, "window": {"steps_per_s": 20}}))
    (tmp_path / "benchmark/metrics/step.syncs.py").write_text(
        "SPANS = {}\n\ndef read(view):\n    return 7.0\n")
    b["per_layer"].append({"name": "step.syncs", "unit": "syncs/step", "better": "lower",
                           "source": "program_counter", "layer": "step",
                           "moves": "fit_steps_per_s", "workloads": ["cosmos-elife-k3-fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.Cell(tmp_path, "cosmos-elife-k3-fit")
    assert cell.cfg["geometry"]["K"] == 3 and cell.traffic["entry"] == "fit"
    assert [m["name"] for m in cell.metrics("per_layer")] == ["step.syncs"]
    assert cell.metric_reader("step.syncs").read(None) == 7.0
    assert cell.reference.likelihood_shape(cell.cfg) == (8, 5120)
