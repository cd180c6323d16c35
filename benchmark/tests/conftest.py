"""Tests of the benchmark harness on the CPU, at a tiny size.

``cuda``-marked tests need a card: the ``cuda_device`` fixture skips them
here, deciding inside the fixture (never while a module is imported).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.prepare()

TINY = {"Nt": 16, "F": 24, "n_chunk": 2}
TINY_FIT = {"nbatch": 4, "fbatch": 8}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def make_tiny_root(dest):
    """A checkout-like tree at ``dest``: the benchmark folder and a
    BENCHMARK.json whose cells are the real ones cut to a tiny size (the
    same models, traffic and limits), named ``*-tiny*``."""
    dest = Path(dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["geometry"].update(TINY)
        cfg["fit"].update(TINY_FIT)
        c["name"] = c["name"].replace("elife", "tiny")
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        limits = (ROOT / "benchmark" / "cells" / f"{w['name']}.json").read_text()
        w["name"] = w["name"].replace("elife", "tiny")
        w["config"] = w["config"].replace("elife", "tiny")
        (dest / "benchmark" / "cells" / f"{w['name']}.json").write_text(limits)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("elife", "tiny") for w in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, chunk in (("fit", "checkpoint_interval"), ("restarts", "chunk")):
        path = dest / "benchmark" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update({chunk: 8, "warmup_steps": 4, "profile": {"warmup": 1, "steps": 3}})
        path.write_text(json.dumps(traffic))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
