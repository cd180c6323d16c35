"""Test configuration: run on an 8-device virtual CPU mesh.

Multi-chip sharding tests emulate devices per SURVEY.md section 4
("multi-chip tests which on TPU can run under jax with 8 emulated devices").
Must set flags before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the ambient env selects the TPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# some pytest entry-point plugin may have imported jax already (before this
# conftest); the backend is still uninitialized at collection time, so the
# config can be updated directly.
import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NOTE: x64 is NOT enabled globally - with jax_enable_x64 on, weak-type
# promotion pulls float32 model graphs into float64 on CPU, which is several
# times slower per SVI step. Tests that need double precision create models
# with dtype="double" (Model.__init__ flips the flag) or enable it locally;
# the autouse fixture below restores the flag after every test so it cannot
# leak into float32 fits.
#
# Long fits do NOT belong in this process: one CPU core runs the recovery
# configs at ~4-7 it/s (the 8-virtual-device backend costs a further ~1.8x).
# tests/test_recovery.py therefore shells out to recovery_driver.py, which
# uses the ambient default platform (the real TPU when attached).
# persistent compilation cache: XLA compiles dominate this suite's runtime
# (30-60 s/model on CPU); warm re-runs skip them entirely
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("TAPQIR_TEST_CACHE", "/tmp/tapqir-jax-cache"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (long SVI fits, parameter recovery)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running fit (excluded unless --runslow)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one"
    )


@pytest.fixture(autouse=True)
def _restore_x64():
    old = jax.config.jax_enable_x64
    yield
    if jax.config.jax_enable_x64 != old:
        jax.config.update("jax_enable_x64", old)


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def trajectory_golden_check():
    """Loader for tests/golden/trajectory.py (tests/ is not a package)."""
    import importlib.util
    from pathlib import Path

    p = Path(__file__).parent / "golden" / "trajectory.py"
    spec = importlib.util.spec_from_file_location("_trajectory_golden", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.assert_matches_golden
