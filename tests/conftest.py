"""Test env setup (SURVEY.md §4.2-§4.3).

The platform must be chosen before JAX initialises a backend. Tests run
on the CPU backend with 8 simulated devices (exact collective semantics,
SURVEY.md §4.3) unless TPQ_TEST_PLATFORM names another platform. Tests
marked `gpu` need an NVIDIA GPU: a fixture skips them on anything else
(`python chip_smoke.py` runs them on the card).
"""

import os
import subprocess
import sys
from pathlib import Path

_PLATFORM = os.environ.get("TPQ_TEST_PLATFORM", "cpu")
if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ORACLE_BIN = REPO / "oracle" / "build" / "oracle"


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless the default device is a GPU. Decided
    here, at run time, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        dev = jax.devices()[0]
        if dev.platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU; JAX found {dev.platform} ({dev.device_kind})")


@pytest.fixture(scope="session")
def oracle_bin() -> Path:
    """Builds the C++ oracle (once, cached by mtime)."""
    src = sorted((REPO / "oracle").glob("*.cc")) + sorted((REPO / "oracle").glob("*.h"))
    if ORACLE_BIN.exists() and all(ORACLE_BIN.stat().st_mtime > f.stat().st_mtime for f in src):
        return ORACLE_BIN
    ORACLE_BIN.parent.mkdir(parents=True, exist_ok=True)
    # The oracle is the ground truth: build it paranoid (SURVEY.md §5.2) —
    # ASan+UBSan with no recovery, still -O2 so slow tests stay fast.
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-Wall",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-o", str(ORACLE_BIN), str(REPO / "oracle" / "main.cc")],
        check=True,
    )
    return ORACLE_BIN


@pytest.fixture(scope="session")
def oracle(oracle_bin):
    """Callable: oracle("join", algo="hash", left=..., ...) -> stdout."""

    def run(cmd: str, **kwargs) -> str:
        argv = [str(oracle_bin), cmd] + [f"--{k}={v}" for k, v in kwargs.items()]
        res = subprocess.run(argv, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"oracle failed: {argv}\n{res.stderr}")
        return res.stdout

    return run


def assert_tables_equal(engine_cols: dict, oracle_cols: dict, msg=""):
    """Byte-level equality of canonical forms."""
    assert list(engine_cols.keys()) == list(oracle_cols.keys()), (
        f"{msg}: column mismatch {list(engine_cols)} vs {list(oracle_cols)}"
    )
    for k in engine_cols:
        a, b = np.asarray(engine_cols[k]), np.asarray(oracle_cols[k])
        assert a.shape == b.shape, f"{msg}: col {k} rows {a.shape} vs {b.shape}"
        assert np.array_equal(a, b), f"{msg}: col {k} differs"
