"""The examples/ scripts must stay runnable — they are the user on-ramp.

Each runs as a real subprocess (fresh interpreter, CPU platform, quick-mode
workloads via SPH_EXAMPLE_QUICK) so import paths, env handling, and the
public API surface they demonstrate are exercised exactly as a user would.
"""

import os
import subprocess
import sys

import pytest

# End-to-end / compiled-kernel tests: minutes each on the virtual CPU
# mesh.  Excluded from the default lane (pyproject addopts -m "not slow");
# run the full lane with:  pytest -q -m ""  (see README Testing).
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _run(name: str, tmp_path) -> str:
    env = dict(os.environ)
    env["SPH_EXAMPLE_QUICK"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    # the example scripts pin jax to CPU themselves where they must
    # (distributed.py); quickstart/custom_scene inherit the env default
    proc = subprocess.run(
        [sys.executable, "-c",
         # mirror tests/conftest.py: re-pin the platform via jax.config
         # before the script runs
         "import os, jax, runpy; jax.config.update('jax_platforms', 'cpu'); "
         f"runpy.run_path({os.path.join(EXAMPLES, name)!r}, "
         "run_name='__main__')"],
        capture_output=True, text=True, timeout=900, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("name", ["quickstart.py", "custom_scene.py",
                                  "distributed.py"])
def test_example_runs(name, tmp_path):
    out = _run(name, tmp_path)
    if name == "quickstart.py":
        assert "total-energy drift" in out
        assert (tmp_path / "quickstart_final.png").exists()
    elif name == "custom_scene.py":
        assert "final KE" in out
    else:
        assert "all particles accounted for" in out
        assert "migration_dropped=0" in out
