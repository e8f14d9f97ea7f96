"""chip_smoke.py and bench.py: no result without a GPU, the independent
eps-CS certificate, and (on a machine with a card) the device phase."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0, r.stdout
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_eps_cs_certificate_accepts_solution_and_flags_perturbation():
    import chip_smoke
    from bench import make_instance
    from sslap_tpu import AuctionSolver
    n = 300
    rr, cc, vv = make_instance(n, n, 5, seed=3)
    res = AuctionSolver(loc=np.stack([rr, cc], 1), val=vv, shape=(n, n),
                        mode="cpu", cardinality_check=False).solve()
    assert res["meta"]["soln_found"]
    sol, prices = res["sol"], np.asarray(res["prices"])
    eps = res["meta"]["final_eps"]
    assert chip_smoke.eps_cs_violations(rr, cc, vv, sol, prices, eps) == 0
    # Raise the price of row 0's column far above the cost range: row 0
    # (which has other entries) now strictly prefers another column.
    assert (rr == 0).sum() >= 2
    bad = prices.copy()
    bad[sol[0]] += np.float32(10_000.0)
    assert chip_smoke.eps_cs_violations(rr, cc, vv, sol, bad, eps) > 0


@pytest.fixture
def gpu_env():
    """Environment for a child process that may open the card; skips when
    this machine has none.  The test process itself stays on the CPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    for key in ("JAX_PLATFORMS", "XLA_FLAGS"):
        env.pop(key, None)
    return env


@pytest.mark.gpu
def test_device_paths_on_gpu(gpu_env):
    code = ("import chip_smoke as s\n"
            "s.emit(s.device_paths(s.card_info()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=gpu_env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert '"phase": "device_paths"' in r.stdout
