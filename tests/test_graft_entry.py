"""dryrun_multichip must be able to host an n-device virtual CPU mesh even
when the process was launched with another platform configured (so the
xla_force_host_platform_device_count env forcing alone does not apply)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import __graft_entry__ as g
g._ensure_virtual_cpu_devices(8)
import jax
ds = jax.devices()
assert len(ds) >= 8, ds
assert ds[0].platform == "cpu", ds
print("ok", len(ds))
"""


def test_ensure_virtual_cpu_devices_under_noncpu_pin():
    # Fresh interpreter configured for a non-CPU platform.  The child never
    # touches that backend: _ensure_virtual_cpu_devices must flip to an
    # 8-device virtual CPU backend BEFORE the first device query, so this
    # passes on a machine without that accelerator.
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env.pop("XLA_FLAGS", None)  # prove the arming needs no env-var help
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "ok" in r.stdout, (r.stdout, r.stderr)


def test_ensure_virtual_cpu_devices_under_sitecustomize_pin():
    # Plain cpu + XLA_FLAGS launch: the arm no-ops and the env forcing
    # supplies the devices.
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "ok" in r.stdout, (r.stdout, r.stderr)
