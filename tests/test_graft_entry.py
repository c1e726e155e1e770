"""The driver-checked entry points must stay green.

Round 1's MULTICHIP artifact went red because ``dryrun_multichip`` assumed
devices the backend never provisioned; this test runs BOTH driver entry
points exactly the way the driver does — fresh subprocesses with no
test-harness env — so a regression shows up in CI, not in the round
artifact.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    """A fresh-process env without the conftest's CPU forcing (the entry
    points must provision their own devices, like the driver's runner)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    # keep tests hermetic/off-chip: subprocesses still run on CPU, but via
    # their own env (dryrun forces cpu itself; entry() is platform-neutral)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_clean_env(),
        capture_output=True,
        text=True,
        timeout=1200,
    )


def test_dryrun_multichip_8():
    """The exact driver invocation: an 8-device mesh, full sharded step."""
    p = _run("import __graft_entry__ as g; g.dryrun_multichip(8)")
    assert p.returncode == 0, p.stderr[-4000:]


def test_entry_compiles_and_runs():
    """entry() must return (fn, args) with fn jittable on those args."""
    p = _run(
        "import jax, __graft_entry__ as g;"
        "fn, args = g.entry();"
        "out = jax.jit(fn)(*args);"
        "jax.block_until_ready(out)"
    )
    assert p.returncode == 0, p.stderr[-4000:]
