"""``examples/quickstart_torch.py --device cpu`` runs end to end: the engine
serves the masked path's tokens, and the refresh after ten more training
steps re-exports exactly the stacks whose mask version moved, in every
plan, and then still serves the masked path's tokens; section 8 times the
structured kernel and picks structured on an ablation-only stack."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_torch_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "serve: engine decode tokens == masked decode tokens: True" in out
    assert "serve: refreshed engine tokens == masked decode tokens: True" in out
    moved = re.search(r"mask versions moved for (\d+)/(\d+) stacks", out)
    assert moved is not None
    refreshes = re.findall(r"serve: refresh\[[^\]]+\] re-exported (\d+)/(\d+) stacks", out)
    assert len(refreshes) == 2                 # two plan-key groups
    assert all(r == moved.groups() for r in refreshes)
    # section 8: the cost model picks structured on an ablation-only stack
    assert "auto @ b=1 (ablation-only stack) -> structured" in out
