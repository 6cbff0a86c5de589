"""``examples/quickstart_torch.py --device cpu`` runs end to end: the engine
serves the masked path's tokens, and the refresh after ten more training
steps re-exports exactly the stacks whose mask version moved, in every
plan, and then still serves the masked path's tokens; section 7 measures
a profile into its own cache and prints the decisions beside the
default's, then runs the launch search and keeps its winners in the same
cache; section 8 times the structured kernel and picks structured on an
ablation-only stack; section 13's speculative streams equal plain greedy
for every (gamma, draft ablation), with acceptance 1.00 at ablation 0.0,
and the CLI prints its ``[serve:spec]`` line."""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_torch_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
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
    # section 7: a measured profile, cached in the given file, and the
    # decisions at each bucket under both profiles
    assert "calibrated measured-cpu:" in out and str(tmp_path / "autotune.json") in out
    assert (tmp_path / "autotune.json").exists()
    assert len(re.findall(r"decisions @ bucket \d+: h100-sxm: .* \| measured-cpu: ", out)) == 5
    # section 7's launch search: a winner per launch shape, each its table's
    # fastest, kept under the cache's kernels section beside the profile
    tuned = re.findall(r"autotuned (\S+) @ b=2: best (.+?) \((\d+) us vs default (\d+) us, "
                       r"(\d+) launches timed\)", out)
    assert tuned and {t[0] for t in tuned} >= {"blocks/wo", "blocks/w_gate", "blocks/w_down"}
    assert all(int(us) <= int(dflt) and int(n) > 1 for _, _, us, dflt, n in tuned)
    cache = json.loads((tmp_path / "autotune.json").read_text())
    assert len(cache["kernels"]) == len(tuned) and cache["profiles"]
    assert all(key.startswith("cpu/") and "/b8" in key for key in cache["kernels"])
    # section 13: speculation keeps plain greedy's tokens
    spec = re.findall(r"spec g=(\d) abl=([\d.]+): acceptance ([\d.]+), .* "
                      r"bitwise == plain: (\w+)", out)
    assert [(g, a) for g, a, _, _ in spec] == [("3", "0.0"), ("3", "0.5"), ("2", "0.5")]
    assert all(same == "True" for *_, same in spec)
    assert spec[0][2] == "1.00"
    assert "spec-cli| [serve:spec] gamma=3" in out
