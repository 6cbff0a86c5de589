"""The serve CLI's ``--speculative``, ``--gamma``, ``--draft-ablation`` and
``--profile measured`` on the CPU at smoke size.

``--speculative`` prints the stream the same run prints without it, and a
``[serve:spec]`` line. ``--profile measured --path auto`` measures into a
temporary ``$REPRO_TORCH_AUTOTUNE_CACHE``, a second run reads the cache and
prints the same rates, and a changed measurement setting in the cache
makes the next run measure again. No rate range is asserted: CPU timings
are noisy.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch", "2", "--gen", "12"]


def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *BASE, *extra],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _line(out, prefix):
    [line] = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    return line


def test_speculative_cli_prints_the_plain_stream():
    spec = _cli("--path", "condensed", "--speculative", "--gamma", "3",
                "--draft-ablation", "0.5")
    plain = _cli("--path", "condensed")
    assert _line(spec, "[serve] first stream:") == _line(plain, "[serve] first stream:")
    line = _line(spec, "[serve:spec]")
    assert "gamma=3 draft_ablation=0.5" in line and "full-network dispatches/token" in line
    assert "[serve:spec]" not in plain


def _in_process(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tokens = TS.main(argv)
    return buf.getvalue(), tokens


def test_profile_measured_round_trips_through_the_cache(tmp_path, monkeypatch):
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache))
    AT.reset_cache_state()
    argv = BASE + ["--path", "auto", "--speculative", "--profile", "measured"]
    try:
        first, tokens = _in_process(argv)
        calibrated = _line(first, "[serve] calibrated profile measured-cpu:")
        assert "[plan] path=auto" in first and "profile=measured-cpu" in first
        assert _line(first, "[serve:spec]")
        entry = json.loads(cache.read_text())["profiles"]["cpu"]
        assert entry["params"]["reps"] == 5

        # a fresh process view of the same file: the stored rates, not a
        # new measurement (which would not repeat them to the last digit)
        AT.reset_cache_state()
        second, again = _in_process(argv)
        assert _line(second, "[serve] calibrated profile") == calibrated
        assert torch.equal(again, tokens)

        # a changed measurement setting in the cache: measured again. The
        # stored entry says so (its settings are back to reps 5 and its rate
        # is no longer the planted 1.0 FLOP/s); the printed line does not,
        # because a loaded CPU may measure under 0.05 GFLOP/s, which prints
        # as the planted rate does ("gather 0.0->")
        entry["params"]["reps"] = 4
        entry["gather_flops_per_s"] = 1.0
        cache.write_text(json.dumps({"version": 1, "profiles": {"cpu": entry}}))
        AT.reset_cache_state()
        third, _ = _in_process(argv)
        assert _line(third, "[serve] calibrated profile measured-cpu:")
        stored = json.loads(cache.read_text())["profiles"]["cpu"]
        assert stored["params"]["reps"] == 5 and stored["gather_flops_per_s"] != 1.0
    finally:
        AT.reset_cache_state()
