"""``HardwareProfile.measure`` and the port's profile cache
(``sparse/autotune.py``), on the CPU at small shapes.

The measured rates are positive and finite (no range is asserted: CPU
timings are noisy), the cache round-trips through the port's own file
(``$REPRO_TORCH_AUTOTUNE_CACHE``) keyed by the device, a changed setting
measures again, the reference's cache file is never touched, and
``DEFAULT_PROFILE`` and the plan's decisions under it are what they were.
A measured profile prices plans and speculation as the reference's cost
model does with the same numbers.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

from repro.sparse import plan as JP  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402

SMALL = dict(device="cpu", stream_mb=1.0, matmul_shape=(8, 64, 32),
             gather_shape=(2, 64, 32, 8), gather_large_shape=(16, 64, 32, 8), reps=2)


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "reference.json"))
    AT.reset_cache_state()
    yield path
    AT.reset_cache_state()


def test_measure_on_the_cpu_round_trips_through_the_port_cache(cache, monkeypatch):
    prof = TP.HardwareProfile.measure(**SMALL)
    assert prof.name == "measured-cpu"
    for f in ("hbm_bytes_per_s", "mxu_flops_per_s", "gather_flops_per_s",
              "gather_flops_per_s_large"):
        v = getattr(prof, f)
        assert math.isfinite(v) and v > 0, f
    assert (prof.gather_small_batch, prof.gather_large_batch) == (2, 16)
    on_disk = json.loads(cache.read_text())
    assert on_disk["profiles"]["cpu"]["params"]["gather_shape"] == [2, 64, 32, 8]
    assert not (cache.parent / "reference.json").exists()

    # a second measure with the same settings reads the cache, even with a
    # fresh in-memory view, and times nothing
    AT.reset_cache_state()
    calls = []
    monkeypatch.setattr(AT, "_time_us", lambda *a, **k: calls.append(1) or 1.0)
    assert TP.HardwareProfile.measure(**SMALL) == prof
    assert not calls

    # a changed setting measures again and replaces the entry
    again = TP.HardwareProfile.measure(**dict(SMALL, reps=3))
    assert calls and again != prof
    assert json.loads(cache.read_text())["profiles"]["cpu"]["params"]["reps"] == 3
    # use_cache=False measures, save=False keeps the entry as it was
    n = len(calls)
    TP.HardwareProfile.measure(**dict(SMALL, reps=3), use_cache=False, save=False)
    assert len(calls) > n
    assert json.loads(cache.read_text())["profiles"]["cpu"]["gather_flops_per_s"] == \
        again.gather_flops_per_s


def test_cache_ignores_other_versions_and_unreadable_files(cache):
    cache.write_text(json.dumps({"version": 999, "profiles": {"cpu": {"name": "x"}}}))
    assert AT.cached_profile("cpu") is None
    AT.reset_cache_state()
    cache.write_text("not json")
    assert AT.cached_profile("cpu") is None
    AT.store_profile({"name": "y"}, device="cpu")
    AT.reset_cache_state()
    assert AT.cached_profile("cpu") == {"name": "y"}
    assert AT.device_key("cpu") == "cpu"


def test_time_us_on_the_cpu_aggregates_wall_clock():
    calls = []
    us = AT._time_us(lambda x: calls.append(x), 3, reps=4)
    assert len(calls) == 5 and us >= 0.0


def test_default_profile_and_its_decisions_are_unchanged():
    d = TP.DEFAULT_PROFILE
    assert (d.name, d.hbm_bytes_per_s, d.mxu_flops_per_s, d.gather_flops_per_s,
            d.gather_flops_per_s_large) == ("h100-sxm", 3.35e12, 989e12, 9.31e11, None)
    assert d.gather_rate(512) == d.gather_rate(1) == 9.31e11


def test_measured_profile_prices_as_the_reference_does(cache):
    """A two-point profile: ``gather_rate`` and every stack decision at
    each bucket equal the reference cost model's with the same numbers."""
    m = smoke_model()
    prof = TP.HardwareProfile(name="two-point", hbm_bytes_per_s=3.0e12, mxu_flops_per_s=5e14,
                              gather_flops_per_s=8e11, gather_flops_per_s_large=4.7e12)
    jprof = JP.HardwareProfile(**{f.name: getattr(prof, f.name)
                                  for f in dataclasses.fields(TP.HardwareProfile)})
    from repro.sparse import condensed as JC
    from repro_torch import bridge
    from repro_torch.sparse import condensed as TC
    import numpy as np
    tmasks = bridge.from_jax_numpy({"blocks": {k: np.array(v)
                                               for k, v in m["jmasks"]["blocks"].items()}})
    jstats = JC.export_stats(m["jreg"], m["jmasks"])
    tstats = TC.export_stats(m["treg"], tmasks)
    for b in (1, 8, 32, 128, 512):
        assert prof.gather_rate(b) == pytest.approx(jprof.gather_rate(b), rel=1e-12)
        for js, ts in zip(m["jreg"], m["treg"]):
            jd = JP.select_representation(js, batch_size=b, itemsize=4, stats=jstats[js.name],
                                          profile=jprof)
            td = TP.select_representation(ts, batch_size=b, itemsize=4, stats=tstats[ts.name],
                                          profile=prof)
            assert td.representation == jd.representation
            for rep, v in jd.est_s.items():
                assert td.est_s[rep] == pytest.approx(v, rel=1e-9)
