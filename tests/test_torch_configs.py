"""The port's configs, distributions and registry equal the reference's."""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import distributions as JD  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import distributions as TD  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_fields_equal_the_reference(getter):
    jc = getattr(jconfigs, getter)(ARCH)
    tc = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("vocab_padded", "n_heads_padded", "n_kv_heads_padded",
                 "head_to_kv", "q_dim", "kv_dim", "is_moe"):
        assert getattr(tc, prop) == getattr(jc, prop), prop


def test_ported_archs_are_reference_archs():
    assert set(tconfigs.ALL_ARCHS) <= set(jconfigs.ALL_ARCHS)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_registry_stacks_densities_and_fan_ins_equal(getter):
    jc = getattr(jconfigs, getter)(ARCH)
    tc = getattr(tconfigs, getter)(ARCH)
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in treg] == [(s.path, s.d_in, s.d_out, s.lead, s.density,
                                s.n_replicas, s.name) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_full_width_fan_ins():
    cfg = tconfigs.get_config(ARCH)
    assert TR.k_fan_map(cfg, TR.build_registry(cfg)) == {
        "wo": 293, "w_gate": 195, "w_up": 195, "w_down": 585}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_erk_and_uniform_densities_equal_on_random_layer_sets(seed, sparsity):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 8))
    dims = rng.integers(1, 4096, size=(n, 3))
    tl = [TD.LayerShape(f"l{i}", int(a), int(b), int(r % 4) + 1)
          for i, (a, b, r) in enumerate(dims)]
    jl = [JD.LayerShape(f"l{i}", int(a), int(b), int(r % 4) + 1)
          for i, (a, b, r) in enumerate(dims)]
    td, jd = TD.erk_densities(tl, sparsity), JD.erk_densities(jl, sparsity)
    assert td == jd
    assert TD.uniform_densities(tl, sparsity) == JD.uniform_densities(jl, sparsity)
    for l in tl:
        assert (TD.fan_in_from_density(l.d_in, td[l.name])
                == JD.fan_in_from_density(l.d_in, jd[l.name]))


def test_invalid_sparsity_raises_as_in_the_reference():
    with pytest.raises(ValueError):
        TD.erk_densities([TD.LayerShape("a", 4, 4)], 1.0)
    with pytest.raises(ValueError):
        JD.erk_densities([JD.LayerShape("a", 4, 4)], 1.0)


def test_unported_families_raise():
    cfg = tconfigs.get_smoke_config(ARCH).replace(family="moe")
    with pytest.raises(NotImplementedError):
        TR.build_registry(cfg)
