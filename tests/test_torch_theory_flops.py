"""The port's variance theory and FLOPs accounting against the reference.

The closed forms (paper App. A/B, Eqs. 1-3) and ``theory_table`` are the
same float64 Python arithmetic, so they are equal exactly; the port's
Monte-Carlo simulator (a ``torch.Generator``, float32) is held to the
reference test's 8% of the closed form. ``core/flops.py`` is pure Python:
every count equal exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from repro.core import flops as JF  # noqa: E402
from repro.core import theory as JTh  # noqa: E402
from repro_torch.core import flops as TF  # noqa: E402
from repro_torch.core import theory as TTh  # noqa: E402

GRID = [(n, k) for n in (8, 32, 64, 256, 4096) for k in (1, 2, 8, n // 2, n)]


@pytest.mark.parametrize("name", ["var_bernoulli", "c_nk", "var_const_per_layer",
                                  "var_const_fan_in"])
def test_closed_forms_equal_the_reference(name):
    for n, k in GRID:
        assert getattr(TTh, name)(n, k) == getattr(JTh, name)(n, k), (n, k)
    ks = [1, 4, 16, 32]
    np.testing.assert_array_equal(TTh.theory_table(64, ks), JTh.theory_table(64, ks))


@pytest.mark.parametrize("kind,theory_fn", [
    ("bernoulli", TTh.var_bernoulli),
    ("const_per_layer", TTh.var_const_per_layer),
    ("const_fan_in", TTh.var_const_fan_in),
])
def test_simulation_matches_the_closed_form(kind, theory_fn):
    n, k = 64, 8
    th = theory_fn(n, k)
    sim = TTh.simulate_output_norm_var(torch.Generator().manual_seed(0), n, k, kind, 4000)
    assert abs(sim - th) / th < 0.08
    again = TTh.simulate_output_norm_var(torch.Generator().manual_seed(0), n, k, kind, 4000)
    assert sim == again  # reproducible from the generator


def test_index_ensembles_have_their_structure():
    g = torch.Generator().manual_seed(3)
    cpl = TTh._sample_index_matrices(g, 5, 16, 3, "const_per_layer")
    assert cpl.reshape(5, -1).sum(-1).tolist() == [48] * 5
    cfi = TTh._sample_index_matrices(g, 5, 16, 3, "const_fan_in")
    assert bool((cfi.sum(-1) == 3).all())
    with pytest.raises(ValueError):
        TTh.simulate_output_norm_var(g, 8, 2, "nope", 4)


def test_const_fan_in_always_smallest():
    for n in (32, 64, 256):
        for k in (2, 4, 8, n // 2):
            cfi = TTh.var_const_fan_in(n, k)
            assert cfi < TTh.var_bernoulli(n, k) and cfi < TTh.var_const_per_layer(n, k)


def _layers(M):
    return [M.LinearCost("a", 1024, 1024, density=0.1),
            M.LinearCost("b", 1024, 4096, density=0.37, n_replicas=3),
            M.LinearCost("moe", 2048, 768, density=0.05, n_replicas=8, tokens_scale=2 / 8),
            M.LinearCost("dense", 64, 48)]


def test_flops_equal_the_reference_exactly():
    tl, jl = _layers(TF), _layers(JF)
    for t, j in zip(tl, jl):
        assert t.nnz == j.nnz and t.fwd_flops_per_token() == j.fwd_flops_per_token()
    assert TF.inference_flops(tl, 1000) == JF.inference_flops(jl, 1000)
    assert TF.training_flops(tl, 512, 7) == JF.training_flops(jl, 512, 7)
    assert TF.sparse_vs_dense_ratio(tl) == JF.sparse_vs_dense_ratio(jl)
    assert TF.training_flops(tl, 1000, 1) == pytest.approx(3 * TF.inference_flops(tl, 1000))
    assert TF.sparse_vs_dense_ratio([]) == JF.sparse_vs_dense_ratio([]) == 0.0
