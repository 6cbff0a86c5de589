"""Port topology utilities against ``repro.core.topology`` on shared inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402


def _ragged_mask(rng, d_in, d_out, k, lead=()):
    """Mask with at most k True per column: some columns full, some short,
    some fully ablated."""
    mask = np.zeros((*lead, d_in, d_out), bool)
    for idx in np.ndindex(*lead, d_out):
        *l, col = idx
        nnz = int(rng.choice([0, k, k, int(rng.integers(0, k + 1))]))
        rows = rng.choice(d_in, size=nnz, replace=False)
        mask[(*l, rows, col)] = True
    return mask


CASES = [(16, 8, 4), (37, 23, 5), (64, 33, 17), (9, 5, 9)]


@pytest.mark.parametrize("d_in,d_out,k", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_to_condensed_matches_reference(d_in, d_out, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    mask = _ragged_mask(rng, d_in, d_out, k)
    jv, ji = JT.dense_to_condensed(jnp.asarray(w), jnp.asarray(mask), k)
    tv, ti = TT.dense_to_condensed(torch.from_numpy(w), torch.from_numpy(mask), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    # padding slots index inactive rows and carry exact zeros
    gathered = np.take_along_axis(mask.T, ti.numpy().astype(np.int64), axis=1)
    assert np.all(tv.numpy()[~gathered] == 0)


def test_dense_to_condensed_stacked_matches_per_layer_reference():
    rng = np.random.default_rng(3)
    lead, d_in, d_out, k = (3,), 20, 11, 6
    w = rng.standard_normal((*lead, d_in, d_out)).astype(np.float32)
    mask = _ragged_mask(rng, d_in, d_out, k, lead)
    jv, ji = jax.vmap(lambda a, m: JT.dense_to_condensed(a, m, k))(
        jnp.asarray(w), jnp.asarray(mask))
    tv, ti = TT.dense_to_condensed(torch.from_numpy(w), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("d_in,d_out,k", CASES)
def test_condensed_to_dense_round_trips_and_matches_reference(d_in, d_out, k):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    mask = _ragged_mask(rng, d_in, d_out, k)
    tv, ti = TT.dense_to_condensed(torch.from_numpy(w * mask), torch.from_numpy(mask), k)
    dense = TT.condensed_to_dense(tv, ti, d_in)
    np.testing.assert_array_equal(dense.numpy(), w * mask)
    jd = JT.condensed_to_dense(jnp.asarray(tv.numpy()), jnp.asarray(ti.numpy()), d_in)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))


@pytest.mark.parametrize("d_in,d_out,k,lead", [(32, 16, 5, ()), (17, 9, 17, ()),
                                                (40, 12, 1, (2, 3))])
def test_random_constant_fan_in_mask_is_constant_fan_in_and_seeded(d_in, d_out, k, lead):
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return TT.random_constant_fan_in_mask(g, d_in, d_out, k, lead=lead)
    m = draw(0)
    assert m.dtype == torch.bool and m.shape == (*lead, d_in, d_out)
    assert TT.check_constant_fan_in(m, k)
    for layer in m.reshape(-1, d_in, d_out):  # the reference checks one layer
        assert JT.check_constant_fan_in(layer.numpy(), k)
    assert torch.equal(m, draw(0))
    if k < d_in:
        assert not torch.equal(m, draw(1))


def test_random_constant_fan_in_mask_rejects_bad_fan_in():
    g = torch.Generator().manual_seed(0)
    for k in (0, 9):
        with pytest.raises(ValueError):
            TT.random_constant_fan_in_mask(g, 8, 4, k)


def test_check_constant_fan_in_matches_reference():
    rng = np.random.default_rng(5)
    mask = _ragged_mask(rng, 12, 10, 4)
    active = mask.any(axis=0)
    for args in ((4,), (4, active), (3, active), (4, np.ones(10, bool))):
        assert TT.check_constant_fan_in(torch.from_numpy(mask), *args) \
            == JT.check_constant_fan_in(mask, *args)
