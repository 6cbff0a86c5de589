"""The condensed gather kernel's plain version (the CPU path of K1) against
the reference's Pallas ``condensed_matmul`` in interpret mode.

Tolerances: float32 rtol=atol=1e-5, because the k-sum runs in another
order; bfloat16 outputs are compared in float32 with rtol=8e-3, one bf16
ulp, since the two f32 sums may round to neighbouring bf16 values.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import condensed_matmul as JCM  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.sparse import condensed as JC  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.kernels import condensed_matmul as TCM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-6)}
D_IN, N_OUT, K = 70, 37, 11   # nothing aligned to a tile


def _inputs(b, seed=0, d_in=D_IN, n_out=N_OUT, k=K):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d_in)).astype(np.float32)
    values = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    idx = np.stack([rng.choice(d_in, size=k, replace=False)
                    for _ in range(n_out)]).astype(np.int32)
    values[: n_out // 4, k // 2:] = 0.0  # padding slots, as an export leaves them
    return x, values, idx


def _jax(x, values, idx, dtype):
    jdt = getattr(jnp, dtype)
    return np.asarray(JCM.condensed_matmul(jnp.asarray(x).astype(jdt),
                                           jnp.asarray(values).astype(jdt),
                                           jnp.asarray(idx)).astype(jnp.float32))


def _torch(fn, x, values, idx, dtype, **kw):
    tdt = getattr(torch, dtype)
    y = fn(torch.from_numpy(x).to(tdt), torch.from_numpy(values).to(tdt),
           torch.from_numpy(idx), **kw)
    assert y.dtype == tdt
    return y.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 5, 8, 9, 33])
def test_plain_version_matches_reference_kernel(b, dtype):
    """B <= 8 takes the reference's decode launch, B > 8 its tiled launch."""
    x, values, idx = _inputs(b, seed=b)
    want = _jax(x, values, idx, dtype)
    got = _torch(TCM.condensed_matmul, x, values, idx, dtype)
    assert got.shape == (b, N_OUT)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_array_equal(
        _torch(TREF.condensed_matmul_ref, x, values, idx, dtype), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_launch_forms_agree_on_the_cpu(dtype):
    x, values, idx = _inputs(6, seed=11)
    decode = _torch(TCM.condensed_matmul_decode, x, values, idx, dtype)
    tiled = _torch(TCM.condensed_matmul, x, values, idx, dtype, block_b=2)
    np.testing.assert_array_equal(decode, tiled)


def test_plain_version_accumulates_in_float32():
    """bf16 products summed in f32 and cast once: a sum whose bf16 partial
    sums would lose the small terms keeps them."""
    x = torch.ones((1, 4), dtype=torch.bfloat16)
    values = torch.tensor([[256.0, 1.0, 1.0, -256.0]], dtype=torch.bfloat16)
    idx = torch.arange(4, dtype=torch.int32)[None]
    assert TCM.condensed_matmul(x, values, idx).item() == 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condensed_export_apply_chain_matches_reference(dtype):
    rng = np.random.default_rng(4)
    d_in, d_out, k = 48, 29, 7
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    mask = np.zeros((d_in, d_out), bool)
    for c in range(d_out):
        mask[rng.choice(d_in, size=k if c % 5 else k // 2, replace=False), c] = True
    mask[:, 3] = False  # an ablated neuron
    x = rng.standard_normal((2, 3, d_in)).astype(np.float32)

    jfmt = JF.Condensed.export_from_dense(jnp.asarray(w), jnp.asarray(mask))
    want = np.asarray(jfmt.apply(jnp.asarray(x).astype(getattr(jnp, dtype)))
                      .astype(jnp.float32))
    tfmt = TF.Condensed.export_from_dense(torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_array_equal(tfmt.indices.numpy(), np.asarray(jfmt.indices))
    np.testing.assert_allclose(tfmt.values.numpy(), np.asarray(jfmt.values), rtol=1e-6)
    assert tfmt.d_in == jfmt.d_in == d_in
    got = tfmt.apply(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (2, 3, d_out)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert np.all(got.float().numpy()[..., 3] == 0)


def test_condensed_linear_nd_matches_reference():
    x, values, idx = _inputs(12, seed=9)
    x3 = x.reshape(3, 4, D_IN)
    want = np.asarray(JOPS.condensed_linear_nd(jnp.asarray(x3), jnp.asarray(values),
                                               jnp.asarray(idx)))
    got = TOPS.condensed_linear_nd(torch.from_numpy(x3), torch.from_numpy(values),
                                   torch.from_numpy(idx))
    assert got.shape == (3, 4, N_OUT)
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_export_stats_match_reference():
    rng = np.random.default_rng(2)

    class Stack:  # the two registries' stacks share path/name
        def __init__(self, path):
            self.path, self.name = path, "/".join(path)
    stacks = [Stack(("blocks", "a")), Stack(("blocks", "b"))]
    masks = {"blocks": {}}
    for s, k in zip(stacks, (3, 6)):
        m = np.zeros((2, 10, 8), bool)
        for l, c in np.ndindex(2, 8):
            m[l, rng.choice(10, size=int(rng.integers(0, k + 1)), replace=False), c] = True
        masks["blocks"][s.path[-1]] = m
    want = JC.export_stats(stacks, {"blocks": {n: jnp.asarray(m)
                                               for n, m in masks["blocks"].items()}})
    got = TC.export_stats(stacks, {"blocks": {n: torch.from_numpy(m)
                                              for n, m in masks["blocks"].items()}})
    assert set(got) == set(want)
    for name in want:
        assert got[name].k == want[name].k
        assert got[name].max_active == want[name].max_active
        assert got[name].min_fan_in == want[name].min_fan_in
        assert got[name].active_fraction == pytest.approx(want[name].active_fraction)
        m = masks["blocks"][name.split("/")[-1]]
        assert TF.realized_stats(torch.from_numpy(m)) == got[name]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, values, idx = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(TypeError, match="int32"):
        TCM.condensed_matmul(x, values, idx.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TCM.condensed_matmul(x, values.to(torch.bfloat16), idx)
    with pytest.raises(ValueError, match="contiguous"):
        TCM.condensed_matmul(x.T.contiguous().T, values, idx)
    with pytest.raises(ValueError, match="n_out, k"):
        TCM.condensed_matmul(x, values, idx[:, :-1])
    with pytest.raises(ValueError, match="block_b"):
        TCM.condensed_matmul(x, values, idx, block_b=3)


def test_round_trip_through_dense_matches_masked_matmul():
    """The export's values/indices at the kernel's numerics equal x @ (w*m)."""
    rng = np.random.default_rng(8)
    d_in, d_out, k = 40, 24, 5
    g = torch.Generator().manual_seed(0)
    mask = TT.random_constant_fan_in_mask(g, d_in, d_out, k)
    w = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(np.float32))
    fmt = TF.Condensed.export_from_dense(w, mask)
    x = torch.from_numpy(rng.standard_normal((5, d_in)).astype(np.float32))
    torch.testing.assert_close(fmt.apply(x), x @ (w * mask), rtol=1e-5, atol=1e-5)
