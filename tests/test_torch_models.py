"""Port layers and attention against ``repro.models`` on shared numpy inputs.

float32 tolerances are set by summation order (rtol=atol=1e-5 or 1e-6);
bfloat16 results are compared in float32 within two bf16 ulps (rtol=1.6e-2),
since the two frameworks round at different places.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

HEAD_TO_KV = (0, 0, 1, 1)  # 4 q heads over 2 kv heads


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _pair(arr, dtype):
    return jnp.asarray(arr).astype(getattr(jnp, dtype)), torch.from_numpy(arr).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = JL.rms_norm(jx, jnp.asarray(scale), 1e-6)
    got = TL.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == tx.dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1.6e-2, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)), rtol=1e-6)


def test_swiglu_and_init_scales():
    rng = np.random.default_rng(2)
    g, u = rng.standard_normal((2, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(
        TL.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
        np.asarray(JL.swiglu(jnp.asarray(g), jnp.asarray(u))), rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    w = TL.sparse_init(gen, 256, 512, 16, lead=(2,))
    assert w.shape == (2, 256, 512) and w.std().item() == pytest.approx(0.25, rel=0.05)
    assert TL.dense_init(gen, 256, 64).std().item() == pytest.approx(1 / 16, rel=0.05)
    assert TL.embed_init(gen, 300, 64).std().item() == pytest.approx(0.02, rel=0.05)


def test_linear_dispatches_on_the_leaf_type():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32))
    m = torch.from_numpy(rng.random((12, 6)) < 0.5)
    want = np.asarray(JL.linear(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                jnp.asarray(m.numpy())))
    np.testing.assert_allclose(TL.linear(x, w, m).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TL.linear(x, w).numpy(), (x @ w).numpy(), rtol=1e-6)


@pytest.mark.parametrize("tq,q_chunk,kv_chunk", [(8, 16, 16), (10, 4, 4), (13, 5, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention(tq, q_chunk, kv_chunk, dtype):
    rng = np.random.default_rng(tq)
    q = rng.standard_normal((2, tq, 4, 8)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, tq, 2, 8)).astype(np.float32)
    jq, tq_ = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    kw = dict(head_to_kv=HEAD_TO_KV, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = JA.chunked_attention(jq, jk, jv, **kw)
    got = TA.chunked_attention(tq_, tk, tv, **kw)
    assert got.shape == (2, tq, 4, 8) and got.dtype == tq_.dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_against_a_partly_filled_cache(window):
    rng = np.random.default_rng(5)
    s, cache_len = 6 if window == 0 else window, 5
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    kc, vc = rng.standard_normal((2, 2, s, 2, 8)).astype(np.float32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.int32(cache_len), head_to_kv=HEAD_TO_KV, window=window)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), cache_len, head_to_kv=HEAD_TO_KV,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,t,cache_len", [(8, 3, 0), (8, 3, 4), (4, 3, 2), (4, 6, 1)])
def test_cache_write_in_place_with_ring_semantics(s, t, cache_len):
    rng = np.random.default_rng(s + t + cache_len)
    kc, vc = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    kn, vn = rng.standard_normal((2, 2, t, 2, 4)).astype(np.float32)
    jk, jv = JA.cache_write(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                            jnp.asarray(vn), jnp.int32(cache_len))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    gk, gv = TA.cache_write(tkc, tvc, torch.from_numpy(kn), torch.from_numpy(vn), cache_len)
    assert gk is tkc and gv is tvc  # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("head_to_kv", [HEAD_TO_KV, (0, 0, 0, 1, 1, 1), (0, 1, 0, 1),
                                        (0, 0, 1, 1, 0, 0)])
def test_expand_kv_matches_reference(head_to_kv):
    """Plain GQA groups, and maps that are not (padded heads point at kv 0)."""
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    assert TA.expand_kv(k, (0, 1)) is k
    np.testing.assert_array_equal(
        TA.expand_kv(k, head_to_kv).numpy(),
        np.asarray(JA.expand_kv(jnp.asarray(k.numpy()), head_to_kv)))
