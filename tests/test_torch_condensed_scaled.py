"""The plain versions of K2 (condensed gather over int8/fp8 codes with a
per-neuron scale) and K2-coa (the same over the surviving rows, stored
through ``out_index``) against the reference's Pallas kernels in interpret
mode (``condensed_matmul(..., scales=)``, ``condensed_over_active_matmul(...,
scales=)``).

Tolerances: float32 atol 1e-5 (the k-sum runs in another order); bfloat16
atol 1e-2, rtol 8e-3 (one bf16 ulp), compared in float32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import condensed_matmul as JCM  # noqa: E402
from repro.kernels import structured_matmul as JSM  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.kernels import condensed_matmul as TCM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels import structured_matmul as TSM  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-2)}
D_IN, N_OUT, K, D_OUT = 70, 37, 11, 53   # nothing aligned to a tile
BATCHES = (1, 4, 20)


def _inputs(b, name, seed=0):
    """x, codes, indices, scales as the reference quantizes them, plus a
    COA out_index: 37 surviving rows scattered into 53 columns, the last 3
    rows padding (the sentinel D_OUT)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, D_IN)).astype(np.float32)
    values = (rng.standard_normal((N_OUT, K)) / np.sqrt(K)).astype(np.float32)
    values[: N_OUT // 4, K // 2:] = 0.0  # padding slots, as an export leaves them
    values[5] = 0.0                      # an all-zero row: scale 1
    idx = np.stack([rng.choice(D_IN, size=K, replace=False)
                    for _ in range(N_OUT)]).astype(np.int32)
    q, s = JF.quantize_values(jnp.asarray(values), name)
    oi = np.sort(rng.choice(D_OUT, size=N_OUT, replace=False)).astype(np.int32)
    oi[-3:] = D_OUT
    return x, q, idx, s, oi


def _t(q):
    """A reference array as a port tensor (fp8 through its bits)."""
    a = np.array(q)  # a writable copy
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", BATCHES)
def test_k2_plain_version_matches_reference_kernel(b, dtype, name):
    """B <= 8 takes the reference's decode launch, B = 20 its tiled launch."""
    x, q, idx, s, _ = _inputs(b, name, seed=b)
    want = np.asarray(JCM.condensed_matmul(jnp.asarray(x).astype(getattr(jnp, dtype)), q,
                                           jnp.asarray(idx), scales=s, interpret=True)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TCM.condensed_matmul(tx, _t(q), torch.from_numpy(idx), scales=_t(s))
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, N_OUT)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    np.testing.assert_array_equal(
        TREF.condensed_matmul_scaled_ref(tx, _t(q), torch.from_numpy(idx), _t(s)).numpy()
        if dtype == "float32" else
        TREF.condensed_matmul_scaled_ref(tx, _t(q), torch.from_numpy(idx), _t(s)).float().numpy(),
        got.float().numpy())
    assert np.all(got.float().numpy()[:, 5] == 0)


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", BATCHES)
def test_k2_coa_plain_version_matches_reference_kernel(b, dtype, name):
    x, q, idx, s, oi = _inputs(b, name, seed=10 + b)
    want = np.asarray(JSM.condensed_over_active_matmul(
        jnp.asarray(x).astype(getattr(jnp, dtype)), q, jnp.asarray(idx), jnp.asarray(oi),
        D_OUT, scales=s, interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TSM.condensed_over_active_matmul(tx, _t(q), torch.from_numpy(idx),
                                           torch.from_numpy(oi), D_OUT, scales=_t(s))
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, D_OUT)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    dropped = np.setdiff1d(np.arange(D_OUT), oi[:-3])
    assert np.all(got.float().numpy()[:, dropped] == 0)
    # row r of K2-coa is row r of K2, stored at out_index[r]
    rows = TCM.condensed_matmul(tx, _t(q), torch.from_numpy(idx), scales=_t(s))
    np.testing.assert_array_equal(got[:, oi[:-3]].float().numpy(),
                                  rows[:, :-3].float().numpy())


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_k2_in_float32_is_k1_on_float_codes_times_the_scales(name):
    x, q, idx, s, _ = _inputs(6, name, seed=21)
    tx, tq, ti, ts = torch.from_numpy(x), _t(q), torch.from_numpy(idx), _t(s)
    k2 = TCM.condensed_matmul(tx, tq, ti, scales=ts)
    k1 = TCM.condensed_matmul(tx, tq.float(), ti) * ts
    assert torch.equal(k2, k1)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_launch_forms_and_nd_ops_agree_on_the_cpu(name):
    x, q, idx, s, oi = _inputs(12, name, seed=31)
    tx, tq, ti, ts, toi = (torch.from_numpy(x), _t(q), torch.from_numpy(idx), _t(s),
                           torch.from_numpy(oi))
    tiled = TCM.condensed_matmul(tx, tq, ti, scales=ts, block_b=2)
    assert torch.equal(TCM.condensed_matmul_decode(tx, tq, ti, scales=ts), tiled)
    y3 = TOPS.condensed_linear_nd(tx.reshape(3, 4, D_IN), tq, ti, scales=ts)
    assert torch.equal(y3.reshape(12, N_OUT), tiled)
    coa = TSM.condensed_over_active_matmul(tx, tq, ti, toi, D_OUT, scales=ts)
    assert torch.equal(TSM.condensed_over_active_matmul_decode(tx, tq, ti, toi, D_OUT,
                                                               scales=ts), coa)
    c3 = TOPS.condensed_over_active_linear_nd(tx.reshape(2, 6, D_IN), tq, ti, toi, D_OUT,
                                              scales=ts)
    assert torch.equal(c3.reshape(12, D_OUT), coa)


def test_scaled_wrappers_reject_what_the_kernels_do_not_take():
    x, q, idx, s, oi = _inputs(2, "int8")
    tx, tq, ti, ts = torch.from_numpy(x), _t(q), torch.from_numpy(idx), _t(s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TCM.condensed_matmul(tx, tq, ti)                      # codes need scales
    with pytest.raises(TypeError, match="codes"):
        TCM.condensed_matmul(tx, tq.float(), ti, scales=ts)   # scales need codes
    with pytest.raises(TypeError, match="scales must be float32"):
        TCM.condensed_matmul(tx, tq, ti, scales=ts.double())
    with pytest.raises(TypeError, match="scales must be float32"):
        TCM.condensed_matmul(tx, tq, ti, scales=ts[:-1])
    with pytest.raises(TypeError, match="codes"):
        TSM.condensed_over_active_matmul(tx.double(), tq, ti, torch.from_numpy(oi), D_OUT,
                                         scales=ts)


def test_scaled_wrappers_take_the_plain_version_only_on_the_cpu(monkeypatch):
    """Off the CPU a scaled call launches K2 / K2-coa or raises, or on the
    meta device (the dry run's) gets the kernel's output shape and dtype; it
    never runs the plain version, and only a launch counts."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(TCM, "_plain", plain)
    monkeypatch.setattr(TSM, "_coa_plain", plain)
    meta = dict(device="meta")
    x = torch.zeros((2, 8), **meta)
    q = torch.zeros((3, 2), dtype=torch.int8, **meta)
    idx = torch.zeros((3, 2), dtype=torch.int32, **meta)
    s = torch.zeros((3,), **meta)
    oi = torch.zeros((3,), dtype=torch.int32, **meta)
    before = (TCM.condensed_matmul.scaled_launches,
              TSM.condensed_over_active_matmul.scaled_launches, TCM.condensed_matmul.launches)
    for call in (lambda: TCM.condensed_matmul(x, q, idx, scales=s),
                 lambda: TCM.condensed_matmul(x, q, idx, scales=s, block_b=4),
                 lambda: TCM.condensed_matmul_decode(x, q, idx, scales=s),
                 lambda: TSM.condensed_over_active_matmul(x, q, idx, oi, 5, scales=s),
                 lambda: TSM.condensed_over_active_matmul(x, q, idx, oi, 5, scales=s,
                                                          block_b=2)):
        y = call()
        assert y.device.type == "meta" and y.shape[0] == 2 and y.dtype == x.dtype
    assert (TCM.condensed_matmul.scaled_launches,
            TSM.condensed_over_active_matmul.scaled_launches,
            TCM.condensed_matmul.launches) == before
    monkeypatch.undo()
    # on the CPU the plain version runs and nothing is counted either
    TCM.condensed_matmul(torch.zeros((2, 8)), torch.zeros((3, 2), dtype=torch.int8),
                         torch.zeros((3, 2), dtype=torch.int32), scales=torch.ones(3))
    assert TCM.condensed_matmul.scaled_launches == before[0]


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantized_formats_hand_codes_and_scales_to_the_scaled_op(name, monkeypatch):
    """``apply`` passes the codes and the scales untouched (no cast of the
    codes to the activation dtype)."""
    rng = np.random.default_rng(41)
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.random((24, 16)) < 0.3)
    mask[:, 9:] = False
    seen = []
    real = TCM.condensed_matmul

    def spy(x, values, indices, *, scales=None, block_b=None, block_n=None):
        seen.append((values.dtype, None if scales is None else scales.dtype))
        return real(x, values, indices, scales=scales, block_b=block_b, block_n=block_n)
    monkeypatch.setattr(TCM, "condensed_matmul", spy)
    x = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32)).to(torch.bfloat16)
    TF.Condensed.export_from_dense(w, mask, quantize_spec=name).apply(x)
    assert seen == [(TF.VALUES_DTYPES[name], torch.float32)]
    coa = TF.CondensedOverActive.export_from_dense(w, mask, quantize_spec=name)
    assert coa.values.dtype == TF.VALUES_DTYPES[name] and coa.scales.shape == (9,)
    y = coa.apply(x)
    assert y.dtype == torch.bfloat16 and not y[:, 9:].float().any()
