"""Quantized values: the port's ``quantize_values`` / ``dequantize_values``
against the reference's, and fp8 through the bridge.

Codes must equal the reference's bit for bit (int8 rounds half to even and
clips to +-127, fp8 is a round-to-nearest-even cast to float8_e4m3fn) and
scales must be equal, since both sides run the same float32 steps.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402


def _values(seed=0, shape=(3, 19, 37)):
    """Rows of very different magnitudes, some exact zeros and ties of the
    int8 rounding (values at half a code step)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * rng.uniform(1e-3, 1e2, shape[:-1] + (1,))
    v[..., ::7] = 0.0
    v[0, 1] = 0.0
    v[0, 1, :4] = [1.0, 0.5 / 127, -1.5 / 127, 2.5 / 127]  # absmax 1: code ties
    return v.astype(np.float32)


def _bits(t) -> np.ndarray:
    """The codes' raw bytes (fp8 has no numpy dtype of its own here)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codes_and_scales_equal_the_reference(name, axis):
    v = _values(seed=abs(axis))
    jq, js = JF.quantize_values(jnp.asarray(v), name, axis=axis)
    tq, ts = TF.quantize_values(torch.from_numpy(v), name, axis=axis)
    assert tq.dtype == TF.VALUES_DTYPES[name] and ts.dtype == torch.float32
    assert tuple(tq.shape) == v.shape and tuple(ts.shape) == np.asarray(js).shape
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = JF.dequantize_values(jq, js, axis=axis)
    td = TF.dequantize_values(tq, ts, axis=axis)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    td16 = TF.dequantize_values(tq, ts, axis=axis, dtype=torch.bfloat16)
    assert td16.dtype == torch.bfloat16
    np.testing.assert_array_equal(td16.float().numpy(), td.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_all_zero_rows_get_unit_scales_and_zero_codes(name):
    v = _values(seed=3)
    v[1, 4] = 0.0
    v[2, :, 5] = 0.0
    q, s = TF.quantize_values(torch.from_numpy(v), name)
    assert s[1, 4].item() == 1.0
    assert not q[1, 4].float().any()
    q2, s2 = TF.quantize_values(torch.from_numpy(v), name, axis=-2)
    assert s2[2, 5].item() == 1.0 and not q2[2, :, 5].float().any()
    # dequantizing reproduces the zeros exactly, with no negative zero
    d = TF.dequantize_values(q, s)
    assert np.array_equal(d[1, 4].numpy().view(np.uint32), np.zeros(v.shape[-1], np.uint32))


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_int8_codes_round_half_to_even_and_stay_in_range(name):
    v = _values(seed=5)
    q, s = TF.quantize_values(torch.from_numpy(v), name)
    qmax = {"int8": 127.0, "fp8": 448.0}[name]
    assert q.float().abs().max().item() <= qmax
    if name == "int8":  # 0.5, -1.5 and 2.5 code steps round to 0, -2, 2
        assert q[0, 1, :4].tolist() == [127, 0, -2, 2]
    rel = (TF.dequantize_values(q, s) - torch.from_numpy(v)).abs().max() / np.abs(v).max()
    assert rel.item() <= {"int8": 1 / 127, "fp8": 1 / 16}[name]


def test_spec_names_itemsizes_and_storage_match_the_reference():
    for spec in (None, "f32", "bf16", "int8", "fp8"):
        assert TF.resolve_quantize_spec(spec) == JF.resolve_quantize_spec(spec)
    assert TF.resolve_quantize_spec(torch.int8) == "int8"
    assert TF.resolve_quantize_spec(torch.float8_e4m3fn) == "fp8"
    assert TF.resolve_quantize_spec(torch.float32) is None
    with pytest.raises(ValueError, match="unknown values dtype"):
        TF.resolve_quantize_spec("int4")
    with pytest.raises(ValueError, match="needs one of"):
        TF.quantize_values(torch.zeros(2, 3), "bf16")
    assert sorted(TF.VALUES_DTYPES) == sorted(JF.VALUES_DTYPES)
    assert TF.QUANTIZED_DTYPES == JF.QUANTIZED_DTYPES
    for name in TF.VALUES_DTYPES:
        spec = TF.FormatSpec(d_in=4, d_out=4, n_replicas=1, itemsize=4, k=2, max_active=4,
                             active_fraction=1.0, values_dtype=TF.resolve_quantize_spec(name))
        jspec = JF.FormatSpec(d_in=4, d_out=4, n_replicas=1, itemsize=4, k=2, max_active=4,
                              active_fraction=1.0,
                              values_dtype=JF.resolve_quantize_spec(name))
        assert TF.values_itemsize(spec) == JF.values_itemsize(jspec)
    for dt in (torch.int8, torch.float8_e4m3fn):
        assert TF.is_quantized_storage(dt) and TF.is_quantized_storage(torch.zeros(1, dtype=dt))
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        assert not TF.is_quantized_storage(dt)


def test_bridge_takes_fp8_arrays_from_the_reference():
    """ml_dtypes fp8 becomes torch.float8_e4m3fn with the same bits."""
    jq, _ = JF.quantize_values(jnp.asarray(_values(seed=7)), "fp8")
    arr = np.asarray(jq)
    tree = bridge.from_jax_numpy({"blocks": {"wo": {"values": arr}}})
    t = tree["blocks"]["wo"]["values"]
    assert t.dtype == torch.float8_e4m3fn and tuple(t.shape) == arr.shape
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), arr.view(np.uint8))


def test_bridge_hands_fp8_tensors_back_as_exact_float32():
    q, _ = TF.quantize_values(torch.from_numpy(_values(seed=8)), "fp8")
    back = bridge.to_jax_numpy({"a": {"values": q}})["a"]["values"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, q.float().numpy())
    # and through ml_dtypes to the same bits the reference would hold
    np.testing.assert_array_equal(back.astype(ml_dtypes.float8_e4m3fn).view(np.uint8),
                                  q.view(torch.uint8).numpy())
