"""Quantized exports, their prices and the plans built on them, against the
reference (``repro.sparse.formats`` / ``repro.sparse.plan``).

Both sides export the same float32 stacks: codes, scales, indices,
``out_index`` and ``active_index`` must be identical, bf16 values too (a
storage cast of identical float32 values). Prices are compared at the
reference profile's rates, fed to the port's ``HardwareProfile`` here so
that cost tables can be compared (the port's own default carries H100
rates).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_smoke_model import smoke_masks, smoke_model  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

VALUE_DTYPES = ("bf16", "int8", "fp8")
FORMATS = ("condensed", "condensed_over_active", "structured")
LEAD, D_IN, D_OUT, K = 2, 40, 72, 9
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})


def _stack(seed=0):
    """(LEAD, D_IN, D_OUT) float32 weights, a constant fan-in mask with the
    last quarter of each layer's neurons ablated, uneven per layer."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((LEAD, D_IN, D_OUT)).astype(np.float32)
    mask = np.zeros((LEAD, D_IN, D_OUT), bool)
    for layer in range(LEAD):
        for c in range(D_OUT - D_OUT // 4 - 3 * layer):
            mask[layer, rng.choice(D_IN, size=K, replace=False), c] = True
    return w, mask


def _np(a) -> np.ndarray:
    """A tensor or reference array as numpy, 1-byte floats as their bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_same_export(jleaf, tleaf):
    assert type(tleaf).format_name == type(jleaf).format_name
    assert getattr(tleaf, "values_dtype", None) == getattr(jleaf, "values_dtype", None)
    for f in type(tleaf)._array_fields:
        t, j = getattr(tleaf, f), getattr(jleaf, f)
        assert (t is None) == (j is None), f
        if t is not None:
            assert t.dtype.itemsize == np.asarray(j).dtype.itemsize, f
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=f)


@pytest.mark.parametrize("values_dtype", VALUE_DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_exports_equal_the_reference_array_for_array(fmt, values_dtype):
    w, mask = _stack(seed=len(fmt))
    jleaf = JF.FORMATS[fmt].export_from_dense(jnp.asarray(w), jnp.asarray(mask),
                                              quantize_spec=values_dtype)
    tleaf = TF.FORMATS[fmt].export_from_dense(torch.from_numpy(w), torch.from_numpy(mask),
                                              quantize_spec=values_dtype)
    _assert_same_export(jleaf, tleaf)
    if values_dtype in TF.QUANTIZED_DTYPES:
        assert tleaf.values.dtype == TF.VALUES_DTYPES[values_dtype]
        assert tleaf.scales.dtype == torch.float32
    js, ts = jleaf.spec(), tleaf.spec()
    for f in dataclasses.fields(TF.FormatSpec):
        assert getattr(ts, f.name) == pytest.approx(getattr(js, f.name)), f.name


@pytest.mark.parametrize("values_dtype", (None,) + VALUE_DTYPES)
def test_weight_bytes_and_costs_equal_the_reference(values_dtype):
    kw = dict(d_in=2048, d_out=6144, n_replicas=28, itemsize=4, k=195, max_active=3072.0,
              active_fraction=0.5)
    tspec = TF.FormatSpec(**kw, values_dtype=values_dtype)
    jspec = JF.FormatSpec(**kw, values_dtype=values_dtype)
    for name, tcls in TF.FORMATS.items():
        jcls = JF.FORMATS[name]
        assert tcls.estimate_weight_bytes(tspec) == jcls.estimate_weight_bytes(jspec), name
        assert tcls.estimate_values_bytes(tspec) == jcls.estimate_values_bytes(jspec), name
        for b in (1, 8, 256):
            assert tcls.estimate_cost(tspec, b, PROFILE) == pytest.approx(
                jcls.estimate_cost(jspec, b, JP.DEFAULT_PROFILE), rel=1e-12), (name, b)


def test_quantized_stores_fewer_value_bytes_than_float():
    """The priced bytes are the allocated bytes: codes + scales + indices."""
    w, mask = _stack(seed=9)
    tw, tm = torch.from_numpy(w), torch.from_numpy(mask)
    f32 = TF.Condensed.export_from_dense(tw, tm)
    for name in TF.QUANTIZED_DTYPES:
        q = TF.Condensed.export_from_dense(tw, tm, quantize_spec=name)
        stored = sum(t.numel() * t.element_size() for t in q.arrays().values())
        assert stored == TF.Condensed.estimate_weight_bytes(q.spec())
        assert q.values.numel() == f32.values.numel() and q.values.element_size() == 1
        assert stored < sum(t.numel() * t.element_size() for t in f32.arrays().values())


@pytest.fixture(scope="module")
def smoke():
    # the JAX init and the masks with half of each stack's neurons ablated,
    # shared with the other quantized test files
    jmasks = smoke_masks()["ablated"]
    return dict(smoke_model(), jmasks=jmasks,
                tmasks=bridge.from_jax_numpy(jax.tree.map(np.asarray, jmasks)))


@pytest.mark.parametrize("values_dtype", VALUE_DTYPES)
@pytest.mark.parametrize("batch", (1, 8, 256))
def test_auto_plans_decide_as_the_reference(smoke, batch, values_dtype):
    r = smoke
    jplan = JP.build_plan(r["jcfg"], r["jreg"], r["jparams"], r["jmasks"], batch_size=batch,
                          path="auto", values_dtype=values_dtype)
    tplan = TP.build_plan(r["tcfg"], r["treg"], r["tparams"], r["tmasks"], batch_size=batch,
                          path="auto", profile=PROFILE, values_dtype=values_dtype)
    assert tplan.values_dtype == jplan.values_dtype == values_dtype
    for name, jdec in jplan.decisions.items():
        tdec = tplan.decisions[name]
        assert tdec.representation == jdec.representation, name
        for rep, s in jdec.est_s.items():
            assert tdec.est_s[rep] == pytest.approx(s, rel=1e-12), (name, rep)
    for s in r["jreg"]:
        _assert_same_export(JR.get_path(jplan.serving_tree, s.path),
                            TR.get_path(tplan.serving_tree, s.path))
    assert tplan.weight_bytes() == jplan.weight_bytes()
    assert tplan.describe(requested_batch=3) == jplan.describe(requested_batch=3)


@pytest.mark.parametrize("values_dtype", VALUE_DTYPES)
def test_masked_plans_ignore_the_values_dtype(smoke, values_dtype):
    r = smoke
    tplan = TP.build_plan(r["tcfg"], r["treg"], r["tparams"], r["tmasks"], batch_size=8,
                          path="masked", profile=PROFILE, values_dtype=values_dtype)
    for s in r["treg"]:
        leaf = TR.get_path(tplan.serving_tree, s.path)
        assert isinstance(leaf, TF.MaskedDense)
        assert torch.equal(leaf.mask, TR.get_path(r["tmasks"], s.path))
    serving, masked = tplan.weight_bytes()
    assert serving == masked


@pytest.mark.parametrize("path,values_dtype", [("condensed", "int8"),
                                               ("condensed_over_active", "fp8"),
                                               ("structured", "int8")])
def test_tree_exports_take_a_quantize_spec(smoke, path, values_dtype):
    """``sparse.condensed``'s tree exports with ``quantize_spec`` give the
    leaves the reference's plan exports on that forced path."""
    from repro_torch.sparse import condensed as TC
    r = smoke
    jplan = JP.build_plan(r["jcfg"], r["jreg"], r["jparams"], r["jmasks"], batch_size=8,
                          path=path, values_dtype=values_dtype)
    if path == "structured":
        tree = TC.export_structured(r["tcfg"], r["treg"], r["tmasks"], params=r["tparams"],
                                    quantize_spec=values_dtype)
        with pytest.raises(ValueError, match="needs the params"):
            TC.export_structured(r["tcfg"], r["treg"], r["tmasks"], quantize_spec="int8")
    else:
        export = {"condensed": TC.export_condensed,
                  "condensed_over_active": TC.export_condensed_over_active}[path]
        tree = export(r["tcfg"], r["treg"], r["tparams"], r["tmasks"],
                      quantize_spec=values_dtype)
    for s in r["jreg"]:
        _assert_same_export(JR.get_path(jplan.serving_tree, s.path), TR.get_path(tree, s.path))
