"""The ablation-aware kernels' plain versions (the CPU paths of K4, K5 and
K6), their wrappers, ops and formats against the reference's Pallas
``structured_matmul`` module in interpret mode and its ``ops`` formulas.

Tolerances: float32 rtol=atol=1e-5, because the sums run in another order;
bfloat16 outputs are compared in float32 with rtol=8e-3, one bf16 ulp,
since two f32 sums may round to neighbouring bf16 values. The structured
plain version is not held bitwise to the reference's interpret output,
whose bf16 bit-identity test fails on this JAX version. Integer arrays of
the exports (indices, out_index, active_index, neuron_active) must be equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import structured_matmul as JSM  # noqa: E402
from repro.sparse import condensed as JC  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.kernels import condensed_matmul as TCM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels import structured_matmul as TSM  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-6)}
D_IN, D_OUT, K = 70, 37, 11   # nothing aligned to a tile


def _mask(rng, d_in=D_IN, d_out=D_OUT, k=K, lead=()):
    """Constant fan-in k with every third neuron ablated and two short columns."""
    m = np.zeros((*lead, d_in, d_out), bool)
    for idx in np.ndindex(*lead, d_out):
        *l, c = idx
        m[(*l, rng.choice(d_in, size=k if c % 7 else k - 3, replace=False), c)] = True
    m[..., ::3] = False
    return m


def _ablation_only(m):
    return np.broadcast_to(m.any(axis=-2, keepdims=True), m.shape).copy()


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(getattr(torch, dtype)) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a).astype(getattr(jnp, dtype)) if dtype else jnp.asarray(a)


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(
        y.astype(jnp.float32))


def _coa_inputs(b, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((D_IN, D_OUT)).astype(np.float32) / np.sqrt(K)
    m = _mask(rng)
    x = rng.standard_normal((b, D_IN)).astype(np.float32)
    jfmt = JF.CondensedOverActive.export_from_dense(jnp.asarray(w), jnp.asarray(m))
    vals, idx, oi = (np.asarray(a) for a in (jfmt.values, jfmt.indices, jfmt.out_index))
    # two padding rows, as an export of unevenly ablated layers leaves them
    vals = np.concatenate([vals, np.zeros((2, vals.shape[1]), np.float32)])
    idx = np.concatenate([idx, idx[:2]])
    oi = np.concatenate([oi, np.full(2, D_OUT, np.int32)])
    return x, vals, idx, oi, w * m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 5, 33])
def test_coa_plain_version_matches_reference_kernel_and_unfused_ops(b, dtype):
    """B <= 8 is the reference's decode launch, B > 8 its tiled launch."""
    x, vals, idx, oi, wm = _coa_inputs(b, seed=b)
    got = TSM.condensed_over_active_matmul(_t(x, dtype), _t(vals, dtype), _t(idx), _t(oi),
                                           D_OUT)
    assert got.shape == (b, D_OUT) and got.dtype == getattr(torch, dtype)
    kernel = JSM.condensed_over_active_matmul(_j(x, dtype), _j(vals, dtype), _j(idx), _j(oi),
                                              D_OUT, interpret=True)
    np.testing.assert_allclose(_np(got), _np(kernel), **TOL[dtype])
    unfused = JOPS.condensed_over_active_linear_nd_unfused(
        _j(x, dtype), _j(vals, dtype), _j(idx), _j(oi), D_OUT)
    np.testing.assert_allclose(_np(got), _np(unfused), **TOL[dtype])
    ablated = ~wm.any(axis=0)
    assert np.all(_np(got)[:, ablated] == 0)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), x @ wm, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 5, 33])
def test_structured_plain_version_matches_reference_kernel_and_formula(b, dtype):
    rng = np.random.default_rng(100 + b)
    w = rng.standard_normal((D_IN, D_OUT)).astype(np.float32) / np.sqrt(D_IN)
    only = _ablation_only(_mask(rng))
    act = only.any(axis=0)
    a_pad = TSM.padded_active_count(int(act.sum()), D_OUT)
    ai = np.asarray(JF.active_index_from_bools(jnp.asarray(act), a_pad))
    x = rng.standard_normal((b, D_IN)).astype(np.float32)
    got = TSM.structured_matmul(_t(x, dtype), _t(w, dtype), _t(ai))
    assert got.shape == (b, D_OUT) and got.dtype == getattr(torch, dtype)
    kernel = JSM.structured_matmul(_j(x, dtype), _j(w, dtype), _j(ai), interpret=True)
    np.testing.assert_allclose(_np(got), _np(kernel), **TOL[dtype])
    formula = JOPS.structured_dense(_j(x, dtype), _j(w, dtype), _j(act))
    np.testing.assert_allclose(_np(got), _np(formula), **TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(TREF.structured_dense(_t(x, dtype), _t(w, dtype), _t(act))), **TOL[dtype])
    assert np.all(_np(got)[:, ~act] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_forms_and_prefetch_agree_on_the_cpu(dtype):
    """Decode, tiled, prefetch and pre-gathered entry points compute one
    function; on the CPU each takes the same plain version."""
    rng = np.random.default_rng(7)
    w = _t(rng.standard_normal((D_IN, D_OUT)).astype(np.float32), dtype)
    act = _t(_mask(rng).any(axis=0))
    ai = TF.active_index_from_bools(act, TSM.padded_active_count(int(act.sum()), D_OUT))
    x = _t(rng.standard_normal((6, D_IN)).astype(np.float32), dtype)
    decode = TSM.structured_matmul_decode(x, w, ai, prefetch_gather=False)
    for y in (TSM.structured_matmul(x, w, ai, block_b=2),
              TSM.structured_matmul_decode(x, w, ai, prefetch_gather=True),
              TSM.structured_matmul_prefetch(x, w, ai),
              TSM.structured_matmul_pregathered(x, TSM._gather_columns(w, ai), ai, D_OUT)):
        assert torch.equal(y, decode)
    xs, vals, idx, oi, _ = _coa_inputs(6, seed=8)
    args = (_t(xs, dtype), _t(vals, dtype), _t(idx), _t(oi), D_OUT)
    tdt = getattr(torch, dtype)
    for tile in (2, TCM.TILED_ROWS[tdt], TCM.GATHER_ROWS[tdt][0]):
        assert torch.equal(TSM.condensed_over_active_matmul_decode(*args),
                           TSM.condensed_over_active_matmul(*args, block_b=tile))


def test_prefetch_gather_none_reads_the_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(TSM, "structured_matmul_prefetch",
                        lambda *a: calls.append(a) or TREF.structured_matmul_ref(
                            a[0], TSM._gather_columns(a[1], a[2]), a[2], a[1].shape[1]))
    x, w = torch.ones((2, 4)), torch.ones((4, 3))
    ai = torch.tensor([0, 2, 3], dtype=torch.int32)
    monkeypatch.setenv("REPRO_PREFETCH_GATHER", "0")
    TSM.structured_matmul(x, w, ai)
    assert not calls
    monkeypatch.setenv("REPRO_PREFETCH_GATHER", "1")
    y = TSM.structured_matmul(x, w, ai)
    assert len(calls) == 1
    assert y.tolist() == [[4.0, 0.0, 4.0]] * 2
    TSM.structured_matmul(x, w, ai, prefetch_gather=False)
    assert len(calls) == 1


def test_plain_versions_accumulate_in_float32_and_drop_sentinels():
    x = torch.ones((1, 4), dtype=torch.bfloat16)
    values = torch.tensor([[256.0, 1.0, 1.0, -256.0]] * 2, dtype=torch.bfloat16)
    idx = torch.arange(4, dtype=torch.int32)[None].repeat(2, 1)
    out = TSM.condensed_over_active_matmul(x, values, idx, torch.tensor([2, 3],
                                           dtype=torch.int32), 3)
    assert out.tolist() == [[0.0, 0.0, 2.0]]   # row 1 is padding: dropped
    panel = values.T.contiguous()
    y = TSM.structured_matmul_pregathered(x, panel, torch.tensor([1, 3], dtype=torch.int32), 3)
    assert y.tolist() == [[0.0, 2.0, 0.0]]


@pytest.mark.parametrize("a,d_out", [(1, 37), (37, 37), (100, 300), (129, 300), (300, 300),
                                     (0, 5), (7.5, 1000), (256, 256)])
def test_padded_active_count_matches_reference(a, d_out):
    assert TSM.padded_active_count(a, d_out) == JSM.padded_active_count(a, d_out)


def test_active_index_and_condense_active_match_reference_on_stacks():
    rng = np.random.default_rng(3)
    m = _mask(rng, lead=(3,))
    m[1, :, :20] = False             # uneven ablation across the stack
    w = rng.standard_normal(m.shape).astype(np.float32)
    for a_pad in (13, 128):
        np.testing.assert_array_equal(
            TF.active_index_from_mask(_t(m), a_pad).numpy(),
            np.asarray(JF.active_index_from_mask(jnp.asarray(m), a_pad)))
    jcoa = JF.CondensedOverActive.export_from_dense(jnp.asarray(w), jnp.asarray(m))
    tcoa = TF.CondensedOverActive.export_from_dense(_t(w), _t(m))
    for f in ("indices", "out_index"):
        t, j = getattr(tcoa, f), np.asarray(getattr(jcoa, f))
        assert t.dtype == torch.int32 and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_allclose(tcoa.values.numpy(), np.asarray(jcoa.values), rtol=1e-6)
    assert (tcoa.d_in, tcoa.d_out) == (jcoa.d_in, jcoa.d_out)
    jst = JF.StructuredFanIn.export_from_dense(jnp.asarray(w), jnp.asarray(m))
    tst = TF.StructuredFanIn.export_from_dense(_t(w), _t(m))
    np.testing.assert_array_equal(tst.active_index.numpy(), np.asarray(jst.active_index))
    np.testing.assert_array_equal(tst.neuron_active.numpy(), np.asarray(jst.neuron_active))
    assert tst.spec() == TF.FormatSpec(**{f: getattr(jst.spec(), f) for f in (
        "d_in", "d_out", "n_replicas", "itemsize", "k", "max_active", "active_fraction")})
    layer = tcoa.layer(1)
    assert layer.values.shape == tcoa.values.shape[1:] and layer.d_out == D_OUT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_format_apply_chain_matches_reference(dtype):
    """Export then apply over leading dims, as a serving linear runs it."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((D_IN, D_OUT)).astype(np.float32) / np.sqrt(K)
    m = _mask(rng)
    x = rng.standard_normal((2, 3, D_IN)).astype(np.float32)
    for jcls, tcls, mask in ((JF.CondensedOverActive, TF.CondensedOverActive, m),
                             (JF.StructuredFanIn, TF.StructuredFanIn, _ablation_only(m)),
                             (JF.MaskedDense, TF.MaskedDense, m)):
        jw = jnp.asarray(w).astype(getattr(jnp, dtype))
        jfmt = jcls.export_from_dense(jnp.asarray(w), jnp.asarray(mask))
        want = _np(jfmt.apply(_j(x, dtype), jw))
        got = tcls.export_from_dense(_t(w), _t(mask)).apply(_t(x, dtype), _t(w, dtype))
        assert got.shape == (2, 3, D_OUT) and got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), want, **TOL[dtype], err_msg=tcls.__name__)


def test_nd_ops_match_reference():
    x, vals, idx, oi, _ = _coa_inputs(12, seed=9)
    x3 = x.reshape(3, 4, D_IN)
    want = JOPS.condensed_over_active_linear_nd(_j(x3), _j(vals), _j(idx), _j(oi), D_OUT)
    got = TOPS.condensed_over_active_linear_nd(_t(x3), _t(vals), _t(idx), _t(oi), D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    rng = np.random.default_rng(10)
    w = rng.standard_normal((D_IN, D_OUT)).astype(np.float32)
    act = _mask(rng).any(axis=0)
    ai = np.asarray(JF.active_index_from_bools(jnp.asarray(act), 128))
    want = JOPS.structured_linear_nd(_j(x3), _j(w), _j(ai))
    got = TOPS.structured_linear_nd(_t(x3), _t(w), _t(ai))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    panel = np.take(w, np.minimum(ai, D_OUT - 1), axis=1)
    want = JOPS.structured_gathered_linear_nd(_j(x3), _j(panel), _j(ai), D_OUT)
    got = TOPS.structured_gathered_linear_nd(_t(x3), _t(panel), _t(ai), D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(TOPS.structured_dense(_t(x), _t(w), _t(act)).numpy(),
                               np.asarray(JOPS.structured_dense(_j(x), _j(w), _j(act))),
                               **TOL["float32"])


def test_tree_exports_match_reference():
    class Stack:  # the two registries' stacks share path/name/shape
        def __init__(self, name, lead, d_in, d_out):
            self.path, self.name = ("blocks", name), f"blocks/{name}"
            self.lead, self.d_in, self.d_out = lead, d_in, d_out
    rng = np.random.default_rng(11)
    stacks = [Stack("a", (2,), D_IN, D_OUT), Stack("b", (2,), D_OUT, D_IN)]
    params, masks = {"blocks": {}}, {"blocks": {}}
    for s in stacks:
        params["blocks"][s.path[1]] = rng.standard_normal((2, s.d_in, s.d_out)).astype(np.float32)
        masks["blocks"][s.path[1]] = _mask(rng, s.d_in, s.d_out, 5, lead=(2,))

    class Cfg:
        dtype = "float32"
    jtree = lambda t: {"blocks": {n: jnp.asarray(a) for n, a in t["blocks"].items()}}  # noqa
    ttree = lambda t: {"blocks": {n: _t(a) for n, a in t["blocks"].items()}}  # noqa
    jcoa = JC.export_condensed_over_active(Cfg, stacks, jtree(params), jtree(masks))
    tcoa = TC.export_condensed_over_active(Cfg, stacks, ttree(params), ttree(masks))
    jst = JC.export_structured(Cfg, stacks, jtree(masks))
    tst = TC.export_structured(Cfg, stacks, ttree(masks))
    for s in stacks:
        j, t = jcoa["blocks"][s.path[1]], tcoa["blocks"][s.path[1]]
        np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
        np.testing.assert_array_equal(t.out_index.numpy(), np.asarray(j.out_index))
        j, t = jst["blocks"][s.path[1]], tst["blocks"][s.path[1]]
        np.testing.assert_array_equal(t.active_index.numpy(), np.asarray(j.active_index))
        np.testing.assert_array_equal(t.neuron_active.numpy(), np.asarray(j.neuron_active))
        assert t.d_in == j.d_in


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, vals, idx, oi, _ = (_t(a) for a in _coa_inputs(2, seed=1))
    with pytest.raises(TypeError, match="int32"):
        TSM.condensed_over_active_matmul(x, vals, idx, oi.long(), D_OUT)
    with pytest.raises(ValueError, match="out_index"):
        TSM.condensed_over_active_matmul(x, vals, idx, oi[:-1], D_OUT)
    with pytest.raises(ValueError, match="block_b"):
        TSM.condensed_over_active_matmul(x, vals, idx, oi, D_OUT, block_b=3)
    w = torch.zeros((D_IN, D_OUT))
    ai = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TSM.structured_matmul(x, w.to(torch.bfloat16), ai)
    with pytest.raises(ValueError, match="d_in"):
        TSM.structured_matmul(x, w[:-1], ai)
    with pytest.raises(ValueError, match="columns"):
        TSM.structured_matmul_pregathered(x, w, ai, D_OUT)
    with pytest.raises(ValueError, match="block_b"):
        TSM.structured_matmul(torch.zeros((9, D_IN)), w, ai, block_b=3)


@pytest.mark.parametrize("d_in", [1, 63, 64, 65, 512, 513, 1000, 1001, 2048, 6144, 28672])
def test_split_geometry_depends_on_d_in_and_the_dtype_only(d_in):
    """K5/K6's d_in splits: bfloat16 at most MAX_SPLITS of them (one cluster
    adds them), each a multiple of 64 rows; float32 256 rows each. They
    cover d_in with no empty split, and the wrapper's workspace follows
    from them: none in bfloat16 at any batch, one (B, a_pad) slab per split
    in float32. No batch enters the geometry, so every launch (decode,
    tiled at any tile, K6) sums each output in one order."""
    for dtype in (torch.bfloat16, torch.float32):
        rows, splits = TSM.split_geometry(d_in, dtype)
        assert (splits - 1) * rows < d_in <= splits * rows
        if dtype == torch.bfloat16:
            assert rows % TSM.CHUNK_ROWS == 0 and splits <= TSM.MAX_SPLITS
        else:
            assert rows == TSM.F32_SPLIT_ROWS
        for b in (1, 4, 8, 100, 128, 4096):
            want = 0 if dtype == torch.bfloat16 else splits * b * 896
            assert TSM.workspace_floats(b, d_in, 896, dtype) == want
    assert TSM.split_geometry(2048, torch.bfloat16) == (256, 8)
    assert TSM.split_geometry(6144, torch.bfloat16) == (768, 8)


def test_block_b_is_what_each_dtype_takes():
    """bfloat16 takes batch tiles of 1 to 128 rows, float32 the decode
    tiles and its 32-row tiled launch; each refuses the others, on any
    device, and on the CPU every tile gives the plain version."""
    rng = np.random.default_rng(11)
    w = _t(rng.standard_normal((D_IN, D_OUT)).astype(np.float32))
    act = _t(_mask(rng).any(axis=0))
    ai = TF.active_index_from_bools(act, TSM.padded_active_count(int(act.sum()), D_OUT))
    x = _t(rng.standard_normal((9, D_IN)).astype(np.float32))
    for dtype, takes, refuses in ((torch.bfloat16, (2, 16, 128), (3, 256)),
                                  (torch.float32, (2, 8, 32), (3, 16, 64, 128))):
        assert TSM.TILED_ROWS[dtype] in TSM.STRUCTURED_ROWS[dtype]
        xd, wd = x.to(dtype), w.to(dtype)
        want = TSM.structured_matmul(xd, wd, ai)
        for tile in takes:
            assert torch.equal(TSM.structured_matmul(xd, wd, ai, block_b=tile), want)
        for tile in refuses:
            with pytest.raises(ValueError, match="block_b"):
                TSM.structured_matmul(xd, wd, ai, block_b=tile)


def test_wrappers_take_the_plain_version_only_on_the_cpu(monkeypatch):
    """A tensor that is not on the CPU launches its kernel or raises; on the
    meta device (the dry run's) it gets the kernel's output shape and dtype
    with nothing run: never the plain version, and no launch counted."""
    meta = dict(device="meta")
    x = torch.zeros((2, 8), **meta)
    vals = torch.zeros((3, 2), **meta)
    idx = torch.zeros((3, 2), dtype=torch.int32, **meta)
    oi = torch.zeros((3,), dtype=torch.int32, **meta)
    w = torch.zeros((8, 5), **meta)
    ai = torch.zeros((4,), dtype=torch.int32, **meta)
    counters = (TSM.condensed_over_active_matmul, TSM.structured_matmul,
                TSM.structured_matmul_prefetch)
    before = [f.launches for f in counters]

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    for name in ("condensed_over_active_matmul_ref", "structured_matmul_ref"):
        monkeypatch.setattr(TSM.ref, name, plain)
    for call in (lambda: TSM.condensed_over_active_matmul(x, vals, idx, oi, 5),
                 lambda: TSM.condensed_over_active_matmul_decode(x, vals, idx, oi, 5),
                 lambda: TSM.structured_matmul(x, w, ai),
                 lambda: TSM.structured_matmul(x, w, ai, prefetch_gather=True),
                 lambda: TSM.structured_matmul_pregathered(x, w[:, :4].contiguous(), ai, 5)):
        y = call()
        assert y.device.type == "meta" and tuple(y.shape) == (2, 5) and y.dtype == x.dtype
    assert [f.launches for f in counters] == before


def test_coa_block_b_is_what_each_dtype_takes():
    """K4 and K2-coa take K1's batch tiles (``GATHER_ROWS``): bfloat16 1 to
    128 rows, float32 1 to 8; each refuses the others, and on the CPU every
    tile gives the plain version."""
    xs, vals, idx, oi, _ = _coa_inputs(9, seed=12)
    q = _t(np.clip(np.round(vals * 100), -127, 127).astype(np.int8))
    s = torch.full((vals.shape[0],), 0.01)
    for dtype, takes, refuses in ((torch.bfloat16, (1, 4, 32, 128), (3, 256)),
                                  (torch.float32, (1, 4, 8), (3, 16, 128))):
        args = (_t(xs).to(dtype), _t(vals).to(dtype), _t(idx), _t(oi), D_OUT)
        qargs = (args[0], q, _t(idx), _t(oi), D_OUT)
        want = TSM.condensed_over_active_matmul(*args)
        want_q = TSM.condensed_over_active_matmul(*qargs, scales=s)
        for tile in takes:
            assert torch.equal(TSM.condensed_over_active_matmul(*args, block_b=tile), want)
            assert torch.equal(TSM.condensed_over_active_matmul(*qargs, scales=s, block_b=tile),
                               want_q)
        for tile in refuses:
            with pytest.raises(ValueError, match="block_b"):
                TSM.condensed_over_active_matmul(*args, block_b=tile)
