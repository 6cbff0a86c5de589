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
    """Decode, the tiled launch's default tile, its smallest tile and a
    tile of 2 compute one function; on the CPU each is the plain version."""
    x, values, idx = _inputs(6, seed=11)
    decode = _torch(TCM.condensed_matmul_decode, x, values, idx, dtype)
    tdt = getattr(torch, dtype)
    for tile in (2, TCM.TILED_ROWS[tdt], TCM.GATHER_ROWS[tdt][0]):
        tiled = _torch(TCM.condensed_matmul, x, values, idx, dtype, block_b=tile)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_adds_duplicate_indices(dtype):
    """The kernels' contract allows a row to index one input twice: the
    plain version adds both products, as the reference's Pallas kernel does
    (the bf16 kernel computes such a row by its slot chain, never by one
    dense entry)."""
    x, values, idx = _inputs(9, seed=13)
    idx[:, 1] = idx[:, 0]
    idx[5, 2:6] = idx[5, 0]  # a row with five slots at one input
    want = _jax(x, values, idx, dtype)
    got = _torch(TCM.condensed_matmul, x, values, idx, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    tdt = getattr(torch, dtype)
    xs = torch.from_numpy(x).to(tdt).float().numpy().astype(np.float64)
    vs = torch.from_numpy(values).to(tdt).float().numpy().astype(np.float64)
    formula = np.einsum("bnk,nk->bn", xs[:, idx], vs)  # every slot's product, added
    np.testing.assert_allclose(got, formula, **TOL[dtype])
    np.testing.assert_array_equal(_torch(TREF.condensed_matmul_ref, x, values, idx, dtype), got)


GEOMETRY_D_IN = [1, 63, 64, 65, 511, 512, 513, 1000, 1001, 2048, 6144, 8192, 14336,
                 40_000, 116_224, 1_000_000]


@pytest.mark.parametrize("d_in", GEOMETRY_D_IN)
def test_gather_geometry_depends_on_d_in_and_the_dtype_only(d_in):
    """bfloat16: d_in in at most 8 splits of a multiple of 64 inputs (one
    cluster adds them in order), none empty; gather_mma takes the most
    neurons a block (64, 32 or 16) whose panel holds a whole split within
    227 KB at 128 batch rows, else 16 neurons and the split in the fewest
    passes that fit (so any d_in runs, past the 116,224 inputs of one
    staged x row). The launch arguments take the split unchanged at every
    batch, tile and row count, so each output's chain is one at every
    launch. float32: one chain over the row's slots."""
    bf16 = torch.bfloat16
    geo = TCM.gather_geometry(d_in, bf16)
    assert (geo.splits - 1) * geo.split_rows < d_in <= geo.splits * geo.split_rows
    assert geo.split_rows % TCM.CHUNK_ROWS == 0 and 1 <= geo.splits <= TCM.MAX_SPLITS
    assert geo.block_neurons in TCM.NEURON_TILES
    assert geo.pass_rows % TCM.CHUNK_ROWS == 0
    assert geo.passes == -(-geo.split_rows // geo.pass_rows)
    assert geo.smem_bytes == TCM.mma_smem_bytes(128, geo.block_neurons, geo.pass_rows,
                                                 geo.passes) <= TCM.SMEM_BYTES
    if geo.passes == 1:
        assert geo.pass_rows == geo.split_rows
        wider = [n for n in TCM.NEURON_TILES if n > geo.block_neurons]
        assert all(TCM.mma_smem_bytes(128, n, geo.split_rows) > TCM.SMEM_BYTES for n in wider)
    else:  # no neuron tile holds the split; one pass fewer does not fit
        assert geo.block_neurons == 16
        assert TCM.mma_smem_bytes(128, 16, geo.split_rows) > TCM.SMEM_BYTES
        fewer = -(-geo.split_rows // (geo.passes - 1) // TCM.CHUNK_ROWS) * TCM.CHUNK_ROWS
        assert TCM.mma_smem_bytes(128, 16, fewer, geo.passes - 1) > TCM.SMEM_BYTES
    # an outbox entry: 16 bits of value, the input in the pass, the row
    rows = -(-geo.block_neurons // geo.splits)
    assert rows.bit_length() + (geo.pass_rows - 1).bit_length() <= 17
    for b in (1, 3, 8, 100, 128, 512):
        x = torch.zeros((b, d_in), dtype=bf16)
        for n_rows in (1, 777, 6144):
            for tile in TCM.GATHER_ROWS[bf16]:
                args = TCM.launch_args(x, n_rows, tile, 132)
                if tile <= 8 and geo.decode_loads:
                    neurons = 8 if -(-n_rows // 8) <= 132 else 16
                    assert args == (tile, 0, geo.split_rows, 0, neurons, geo.decode_loads)
                else:
                    assert args == (tile, 0, geo.split_rows, geo.pass_rows,
                                    geo.block_neurons, 0)
    if d_in * 4 <= TCM.SMEM_BYTES:  # float32 stages one x row whole
        f32 = TCM.gather_geometry(d_in, torch.float32)
        assert (f32.split_rows, f32.splits, f32.block_neurons) == (d_in, 1, None)
        assert f32.smem_bytes <= TCM.SMEM_BYTES


def test_gather_geometry_at_the_main_path_widths():
    """qwen3-1.7b: wo, w_gate and w_up take d_in 2048, w_down 6144; past d_in
    6656 the decode launch runs gather_mma, and past about 36k gather_mma
    builds each split's panel in passes."""
    bf16 = torch.bfloat16
    assert TCM.gather_geometry(2048, bf16)[:3] == (256, 8, 64)
    assert TCM.gather_geometry(6144, bf16)[:3] == (768, 8, 64)
    # ring 3 x 128 rows x 144 B, panel 64 x (512 + 16) B, outbox (5120 + 32)
    # x 4 B, bitmaps 64 rows x 8 words, two flags a neuron, 4 x 8 counts, 8
    # warps' places and packed counts: two blocks an SM (228 KB, 1 KB each
    # reserved)
    smem = 55296 + 33792 + 20608 + 2048 + 512 + 128 + 384
    assert TCM.gather_geometry(2048, bf16).smem_bytes == smem <= 233_472 // 2 - 1024
    # the decode kernel: 16 rows over all of d_in, then a scratch for the
    # bitmaps (16 rows of d_in bits), the warps' x buffers (8 warps x 1 KB)
    # and the partial tiles (4 KB), whichever is larger, then a flag a row:
    # three blocks an SM at d_in 2048, with 20 slot loads a thread; one at
    # 6144, with 40
    assert TCM.gather_geometry(2048, bf16).decode_smem_bytes == 16 * 4112 + 8192 + 64
    assert 3 * (16 * 4112 + 8192 + 64) <= TCM.THREE_BLOCKS_SMEM
    assert TCM.gather_geometry(2048, bf16).decode_loads == 20
    assert TCM.gather_geometry(6144, bf16).decode_smem_bytes == 16 * 12304 + 12288 + 64
    assert TCM.gather_geometry(6144, bf16).decode_loads == 40
    assert TCM.gather_geometry(2048, bf16).passes == TCM.gather_geometry(6144, bf16).passes == 1
    assert TCM.gather_geometry(8192, bf16).decode_smem_bytes is None  # the cluster decodes
    # d_in 40000: splits of 5056 inputs, 16 neurons, two passes of 2560, each
    # thread's 8 accumulators stashed between them
    wide = TCM.gather_geometry(40_000, bf16)
    assert (wide.split_rows, wide.splits, wide.block_neurons) == (5056, 8, 16)
    assert (wide.pass_rows, wide.passes, wide.decode_loads) == (2560, 2, None)
    assert wide.smem_bytes == 55296 + 16 * 5136 + 20608 + 16 * 80 * 4 + 128 + 512 + 8192


@pytest.mark.parametrize("d_in", [2048, 6144, 1000, 1001, 40_000, 40_001])
def test_gather_shared_memory_fits_at_every_main_path_and_ragged_shape(d_in):
    """Every batch tile a bfloat16 launch takes (decode's 1-8 rows, the
    tiled 128 and all between) fits the 227 KB a block may opt into, and
    the partial tile of the split sum fits the x ring and the panel it
    replaces; the decode kernel fits where the geometry gives it; float32's
    x tile fits too."""
    geo = TCM.gather_geometry(d_in, torch.bfloat16)
    for tile in TCM.GATHER_ROWS[torch.bfloat16]:
        smem = TCM.mma_smem_bytes(tile, geo.block_neurons, geo.pass_rows, geo.passes)
        assert smem <= geo.smem_bytes <= TCM.SMEM_BYTES
        rows = -(-tile // 8) * 8
        ring = TCM.RING_STAGES * rows * TCM.X_ROW_BYTES
        panel = geo.block_neurons * (2 * geo.pass_rows + 16)
        assert rows * (geo.block_neurons + 4) * 4 <= ring + panel
    if geo.decode_smem_bytes is not None:  # one block holds every split
        assert geo.decode_smem_bytes == TCM.decode_smem_bytes(geo.split_rows, geo.splits)
        assert geo.decode_smem_bytes <= TCM.SMEM_BYTES
    else:
        assert d_in > 6656
    for tile in TCM.GATHER_ROWS[torch.float32]:
        assert TCM._fit_rows(tile, d_in, 4) * d_in * 4 <= TCM.SMEM_BYTES


def test_block_b_is_what_each_dtype_takes():
    """bfloat16 takes batch tiles of 1 to 128 rows, float32 1 to 8; each
    refuses the others, with codes too, and on the CPU every tile gives the
    plain version."""
    x, values, idx = (torch.from_numpy(a) for a in _inputs(9, seed=12))
    q = values.mul(100).round().clamp(-127, 127).to(torch.int8)
    s = torch.full((N_OUT,), 0.01)
    for dtype, takes, refuses in ((torch.bfloat16, (1, 2, 16, 128), (3, 256)),
                                  (torch.float32, (1, 2, 8), (3, 16, 128))):
        assert TCM.TILED_ROWS[dtype] == TCM.GATHER_ROWS[dtype][-1]
        xd, vd = x.to(dtype), values.to(dtype)
        want = TCM.condensed_matmul(xd, vd, idx)
        want_q = TCM.condensed_matmul(xd, q, idx, scales=s)
        for tile in takes:
            assert torch.equal(TCM.condensed_matmul(xd, vd, idx, block_b=tile), want)
            assert torch.equal(TCM.condensed_matmul(xd, q, idx, scales=s, block_b=tile), want_q)
        for tile in refuses:
            with pytest.raises(ValueError, match="block_b"):
                TCM.condensed_matmul(xd, vd, idx, block_b=tile)
            with pytest.raises(ValueError, match="block_b"):
                TCM.condensed_matmul(xd, q, idx, scales=s, block_b=tile)

