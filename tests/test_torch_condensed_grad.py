"""The differentiable condensed formats against the JAX reference.

* K3's plain version (``ref.condensed_matmul_dw_ref``, what the wrapper
  runs on the CPU) against the reference's Pallas kernel in interpret mode
  (``repro.kernels.condensed_matmul.condensed_matmul_dw``): shapes that are
  no multiple of a tile, duplicate indices, bf16 inputs giving float32.
  rtol 1e-5, atol 1e-5 * max|dw|: the two sum the batch in other orders in
  float32 (bf16 products are exact in float32).
* ``ops.condensed_linear`` / ``condensed_over_active_linear`` (the
  ``torch.autograd.Function``s) against ``jax.grad`` through the
  reference's custom VJPs: y, dx and dw within rtol 1e-5, atol 1e-6.
* The values gradient of ``loss_fn`` over the smoke model's condensed (and
  condensed-over-active) serving tree against the reference's, and against
  the masked loss's dense weight gradient gathered at the condensed
  indices (the identity the card's ``[grad]`` phase checks at full width):
  atol 1e-6 (float32; max |g| is ~0.02 here).
* The same in bfloat16, against the reference's bf16 gradients. The
  Functions: y and dvalues within one bf16 ulp (rtol 2**-7; both sum in
  float32 and round once), dx within 2**-6 of its max (both scatter-add in
  bf16, in other orders). ``loss_fn``'s values gradient: atol 3e-2 of the
  reference's max |g| (bf16 rounding through the model: here each
  framework's bf16 gradient lies up to 2.9e-2 of the max from the float32
  one, and the two up to 1.8e-2 from each other).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import condensed_matmul as jcm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import condensed as JC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import condensed_matmul as tcm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402

from _torch_smoke_model import smoke_masks, smoke_model  # noqa: E402

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 and back (exact in both frameworks)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("b,d_in,n_out,k,dtype", [
    (13, 37, 11, 5, "float32"), (9, 64, 40, 13, "float32"), (21, 50, 7, 50, "float32"),
    (13, 37, 11, 5, "bfloat16"), (33, 24, 19, 9, "bfloat16")])
def test_dw_plain_version_matches_the_reference_kernel(b, d_in, n_out, k, dtype):
    rng = np.random.default_rng(b * 100 + k)
    dy = rng.standard_normal((b, n_out)).astype(np.float32)
    x = rng.standard_normal((b, d_in)).astype(np.float32)
    idx = rng.integers(0, d_in, size=(n_out, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # duplicate indices: each slot gets its own entry
    if dtype == "bfloat16":
        dy, x = _bf16(dy), _bf16(x)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jcm.condensed_matmul_dw(jnp.asarray(dy, jdt), jnp.asarray(x, jdt),
                                              jnp.asarray(idx), interpret=True))
    assert want.dtype == np.float32
    tdt = getattr(torch, dtype)
    got = tcm.condensed_matmul_dw(torch.from_numpy(dy).to(tdt), torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (n_out, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert torch.equal(got[:, 0], got[:, 1])
    assert tcm.condensed_matmul_dw.launches == 0  # the CPU takes the plain version


def test_dw_wrapper_refuses_what_the_kernel_does_not_take():
    dy, x = torch.zeros(4, 3), torch.zeros(4, 8)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tcm.condensed_matmul_dw(dy, x, idx.long())
    with pytest.raises(TypeError, match="must both be float32 or bfloat16"):
        tcm.condensed_matmul_dw(dy, x.to(torch.bfloat16), idx)
    with pytest.raises(ValueError, match="need dy"):
        tcm.condensed_matmul_dw(dy[:, :2], x, idx)
    # the meta device (the dry run's) gets the gradient's shape, run by nothing
    got = tcm.condensed_matmul_dw(dy.to("meta"), x.to("meta"), idx.to("meta"))
    assert got.device.type == "meta" and got.shape == (3, 2) and got.dtype == torch.float32


# K3's launch plan (``dw_plan``) on a 132-SM card at qwen3-1.7b's training
# stacks (wo, w_gate/w_up, w_down), full rows and the 50%-ablated rows:
# (d_in, rows) -> bf16 ring stages
_K3_PLANS = [
    ((2048, 2048), 3), ((2048, 1024), 4), ((2048, 6144), 3), ((2048, 3072), 3),
    ((6144, 2048), 3), ((6144, 1024), 3),
]


@pytest.mark.parametrize("shape,stages", _K3_PLANS, ids=lambda v: str(v))
def test_dw_plan_at_the_training_stacks(shape, stages):
    d_in, n_out = shape
    tiles_i, tiles_j = -(-d_in // 128), -(-n_out // 128)
    # a block per 128 x 128 tile in both routes; four stages where the tiles
    # leave an SM one block at most
    p = tcm.dw_plan(d_in, n_out, torch.bfloat16, 132)
    assert (p.route, p.grid, p.stages) == ("mma", (tiles_j, tiles_i), stages)
    assert (stages == 4) == (tiles_i * tiles_j <= 132)
    assert tcm.dw_plan(d_in, n_out, torch.float32, 132) == ("f32", (tiles_j, tiles_i), None)


@pytest.mark.parametrize("sm_count", [1, 8, 66, 132, 264, 100_000])
@pytest.mark.parametrize("d_in,n_out", [(1000, 777), (6102, 777), (64, 9), (6144, 2048),
                                        (2048, 6144), (300, 256), (50_000, 4096), (129, 1)])
def test_dw_plan_covers_the_batch_and_the_tiles(sm_count, d_in, n_out):
    """Every input and neuron lies in one tile of the grid; the 4-stage ring
    only where the tiles leave each SM one block at most."""
    p = tcm.dw_plan(d_in, n_out, torch.bfloat16, sm_count)
    tiles_j, tiles_i = p.grid
    assert (tiles_i - 1) * 128 < d_in <= tiles_i * 128
    assert (tiles_j - 1) * 128 < n_out <= tiles_j * 128
    assert p.stages == (4 if tiles_i * tiles_j <= sm_count else 3)
    q = tcm.dw_plan(d_in, n_out, torch.float32, sm_count)
    assert (q.route, q.grid, q.stages) == ("f32", p.grid, None)


def _fan_in_indices(rng, d_in, n_out, k, shuffled=True):
    """Constant fan-in indices, k distinct of d_in per row (k <= d_in), each
    row's order random (or ascending)."""
    idx = np.argsort(rng.random((n_out, d_in)), axis=1)[:, :k]
    return (idx if shuffled else np.sort(idx, axis=1)).astype(np.int32)


def _dw_tile_emulation(dy, x, idx, plan):
    """K3 as its tile kernels compute it: block (bj, t) of plan.grid owns
    neurons N = [128 bj, +128) and inputs I = [128 t, +128) and writes the
    slots of N's rows whose index lies in I, dw[n, s] = G[index - 128 t, n -
    128 bj]. bfloat16 (dw_kernel_mma): G = x[:, I]^T dy[:, N] in float32.
    float32 (dw_kernel_f32): G summed a batch row at a time, in order.
    Returns dw and how often each slot was written."""
    n_out, k = idx.shape
    dw = torch.full((n_out, k), float("nan"))
    writes = torch.zeros((n_out, k), dtype=torch.int64)
    tile = idx.long() // 128
    for bj in range(plan.grid[0]):
        rows = slice(bj * 128, (bj + 1) * 128)
        for t in range(plan.grid[1]):
            xi, dn = x[:, t * 128:(t + 1) * 128].float(), dy[:, rows].float()
            if plan.route == "mma":
                g = xi.T @ dn
            else:
                g = torch.zeros((xi.shape[1], dn.shape[1]))
                for b in range(x.shape[0]):
                    g += xi[b][:, None] * dn[b][None, :]
            n, s = torch.nonzero(tile[rows] == t, as_tuple=True)
            dw[rows][n, s] = g[idx[rows][n, s].long() - t * 128, n]
            writes[rows][n, s] += 1
    return dw, writes


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("b,d_in,n_out,k,shuffled", [
    (100, 1000, 777, 97, True), (37, 300, 130, 50, True), (64, 520, 256, 9, False),
    (100, 6102, 777, 97, True)])
def test_dw_kernel_orders_match_the_plain_version(b, d_in, n_out, k, shuffled, sm_count):
    """The tile-and-gather order of both K3 routes, emulated at the wrapper's
    plan, against ref.condensed_matmul_dw_ref with duplicate and shuffled
    indices: every slot written once, within rtol 1e-5 and 1e-5 of max |dw|
    (the same products, summed in another order in float32)."""
    rng = np.random.default_rng(b + d_in + sm_count)
    idx = torch.from_numpy(_fan_in_indices(rng, d_in, n_out, k, shuffled))
    idx[:, 1] = idx[:, 0]  # duplicate indices: each slot gets its own entry
    for dtype in (torch.bfloat16, torch.float32):
        dy = torch.from_numpy(rng.standard_normal((b, n_out)).astype(np.float32)).to(dtype)
        x = torch.from_numpy(rng.standard_normal((b, d_in)).astype(np.float32)).to(dtype)
        want = tcm.condensed_matmul_dw(dy, x, idx)  # the CPU: the plain version
        got, writes = _dw_tile_emulation(dy, x, idx, tcm.dw_plan(d_in, n_out, dtype, sm_count))
        assert bool((writes == 1).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        assert torch.equal(got[:, 0], got[:, 1])
    assert tcm.condensed_matmul_dw.launches == 0


# what one launch of K3 takes on the card (tcm.dw_limits(), which asks the
# compiled kernel): fewer than 2**21 slots a row, at most 3632 d_in tiles
CARD_LIMITS = ((1 << 21) - 1, 3632 * 128)


@pytest.mark.parametrize("d_in,k,limits,n_pieces", [
    (2048, 293, CARD_LIMITS, (1, 1)), (6144, 585, CARD_LIMITS, (1, 1)),
    (28672, 2048, CARD_LIMITS, (1, 1)), (500_000, 5, CARD_LIMITS, (1, 2)),
    (64, 1 << 21, CARD_LIMITS, (2, 1)), (1000, 97, (40, 256), (3, 4)),
    (1000, 97, (40, 100), (3, 8))])
def test_dw_pieces_cover_the_shape_within_the_limits(d_in, k, limits, n_pieces):
    """K3's piece planner: slot slices and d_in chunks that cover the shape,
    each within one launch's limits, every chunk on a whole 128-input tile
    (a limit below one tile still takes a tile); one piece at the shapes of
    the configs."""
    pieces = tcm.dw_pieces(d_in, k, limits)
    assert (len(pieces.slots), len(pieces.inputs)) == n_pieces
    for ranges, total, most in ((pieces.slots, k, limits[0]),
                                (pieces.inputs, d_in, max(128, limits[1] // 128 * 128))):
        assert ranges[0][0] == 0 and ranges[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(0 < stop - start <= most for start, stop in ranges)
    assert all(start % 128 == 0 for start, _ in pieces.inputs)


@pytest.mark.parametrize("limits", [(40, 256), (97, 300), (13, 1000)])
def test_dw_in_pieces_is_bitwise_one_launch(limits):
    """K3 run on pieces (``_dw_in_pieces``, each piece emulated as its tile
    kernel computes it) equals one launch over the whole shape bitwise, in
    both routes, with duplicate and shuffled indices; on the CPU the wrapper
    takes the plain version whatever the limits."""
    b, d_in, n_out, k = 37, 1000, 130, 97
    rng = np.random.default_rng(limits[0])
    idx = torch.from_numpy(_fan_in_indices(rng, d_in, n_out, k))
    idx[:, 1] = idx[:, 0]
    pieces = tcm.dw_pieces(d_in, k, limits)
    for dtype in (torch.bfloat16, torch.float32):
        dy = torch.from_numpy(rng.standard_normal((b, n_out)).astype(np.float32)).to(dtype)
        x = torch.from_numpy(rng.standard_normal((b, d_in)).astype(np.float32)).to(dtype)

        def launch(dy_, x_, idx_):
            plan = tcm.dw_plan(x_.shape[1], idx_.shape[0], dtype, 132)
            return _dw_tile_emulation(dy_, x_, idx_, plan)[0]
        assert torch.equal(tcm._dw_in_pieces(dy, x, idx, pieces, launch), launch(dy, x, idx))
        assert torch.equal(tcm.condensed_matmul_dw(dy, x, idx, limits=limits),
                           tcm.condensed_matmul_dw(dy, x, idx))
    assert tcm.condensed_matmul_dw.launches == 0


def _jgrad_and_tgrad(jfn, tfn, x, values, cot):
    """(y, dx, dvalues) of sum(f(x, values) * cot) in both frameworks."""
    jy, jvjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(values))
    jdx, jdv = jvjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_()
    tv = torch.from_numpy(values).requires_grad_()
    ty = tfn(tx, tv)
    ty.backward(torch.from_numpy(cot))
    for j, t in ((jy, ty), (jdx, tx.grad), (jdv, tv.grad)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **GRAD_TOL)
    return tx.grad, tv.grad


def _condensed_case(rng):
    b, d_in, n_out, k = 6, 30, 17, 7
    x = rng.standard_normal((b, d_in)).astype(np.float32)
    values = rng.standard_normal((n_out, k)).astype(np.float32)
    idx = rng.integers(0, d_in, size=(n_out, k)).astype(np.int32)
    cot = rng.standard_normal((b, n_out)).astype(np.float32)
    return (lambda x_, v_: jops.condensed_linear(x_, v_, jnp.asarray(idx)),
            lambda x_, v_: tops.condensed_linear(x_, v_, torch.from_numpy(idx)),
            x, values, cot)


def _condensed_over_active_case(rng):
    b, d_in, d_out, a, k = 5, 24, 20, 9, 6
    x = rng.standard_normal((b, d_in)).astype(np.float32)
    values = rng.standard_normal((a, k)).astype(np.float32)
    idx = rng.integers(0, d_in, size=(a, k)).astype(np.int32)
    out_index = np.sort(rng.choice(d_out, size=a, replace=False)).astype(np.int32)
    out_index[-2:] = d_out
    values[-2:] = 0.0
    cot = rng.standard_normal((b, d_out)).astype(np.float32)
    return (lambda x_, v_: jops.condensed_over_active_linear(
                x_, v_, jnp.asarray(idx), jnp.asarray(out_index), d_out),
            lambda x_, v_: tops.condensed_over_active_linear(
                x_, v_, torch.from_numpy(idx), torch.from_numpy(out_index), d_out),
            x, values, cot)


def test_condensed_linear_function_matches_the_reference_vjp():
    _jgrad_and_tgrad(*_condensed_case(np.random.default_rng(0)))


def test_condensed_over_active_function_matches_the_reference_vjp():
    # two padding rows: zero cotangent, zero gradient
    _, dv = _jgrad_and_tgrad(*_condensed_over_active_case(np.random.default_rng(1)))
    assert not dv[-2:].any()


@pytest.mark.parametrize("case", [_condensed_case, _condensed_over_active_case],
                         ids=["condensed", "condensed_over_active"])
def test_functions_in_bf16_match_the_reference_vjp(case):
    jfn, tfn, x, values, cot = case(np.random.default_rng(2))
    jy, jvjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16), jnp.asarray(values, jnp.bfloat16))
    jdx, jdv = jvjp(jnp.asarray(cot, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tv = torch.from_numpy(values).to(torch.bfloat16).requires_grad_()
    ty = tfn(tx, tv)
    ty.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert ty.dtype == tx.grad.dtype == tv.grad.dtype == torch.bfloat16
    got = {n: t.detach().float().numpy() for n, t in (("y", ty), ("dx", tx.grad),
                                                        ("dv", tv.grad))}
    want = {n: np.asarray(j.astype(jnp.float32)) for n, j in (("y", jy), ("dx", jdx),
                                                              ("dv", jdv))}
    for n in ("y", "dv"):
        np.testing.assert_allclose(got[n], want[n], rtol=2**-7, atol=0, err_msg=n)
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=0,
                               atol=2**-6 * np.abs(want["dx"]).max())


def test_scaled_values_refuse_a_gradient():
    x = torch.randn(3, 8, requires_grad=True)
    q = torch.ones(4, 2, dtype=torch.int8)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="inference-only"):
        tops.condensed_linear_nd(x, q, idx, scales=torch.ones(4))
    with torch.no_grad():
        assert tops.condensed_linear_nd(x, q, idx, scales=torch.ones(4)).shape == (3, 4)


def _batch(cfg, seed=0, b=2, t=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("path", ["condensed", "condensed_over_active"])
def test_loss_values_gradient_matches_the_reference_and_the_gathered_dense_grad(path):
    m = smoke_model()
    jmasks = smoke_masks()["plain" if path == "condensed" else "ablated"]
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    export = {"condensed": (JC.export_condensed, TC.export_condensed),
              "condensed_over_active": (JC.export_condensed_over_active,
                                        TC.export_condensed_over_active)}[path]
    batch = _batch(tcfg)
    jtree = export[0](jcfg, m["jreg"], m["jparams"], jmasks)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jg = jax.value_and_grad(lambda t: JM.loss_fn(jcfg, m["jparams"], t, jbatch)[0],
                                   allow_int=True)(jtree)

    tmasks = bridge.from_jax_numpy(jax.tree.map(np.asarray, jmasks))
    ttree = export[1](tcfg, m["treg"], m["tparams"], tmasks)
    for s in m["treg"]:
        ttree["blocks"][s.path[-1]].values.requires_grad_()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = TM.loss_fn(tcfg, m["tparams"], ttree, tbatch)[0]
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)

    # the masked loss's dense gradient, gathered at the condensed indices
    params = {k: v for k, v in m["tparams"].items()}
    params["blocks"] = {k: v.detach().clone().requires_grad_() for k, v in
                        m["tparams"]["blocks"].items()}
    mloss = TM.loss_fn(tcfg, params, tmasks, tbatch)[0]
    mloss.backward()
    np.testing.assert_allclose(mloss.item(), tloss.item(), rtol=1e-6)
    for s in m["treg"]:
        name = s.path[-1]
        leaf = ttree["blocks"][name]
        got = leaf.values.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg["blocks"][name].values), **GRAD_TOL,
                                   err_msg=name)
        dense = params["blocks"][name].grad                        # (L, d_in, d_out)
        cols = (torch.arange(s.d_out)[None, :, None].expand(*leaf.indices.shape)
                if path == "condensed" else leaf.out_index.long()[..., None]
                .clamp(max=s.d_out - 1).expand(*leaf.indices.shape))
        gathered = dense[torch.arange(s.lead[0])[:, None, None], leaf.indices.long(), cols]
        if path == "condensed_over_active":
            gathered = gathered * (leaf.out_index < s.d_out)[..., None]
        np.testing.assert_allclose(got, gathered.numpy(), **GRAD_TOL, err_msg=name)
        assert np.abs(got).max() > 1e-4  # a real gradient, not zeros


@pytest.mark.parametrize("path", ["condensed", "condensed_over_active"])
def test_loss_values_gradient_in_bf16_matches_the_reference(path):
    m = smoke_model()
    jmasks = smoke_masks()["plain" if path == "condensed" else "ablated"]
    jcfg, tcfg = m["jcfg"].replace(dtype="bfloat16"), m["tcfg"].replace(dtype="bfloat16")
    export = {"condensed": (JC.export_condensed, TC.export_condensed),
              "condensed_over_active": (JC.export_condensed_over_active,
                                        TC.export_condensed_over_active)}[path]
    batch = _batch(tcfg)
    jtree = export[0](jcfg, m["jreg"], m["jparams"], jmasks)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jg = jax.value_and_grad(lambda t: JM.loss_fn(jcfg, m["jparams"], t, jbatch)[0],
                                   allow_int=True)(jtree)
    ttree = export[1](tcfg, m["treg"], m["tparams"],
                      bridge.from_jax_numpy(jax.tree.map(np.asarray, jmasks)))
    for s in m["treg"]:
        ttree["blocks"][s.path[-1]].values.requires_grad_()
    tloss = TM.loss_fn(tcfg, m["tparams"], ttree, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})[0]
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    for s in m["treg"]:
        name = s.path[-1]
        grad = ttree["blocks"][name].values.grad
        assert grad.dtype == torch.bfloat16
        want = np.asarray(jg["blocks"][name].values.astype(jnp.float32))
        np.testing.assert_allclose(grad.float().numpy(), want, rtol=0,
                                   atol=3e-2 * np.abs(want).max(), err_msg=name)
        assert np.abs(want).max() > 1e-4  # a real gradient, not zeros
