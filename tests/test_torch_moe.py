"""The MoE layer and the expert-grouped condensed launch against the JAX
reference on the CPU, at smoke widths.

* ``route_topk``: dispatch exactly, combine and the aux loss within 1e-6,
  on random logits and on logits with exact ties (``jax.lax.top_k`` picks
  the lower index first, and so must the port).
* ``moe_block``: dense, masked and condensed experts, in groups where the
  test asserts that tokens are dropped; float32 within 1e-5.
* The grouped plain version (``ref.condensed_matmul_grouped_ref``, the CPU
  path of K1-moe / K2-moe) equals the per-expert plain K1 / K2 exactly,
  and the reference's ``jax.vmap`` of its Pallas kernel (interpret mode)
  within the kernels' tolerances (float32 atol 1e-5; bfloat16 one ulp).
* Every format's expert leaf runs its expert-grouped launch: condensed
  (K1-moe), condensed_over_active (K4-moe) and structured (K5-moe), each
  expert equal to the one-expert format and the reference's ``jax.vmap``
  of the format's apply; the grouped condensed linear takes gradients.

Inputs are drawn with numpy from fixed seeds.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.kernels import condensed_matmul as JCM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import condensed_matmul as TCM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-2)}


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _tied_logits(rng, g, s, e):
    """Logits whose rows repeat values exactly: each row draws from only
    three distinct values, so every top-k crosses a tie."""
    levels = rng.standard_normal((g, s, 3)).astype(np.float32)
    pick = rng.integers(0, 3, (g, s, e))
    return np.take_along_axis(levels, pick, axis=-1)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "exact-ties"])
@pytest.mark.parametrize("g,s,e,k,cap", [(1, 64, 4, 2, 40), (2, 64, 8, 2, 20),
                                         (3, 16, 32, 8, 5), (1, 8, 32, 8, 8),
                                         (2, 12, 6, 3, 2)])
def test_route_topk_matches_the_reference(g, s, e, k, cap, tied):
    rng = np.random.default_rng(g * 100 + s + e + k)
    logits = _tied_logits(rng, g, s, e) if tied else rng.standard_normal((g, s, e)).astype(
        np.float32)
    jd, jc, ja = JMOE.route_topk(jnp.asarray(logits), k, cap)
    td, tc, ta = TMOE.route_topk(torch.from_numpy(logits), k, cap)
    assert td.dtype == torch.bool and tc.dtype == torch.float32 and ta.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 3), (32, 8), (384, 8)])
def test_top_k_breaks_ties_by_the_lower_index(e, k):
    """Every value repeated: the order and the indices of jax.lax.top_k."""
    rng = np.random.default_rng(e)
    probs = rng.integers(0, 4, (16, e)).astype(np.float32) / 4
    probs[0] = 0.5  # one row all equal
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tv, ti = TMOE.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.arange(k))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group", [1, 2, 4, 8, 64, 128, 2048, 4096])
def test_capacity_is_the_reference_formula(arch, group):
    cfg = TC.get_config(arch)
    e, k = cfg.n_experts, cfg.top_k_experts
    want = min(group, max(-(-group * k * int(100 * cfg.capacity_factor) // (100 * e)), k))
    assert TMOE.capacity_for(cfg, group) == want
    if group <= 8:  # a decode group: capacity == the group, nothing dropped
        assert want == group


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _fan_in_mask(rng, e, d_in, d_out, k):
    m = np.zeros((e, d_in, d_out), bool)
    for i in range(e):
        for n in range(d_out):
            m[i, rng.choice(d_in, k, replace=False), n] = True
    return m


def _block_inputs(arch, seed, skew: bool):
    """Smoke-width router, experts and masks (fan-in d/4), x (4, 32, d).
    ``skew`` makes expert 0 every token's first choice, so a group of 64
    overflows its capacity."""
    cfg = JC.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    ws = [(rng.standard_normal(shape) / np.sqrt(shape[1] / 4)).astype(np.float32)
          for shape in ((e, d, ff), (e, d, ff), (e, ff, d))]
    masks = [_fan_in_mask(rng, e, w.shape[1], w.shape[2], w.shape[1] // 4) for w in ws]
    x = rng.standard_normal((4, 32, d)).astype(np.float32)
    if skew:
        x[..., 0] = 4.0
        router[0] = 0.0
        router[0, 0] = 4.0
    return cfg, router, ws, masks, x


def _dropped(cfg, router, x, group):
    """Tokens' choices the reference's routing drops (over capacity)."""
    n = x.shape[0] * x.shape[1]
    gs = min(group, n)
    cap = TMOE.capacity_for(cfg, gs)
    logits = jnp.asarray(x.reshape(n // gs, gs, -1)) @ jnp.asarray(router)
    dispatch, _, _ = JMOE.route_topk(logits, cfg.top_k_experts, cap)
    return n * cfg.top_k_experts - int(np.asarray(dispatch).sum())


@pytest.mark.parametrize("kind", ["dense", "masked", "condensed"])
@pytest.mark.parametrize("arch,skew", [("granite-moe-1b-a400m", True),
                                       ("granite-moe-1b-a400m", False),
                                       ("kimi-k2-1t-a32b", True)])
def test_moe_block_matches_the_reference(arch, skew, kind):
    cfg_j, router, ws, masks, x = _block_inputs(arch, 7, skew)
    cfg_t = TC.get_smoke_config(arch)
    if skew:
        assert _dropped(cfg_j, router, x, cfg_j.moe_group_size) > 0
    jp = JMOE.MoEParams(jnp.asarray(router), *map(jnp.asarray, ws))
    tp = TMOE.MoEParams(torch.from_numpy(router), *map(torch.from_numpy, ws))
    names = ("w_gate", "w_up", "w_down")
    if kind == "dense":
        jm = tm = None
    elif kind == "masked":
        jm = dict(zip(names, map(jnp.asarray, masks)))
        tm = dict(zip(names, map(torch.from_numpy, masks)))
    else:
        jm = {n: JF.Condensed.export_from_dense(jnp.asarray(w), jnp.asarray(m))
              for n, w, m in zip(names, ws, masks)}
        tm = {n: TF.Condensed.export_from_dense(torch.from_numpy(w), torch.from_numpy(m))
              for n, w, m in zip(names, ws, masks)}
        assert tm["w_gate"].values.shape == (cfg_t.n_experts, cfg_t.d_ff, cfg_t.d_model // 4)
    yj, aj = JMOE.moe_block(cfg_j, jp, jnp.asarray(x), jm, group_size=cfg_j.moe_group_size)
    yt, at = TMOE.moe_block(cfg_t, tp, torch.from_numpy(x), tm,
                            group_size=cfg_t.moe_group_size)
    assert yt.shape == x.shape and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-6)


def test_moe_block_bfloat16_casts_as_the_reference():
    """bf16 x: the router cast to bf16 before its product, the gates
    rounded to bf16 before the combine; within two bf16 ulps of the
    reference, and the same dispatch."""
    cfg_j, router, ws, masks, x = _block_inputs("granite-moe-1b-a400m", 3, False)
    cfg_t = TC.get_smoke_config("granite-moe-1b-a400m")
    names = ("w_gate", "w_up", "w_down")
    jp = JMOE.MoEParams(jnp.asarray(router), *(jnp.asarray(w).astype(jnp.bfloat16) for w in ws))
    tp = TMOE.MoEParams(torch.from_numpy(router), *(torch.from_numpy(w).bfloat16() for w in ws))
    jm = dict(zip(names, map(jnp.asarray, masks)))
    tm = dict(zip(names, map(torch.from_numpy, masks)))
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    yj, _ = JMOE.moe_block(cfg_j, jp, xj, jm, group_size=cfg_j.moe_group_size)
    yt, _ = TMOE.moe_block(cfg_t, tp, xt, tm, group_size=cfg_t.moe_group_size)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj.astype(jnp.float32)), rtol=1.6e-2, atol=2e-2)


def test_moe_block_refuses_a_group_that_does_not_divide_the_tokens():
    cfg = TC.get_smoke_config("granite-moe-1b-a400m")
    _, router, ws, _, _ = _block_inputs("granite-moe-1b-a400m", 0, False)
    tp = TMOE.MoEParams(torch.from_numpy(router), *map(torch.from_numpy, ws))
    with pytest.raises(AssertionError, match="not divisible by group"):
        TMOE.moe_block(cfg, tp, torch.zeros((3, 30, cfg.d_model)), None, group_size=64)


def test_init_moe_params_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    p = TMOE.init_moe_params(g, 64, 32, 4, {"w_gate": 16, "w_up": 16, "w_down": 8},
                             torch.bfloat16, lead=(2,))
    assert p.router.shape == (2, 64, 4) and p.router.dtype == torch.float32
    assert p.w_gate.shape == (2, 4, 64, 32) and p.w_gate.dtype == torch.bfloat16
    assert p.w_down.shape == (2, 4, 32, 64)
    assert abs(p.w_gate.float().std().item() - 16 ** -0.5) < 0.02
    assert abs(p.w_down.float().std().item() - 8 ** -0.5) < 0.03
    assert abs(p.router.std().item() - 64 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# the expert-grouped launch (K1-moe / K2-moe): the plain version
# ---------------------------------------------------------------------------

def _grouped(e, m, d_in, n_out, k, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, m, d_in)).astype(np.float32)
    values = (rng.standard_normal((e, n_out, k)) / np.sqrt(k)).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(d_in, k, replace=False) for _ in range(n_out)])
                    for _ in range(e)]).astype(np.int32)
    dt = getattr(torch, dtype)
    return (x, values, idx), (torch.from_numpy(x).to(dt), torch.from_numpy(values).to(dt),
                              torch.from_numpy(idx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,m,d_in,n_out,k", [(4, 4, 64, 32, 16), (8, 40, 70, 37, 11),
                                               (3, 1, 33, 5, 33)])
def test_grouped_plain_version_is_the_per_expert_k1_and_the_reference_vmap(
        e, m, d_in, n_out, k, dtype):
    (x, v, i), (tx, tv, ti) = _grouped(e, m, d_in, n_out, k, seed=e + m, dtype=dtype)
    got = TCM.condensed_matmul_grouped(tx, tv, ti)
    assert got.shape == (e, m, n_out) and got.dtype == tx.dtype
    for j in range(e):
        assert torch.equal(got[j], TREF.condensed_matmul_ref(tx[j], tv[j], ti[j]))
        assert torch.equal(got[j], TCM.condensed_matmul(tx[j], tv[j], ti[j]))
    jdt = getattr(jnp, dtype)
    want = jax.vmap(JCM.condensed_matmul)(jnp.asarray(x).astype(jdt),
                                          jnp.asarray(v).astype(jdt), jnp.asarray(i))
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), **TOL[dtype])
    # the layer-level wrapper takes x's leading dims whole
    y = TOPS.condensed_linear_grouped(tx.reshape(e, 1, m, d_in), tv, ti)
    assert torch.equal(y.reshape(e, m, n_out), got)


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_scaled_plain_version_is_the_per_expert_k2(dtype, name):
    (x, v, i), (tx, _, ti) = _grouped(4, 6, 48, 24, 12, seed=5, dtype=dtype)
    q, s = TF.quantize_values(torch.from_numpy(v), name)
    assert s.shape == (4, 24)
    got = TCM.condensed_matmul_grouped(tx, q, ti, scales=s)
    for j in range(4):
        assert torch.equal(got[j], TREF.condensed_matmul_scaled_ref(tx[j], q[j], ti[j], s[j]))
        assert torch.equal(got[j], TCM.condensed_matmul(tx[j], q[j], ti[j], scales=s[j]))
    jq, js = JF.quantize_values(jnp.asarray(v), name)
    jdt = getattr(jnp, dtype)
    want = jax.vmap(lambda a, b, c, d: JCM.condensed_matmul(a, b, c, scales=d))(
        jnp.asarray(x).astype(jdt), jq, jnp.asarray(i), js)
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), **TOL[dtype])


def test_grouped_launch_checks_its_operands_and_refuses_gradients():
    """The operand checks; the grouped linear's gradient, refused until its
    backward (K3-moe) was ported, now equals each expert's condensed_linear
    gradient exactly (the quantized codes still refuse one)."""
    _, (tx, tv, ti) = _grouped(2, 3, 16, 8, 4, seed=1)
    with pytest.raises(ValueError, match="need x"):
        TCM.condensed_matmul_grouped(tx[0], tv, ti)
    with pytest.raises(ValueError, match="need x"):
        TCM.condensed_matmul_grouped(tx, tv[:1], ti[:1])
    with pytest.raises(TypeError):
        TCM.condensed_matmul_grouped(tx, tv.double(), ti)
    xg, vg = tx.clone().requires_grad_(), tv.clone().requires_grad_()
    cot = torch.randn((2, 3, 8), generator=torch.Generator().manual_seed(0))
    (TOPS.condensed_linear_grouped(xg, vg, ti) * cot).sum().backward()
    for j in range(2):
        xj, vj = tx[j].clone().requires_grad_(), tv[j].clone().requires_grad_()
        (TOPS.condensed_linear(xj, vj, ti[j]) * cot[j]).sum().backward()
        assert torch.equal(xg.grad[j], xj.grad) and torch.equal(vg.grad[j], vj.grad)
    q, s = TF.quantize_values(tv, "int8")
    with pytest.raises(RuntimeError, match="inference-only"):
        TOPS.condensed_linear_grouped(tx.clone().requires_grad_(), q, ti, scales=s)


# ---------------------------------------------------------------------------
# formats on an expert leaf
# ---------------------------------------------------------------------------

def _expert_leaf_inputs():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((4, 16, 12)).astype(np.float32))
    m = torch.from_numpy(_fan_in_mask(rng, 4, 16, 12, 4))
    m[:, :, :3] = False  # three ablated neurons per expert
    x = torch.from_numpy(rng.standard_normal((4, 5, 16)).astype(np.float32))
    return w, m, x


@pytest.mark.parametrize("values_dtype", [None, "int8", "fp8"])
def test_condensed_expert_leaf_runs_the_grouped_launch(values_dtype):
    w, m, x = _expert_leaf_inputs()
    leaf = TF.Condensed.export_from_dense(w, m, quantize_spec=values_dtype)
    y = leaf.apply(x)
    for j in range(4):
        one = TF.Condensed(values=leaf.values[j], indices=leaf.indices[j], d_in=16,
                           scales=None if leaf.scales is None else leaf.scales[j],
                           values_dtype=leaf.values_dtype)
        assert torch.equal(y[j], one.apply(x[j]))
    if values_dtype is None:
        want = torch.matmul(x, torch.where(m, w, torch.zeros_like(w)))
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # the masked format's batched straight-through select
    masked = TF.MaskedDense.export_from_dense(w, m)
    torch.testing.assert_close(masked.apply(x, w),
                               torch.matmul(x, torch.where(m, w, torch.zeros_like(w))))


@pytest.mark.parametrize("fmt", ["condensed_over_active", "structured"])
def test_formats_without_a_grouped_launch_refuse_an_expert_leaf(fmt):
    """These two formats refused an expert leaf until their grouped
    launches (K4-moe, K5-moe) were ported: the leaf's apply now equals the
    one-expert format expert by expert exactly, and the reference's
    ``jax.vmap`` of the format's apply within TOL."""
    from repro.models import layers as JL
    w, m, x = _expert_leaf_inputs()
    ablation_only = m.any(dim=-2, keepdim=True).expand_as(m).clone()
    mask = ablation_only if fmt == "structured" else m
    leaf = TF.FORMATS[fmt].export_from_dense(w, mask)
    y = leaf.apply(x, w)
    for j in range(4):
        assert torch.equal(y[j], leaf.layer(j).apply(x[j], w[j]))
    jleaf = JF.FORMATS[fmt].export_from_dense(jnp.asarray(w.numpy()), jnp.asarray(mask.numpy()))
    want = jax.vmap(lambda wj, lj, xj: JL.linear(xj, wj, lj))(
        jnp.asarray(w.numpy()), jleaf, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL["float32"])
