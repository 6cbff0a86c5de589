"""The rest of MoE serving and its backward against the JAX reference, on
the CPU: the expert-grouped launches K4-moe / K2-coa-moe, K5-moe / K6-moe
and K3-moe through their plain versions, the three expert-leaf formats and
their gradients, and granite-moe-1b at smoke size with half of every
expert's (and wo's) neurons ablated.

* Each grouped plain version equals its one-expert plain version expert by
  expert exactly, and the reference's ``jax.vmap`` of
  ``repro.kernels.structured_matmul.condensed_over_active_matmul`` /
  ``structured_matmul`` / ``repro.kernels.condensed_matmul.condensed_matmul_dw``
  (Pallas in interpret mode, as the reference's own tests run them) within
  TOL; the batched dx scatter-add equals the per-expert one.
* Every format's expert leaf (condensed, condensed_over_active, structured)
  and its gradients in x and the values (the weights for structured)
  against ``jax.grad`` of the reference's vmapped ``layers.linear``.
* Granite: ``build_plan`` on auto and each forced path gives the
  reference's representations at buckets 1 and 8; ``generate`` gives the
  reference's tokens on condensed_over_active, structured and auto;
  ``Plan.refresh`` after a re-ablation writes the reference's re-export;
  ``tune_registry`` writes the reference's labels and keys, its expert
  stacks' ``@a`` and ``@structured`` entries timed on the grouped launches.

Inputs come from numpy seeds; the model from ``tests/_torch_zoo_model.py``.
Integers are held exactly; floats within TOL (``tests/test_torch_moe.py``'s).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import condensed_matmul as JCM  # noqa: E402
from repro.kernels import structured_matmul as JSM  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.sparse import autotune as JAT  # noqa: E402
from repro.sparse import condensed as JCond  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import condensed_matmul as TCM  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels import structured_matmul as TSM  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402
from repro_torch.sparse import condensed as TCond  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_autotune_stubs import _stub_reference_search, caches  # noqa: E402,F401
from _torch_zoo_model import _model, _prompts, to_port  # noqa: E402

TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-2)}
GRANITE = "granite-moe-1b-a400m"


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# the grouped plain versions
# ---------------------------------------------------------------------------

def _coa_operands(rng, e, m, d_in, d_out, k):
    """Ragged experts: expert i keeps d_out // 2 - i % 2 rows at random
    columns (ascending), padded to the largest with sentinel rows (value
    0, index 0, out_index d_out)."""
    x = rng.standard_normal((e, m, d_in)).astype(np.float32)
    keep = [np.sort(rng.choice(d_out, d_out // 2 - i % 2, replace=False)) for i in range(e)]
    a = max(len(c) for c in keep)
    values = np.zeros((e, a, k), np.float32)
    idx = np.zeros((e, a, k), np.int32)
    out_index = np.full((e, a), d_out, np.int32)
    for i, cols in enumerate(keep):
        n = len(cols)
        values[i, :n] = rng.standard_normal((n, k)) / np.sqrt(k)
        idx[i, :n] = [rng.choice(d_in, k, replace=False) for _ in range(n)]
        out_index[i, :n] = cols
    return x, values, idx, out_index


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coa_grouped_plain_version_is_the_per_expert_k4_and_the_reference_vmap(dtype, quant):
    e, m, d_in, d_out, k = 4, 5, 40, 24, 6
    x, v, i, o = _coa_operands(np.random.default_rng(1), e, m, d_in, d_out, k)
    dt = getattr(torch, dtype)
    tx, ti, to = torch.from_numpy(x).to(dt), torch.from_numpy(i), torch.from_numpy(o)
    if quant:
        tv, ts = TF.quantize_values(torch.from_numpy(v), quant)
        jv, js = JF.quantize_values(jnp.asarray(v), quant)
    else:
        tv, ts = torch.from_numpy(v).to(dt), None
        jv, js = jnp.asarray(v).astype(getattr(jnp, dtype)), None
    got = TSM.condensed_over_active_matmul_grouped(tx, tv, ti, to, d_out, scales=ts)
    assert got.shape == (e, m, d_out) and got.dtype == dt
    for j in range(e):
        sj = None if ts is None else ts[j]
        assert torch.equal(got[j], TSM.condensed_over_active_matmul(tx[j], tv[j], ti[j], to[j],
                                                                    d_out, scales=sj))
        one = (TREF.condensed_over_active_matmul_ref(tx[j], tv[j], ti[j], to[j], d_out)
               if sj is None else
               TREF.condensed_over_active_matmul_scaled_ref(tx[j], tv[j], ti[j], to[j], sj,
                                                            d_out))
        assert torch.equal(got[j], one)
        ablated = np.setdiff1d(np.arange(d_out), o[j])
        assert not got[j][:, ablated].any()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    if js is None:
        want = jax.vmap(lambda a, b, c, d: JSM.condensed_over_active_matmul(a, b, c, d, d_out))(
            jx, jv, jnp.asarray(i), jnp.asarray(o))
    else:
        want = jax.vmap(lambda a, b, c, d, s: JSM.condensed_over_active_matmul(
            a, b, c, d, d_out, scales=s))(jx, jv, jnp.asarray(i), jnp.asarray(o), js)
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_structured_grouped_plain_version_is_the_per_expert_k5_and_the_reference_vmap(
        dtype, prefetch):
    e, m, d_in, d_out = 3, 4, 48, 20
    rng = np.random.default_rng(2)
    x = rng.standard_normal((e, m, d_in)).astype(np.float32)
    w = (rng.standard_normal((e, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    a_pad = 16
    ai = np.full((e, a_pad), d_out, np.int32)
    for j in range(e):
        ai[j, :10 - j] = np.sort(rng.choice(d_out, 10 - j, replace=False))
    dt = getattr(torch, dtype)
    tx, tw, tai = torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt), torch.from_numpy(ai)
    run = TSM.structured_matmul_prefetch_grouped if prefetch else TSM.structured_matmul_grouped
    got = run(tx, tw, tai)
    assert got.shape == (e, m, d_out) and got.dtype == dt
    for j in range(e):
        assert torch.equal(got[j], TSM.structured_matmul(tx[j], tw[j], tai[j],
                                                         prefetch_gather=prefetch))
    assert torch.equal(got, TSM.structured_matmul_grouped_pregathered(
        tx, TSM._gather_columns_grouped(tw, tai), tai, d_out))
    jdt = getattr(jnp, dtype)
    want = jax.vmap(lambda a, b, c: JSM.structured_matmul(a, b, c, prefetch_gather=prefetch))(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(ai))
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_and_dx_grouped_plain_versions_are_the_per_expert_ones_and_the_reference_vmap(dtype):
    e, b, d_in, n, k = 4, 10, 36, 14, 5
    rng = np.random.default_rng(3)
    dy = rng.standard_normal((e, b, n)).astype(np.float32)
    x = rng.standard_normal((e, b, d_in)).astype(np.float32)
    v = rng.standard_normal((e, n, k)).astype(np.float32)
    i = np.stack([np.stack([rng.choice(d_in, k, replace=False) for _ in range(n)])
                  for _ in range(e)]).astype(np.int32)
    dt = getattr(torch, dtype)
    tdy, tx, tv = (torch.from_numpy(a).to(dt) for a in (dy, x, v))
    ti = torch.from_numpy(i)
    dw = TCM.condensed_matmul_dw_grouped(tdy, tx, ti)
    assert dw.shape == (e, n, k) and dw.dtype == torch.float32
    dx = TREF.condensed_matmul_dx_grouped_ref(tdy, tv, ti, d_in)
    assert dx.shape == (e, b, d_in) and dx.dtype == dt
    for j in range(e):
        assert torch.equal(dw[j], TCM.condensed_matmul_dw(tdy[j], tx[j], ti[j]))
        torch.testing.assert_close(dx[j], TREF.condensed_matmul_dx_ref(tdy[j], tv[j], ti[j], d_in),
                                   rtol=0, atol=0 if dtype == "float32" else 1e-2)
    jdt = getattr(jnp, dtype)
    want = jax.vmap(JCM.condensed_matmul_dw)(jnp.asarray(dy).astype(jdt),
                                             jnp.asarray(x).astype(jdt), jnp.asarray(i))
    np.testing.assert_allclose(_np(dw), _np(want.astype(jnp.float32)), **TOL[dtype])


def test_grouped_wrappers_check_their_operands():
    x = torch.zeros((2, 3, 8))
    v = torch.zeros((2, 4, 2))
    i = torch.zeros((2, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="out_index"):
        TSM.condensed_over_active_matmul_grouped(x, v, i, torch.zeros((2, 3), dtype=torch.int32),
                                                 6)
    with pytest.raises(ValueError, match="need x"):
        TSM.structured_matmul_grouped(x, torch.zeros((3, 8, 6)),
                                      torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="need dy"):
        TCM.condensed_matmul_dw_grouped(torch.zeros((2, 3, 5)), x, i)


# ---------------------------------------------------------------------------
# the expert-leaf formats and their gradients
# ---------------------------------------------------------------------------

def _leaf_inputs(fmt):
    rng = np.random.default_rng(4)
    e, d_in, d_out, k = 4, 16, 12, 5
    w = rng.standard_normal((e, d_in, d_out)).astype(np.float32)
    m = np.zeros((e, d_in, d_out), bool)
    for j in range(e):
        for n in range(d_out):
            m[j, rng.choice(d_in, k, replace=False), n] = True
    m[:, :, : d_out // 2] = False  # half of each expert's neurons ablated
    if fmt == "structured":
        m = m.any(axis=-2, keepdims=True) & np.ones_like(m)
    x = rng.standard_normal((e, 6, d_in)).astype(np.float32)
    cot = rng.standard_normal((e, 6, d_out)).astype(np.float32)
    return w, m, x, cot


@pytest.mark.parametrize("fmt", ["condensed", "condensed_over_active", "structured"])
def test_expert_leaf_apply_and_gradients_equal_the_reference_vmap(fmt):
    w, m, x, cot = _leaf_inputs(fmt)
    jleaf = JF.FORMATS[fmt].export_from_dense(jnp.asarray(w), jnp.asarray(m))
    tleaf = TF.FORMATS[fmt].export_from_dense(torch.from_numpy(w), torch.from_numpy(m))
    field = "values" if fmt != "structured" else None

    def jloss(xj, wj, vals):
        leaf = jleaf if field is None else dataclasses.replace(jleaf, values=vals)
        y = jax.vmap(lambda a, b, lf: JL.linear(a, b, lf))(xj, wj, leaf)
        return jnp.sum(y * jnp.asarray(cot)), y

    jvals = jnp.zeros(()) if field is None else jleaf.values
    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jvals)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    leaf = tleaf
    if field is not None:
        leaf = dataclasses.replace(tleaf, values=tleaf.values.clone().requires_grad_())
    ty = leaf.apply(tx, tw)
    (ty * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]), **TOL["float32"])
    if field is None:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[1]), **TOL["float32"])
        assert not tw.grad[..., : w.shape[-1] // 2].any()
    else:
        assert tw.grad is None
        np.testing.assert_allclose(leaf.values.grad.numpy(), np.asarray(jgrads[2]),
                                   **TOL["float32"])
    for j in range(w.shape[0]):  # expert by expert the one-expert leaf
        assert torch.equal(ty[j], tleaf.layer(j).apply(tx[j], tw[j]))


# ---------------------------------------------------------------------------
# granite at smoke size, half of every stack's neurons ablated
# ---------------------------------------------------------------------------

def _ablated(m, ablation_only: bool = False):
    """The model's masks with the last half of every stack's neurons
    emptied (``ablation_only``: and every other neuron's inputs all
    active): (the port's masks, the reference's)."""
    masks = to_port(m["jmasks"])
    for s in m["treg"]:
        mk = TR.get_path(masks, s.path)
        if ablation_only:
            mk.fill_(True)
        mk[..., s.d_out - s.d_out // 2:] = False
    return masks, jax.tree.map(jnp.asarray, bridge.to_jax_numpy(masks))


@pytest.mark.parametrize("bucket", [1, 8])
@pytest.mark.parametrize("path", ["auto", "masked", "condensed", "condensed_over_active",
                                  "structured"])
def test_plans_on_every_path_equal_the_reference(path, bucket):
    m = _model(GRANITE, ())
    masks, jmasks = _ablated(m)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=bucket,
                          path=path)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks, batch_size=bucket,
                          path=path)
    reps = {s.name: tplan.representation_of(s.name) for s in m["treg"]}
    assert reps == {s.name: jplan.representation_of(s.name) for s in m["jreg"]}
    if path == "auto" and bucket == 1:  # the case the gate refused: experts off condensed
        assert {reps[s.name] for s in m["treg"] if TR.is_expert_stack(s, m["tcfg"])} - {
            "masked", "condensed"}


def _trees(m, path, masks, jmasks):
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=4, path=path)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks, batch_size=4, path=path)
    return jplan.serving_tree, tplan.serving_tree


@pytest.mark.parametrize("path", ["condensed_over_active", "structured", "auto"])
def test_generate_equals_the_reference(path):
    m = _model(GRANITE, ())
    masks, jmasks = _ablated(m, ablation_only=path == "structured")
    jtree, ttree = _trees(m, path, masks, jmasks)
    prompts = _prompts(m["tcfg"], 4, 32, seed=6)
    want = np.asarray(JE.generate(m["jcfg"], m["jparams"], jtree, jnp.asarray(prompts), 6))
    got = TE.generate(m["tcfg"], m["tparams"], ttree, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ["condensed_over_active", "structured"])
def test_plan_refresh_after_a_reablation_equals_the_reference_export(path):
    """A plan on ``path`` refreshed after a quarter more of every stack's
    neurons is ablated: the stacks the reference re-exports, each leaf
    equal to the reference's re-export (integers exactly) and to a fresh
    port export bitwise."""
    m = _model(GRANITE, ())
    ablation_only = path == "structured"
    masks, jmasks = _ablated(m, ablation_only)
    versions = {s.name: 0 for s in m["treg"]}
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=1, path=path,
                          mask_versions=dict(versions))
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks, batch_size=1, path=path,
                          mask_versions=dict(versions))
    masks2 = to_port(jmasks)
    for s in m["treg"]:
        TR.get_path(masks2, s.path)[..., : s.d_out // 4] = False
    jmasks2 = jax.tree.map(jnp.asarray, bridge.to_jax_numpy(masks2))
    versions2 = {s.name: 1 for s in m["treg"]}
    jchanged = jplan.refresh(m["jparams"], jmasks2, versions2, donate=False)
    assert tplan.refresh(m["tparams"], masks2, versions2) == jchanged
    fresh = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks2, batch_size=1, path=path,
                          mask_versions=dict(versions2))
    for s in m["treg"]:
        leaf, jleaf = TR.get_path(tplan.serving_tree, s.path), JR.get_path(jplan.serving_tree,
                                                                           s.path)
        assert type(leaf).format_name == type(jleaf).format_name == path
        for f, t in leaf.arrays().items():
            want = np.asarray(getattr(jleaf, f))
            if t.dtype.is_floating_point:
                np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{s.name}/{f}")
            else:
                np.testing.assert_array_equal(t.numpy(), want, err_msg=f"{s.name}/{f}")
            assert torch.equal(t, getattr(TR.get_path(fresh.serving_tree, s.path), f))


@pytest.mark.parametrize("ablation_only", [False, True], ids=["ablated", "ablation-only"])
def test_tune_registry_times_the_expert_keys_on_the_grouped_launches(caches, monkeypatch,
                                                                     ablation_only):
    """Ablated stacks add the ``@a{a}`` keys (K4) and, on ablation-only
    masks, the ``@structured`` keys (K5): the labels and keys are the
    reference's, and each expert stack's search times the expert-grouped
    launch over its E experts (K1-moe, K4-moe, K5-moe), wo the one-expert
    launches."""
    _stub_reference_search(monkeypatch)
    m = _model(GRANITE, ())
    masks, jmasks = _ablated(m, ablation_only)
    kinds = []
    call = AT.candidate_call
    monkeypatch.setattr(AT, "candidate_call",
                        lambda kind, *a: kinds.append(kind) or call(kind, *a))
    jout = JAT.tune_registry(m["jreg"], JCond.export_stats(m["jreg"], jmasks), batch=8,
                             dtype=jnp.float32, reps=1)
    tout = AT.tune_registry(m["treg"], TCond.export_stats(m["treg"], masks), batch=8,
                            dtype=torch.float32, reps=1, device="cpu", cfg=m["tcfg"])
    assert set(tout) == set(jout)
    assert any("@a" in label for label in tout)
    assert any("@structured" in label for label in tout) == ablation_only
    assert set(json.loads(caches[0].read_text())["kernels"]) == \
        set(json.loads(caches[1].read_text())["kernels"])
    want = {"grouped", "grouped_coa", "condensed", "coa"}
    if ablation_only:
        want |= {"grouped_structured", "structured"}
    assert set(kinds) == want
    for label, res in tout.items():
        if not label.startswith("blocks/wo"):
            assert res.plain and res.us == min(res.table.values())
