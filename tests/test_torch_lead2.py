"""Refresh on stacks with two leading axes against the JAX reference, on the
CPU: gemma3's grouped local/global layout (``g_local``, lead (g, r), at
smoke size with rem 0 and at 8 layers with rem 2) and the MoE expert stacks
(granite-moe smoke, ``blocks/w_gate`` etc., lead (L, E)).

``Plan.refresh`` after a rewire of one two-axis stack re-exports exactly the
reference's stacks, with its ``export_calls`` and ``value_refreshes``; every
refreshed leaf equals the reference's refreshed leaf (integers exactly,
floats within FLOAT_TOL) and a fresh port export exactly, and a same-shape
refresh keeps every ``data_ptr``; ``donate=False`` leaves the old leaves
as they were. A refresh that moves an expert stack to
condensed_over_active (half of its neurons ablated) re-exports it as the
reference does. The engine's refresh is in ``test_torch_lead2_engine.py``.

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into
the port (``tests/_torch_zoo_model.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import _model, rewired_generation, to_port  # noqa: E402

# refreshed float leaves against the reference's (both gathers of the same
# float32 weights; integer arrays are held exactly)
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)
GRANITE = "granite-moe-1b-a400m"
# (arch, config overrides, the two-axis stack rewired)
CASES = [("gemma3-1b", (), "g_local/w_down"),
         ("gemma3-1b", (("n_layers", 8),), "g_local/wo"),
         (GRANITE, (), "blocks/w_gate")]
IDS = ["gemma3", "gemma3-rem2", "granite"]
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn) else t).numpy()


def _ptrs(plan, reg):
    return {s.name: {f: t.data_ptr() for f, t in TR.get_path(plan.serving_tree, s.path)
                     .arrays().items()} for s in reg}


def _assert_matches_reference(tleaf, jleaf, name):
    assert type(tleaf).format_name == type(jleaf).format_name, name
    for f, t in tleaf.arrays().items():
        want = np.asarray(getattr(jleaf, f))
        if want.dtype.name in ("bfloat16", "float8_e4m3fn"):
            want = want.astype(np.float32)
        got = _np(t)
        assert got.shape == want.shape, (name, f)
        if np.issubdtype(got.dtype, np.floating):
            np.testing.assert_allclose(got, want, **FLOAT_TOL, err_msg=f"{name}/{f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{f}")


def _assert_equal_leaves(a, b, name):
    assert type(a) is type(b), name
    for f, t in a.arrays().items():
        assert t.dtype == getattr(b, f).dtype and torch.equal(t, getattr(b, f)), (name, f)


# ---------------------------------------------------------------------------
# Plan.refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values_dtype", [None, "int8"])
@pytest.mark.parametrize("arch,kw,name", CASES, ids=IDS)
def test_plan_refresh_equals_the_reference(arch, kw, name, values_dtype):
    m = _model(arch, kw)
    jreg, treg = m["jreg"], m["treg"]
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    jplan = JP.build_plan(m["jcfg"], jreg, m["jparams"], m["jmasks"], batch_size=1,
                          path="condensed", mask_versions=dict(versions),
                          values_dtype=values_dtype)
    tplan = TP.build_plan(m["tcfg"], treg, m["tparams"], m["tmasks"], batch_size=1,
                          path="condensed", mask_versions=dict(versions), profile=PROFILE,
                          values_dtype=values_dtype)
    ptrs = _ptrs(tplan, treg)
    jchanged = jplan.refresh(params2, masks2, versions2, donate=False)
    tchanged = tplan.refresh(to_port(params2), to_port(masks2), versions2)
    assert tchanged == jchanged == [name]
    assert (tplan.export_calls, tplan.value_refreshes) == \
        (jplan.export_calls, jplan.value_refreshes) == (len(treg) + 1, len(treg) - 1)
    assert tplan.mask_versions == jplan.mask_versions
    fresh = TP.build_plan(m["tcfg"], treg, to_port(params2), to_port(masks2), batch_size=1,
                          path="condensed", mask_versions=dict(versions2), profile=PROFILE,
                          values_dtype=values_dtype)
    for s in treg:
        leaf = TR.get_path(tplan.serving_tree, s.path)
        _assert_matches_reference(leaf, JR.get_path(jplan.serving_tree, s.path), s.name)
        _assert_equal_leaves(leaf, TR.get_path(fresh.serving_tree, s.path), s.name)
        assert tuple(leaf.values.shape[:len(s.lead)]) == s.lead
    # same shapes: every leaf written into its own tensors
    assert _ptrs(tplan, treg) == ptrs


@pytest.mark.parametrize("arch,kw,name", CASES[::2], ids=IDS[::2])
def test_plan_refresh_donate_false_keeps_the_old_leaves(arch, kw, name):
    m = _model(arch, kw)
    treg = m["treg"]
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    plan = TP.build_plan(m["tcfg"], treg, m["tparams"], m["tmasks"], batch_size=1,
                         path="condensed", mask_versions=dict(versions), profile=PROFILE)
    old = {s.name: {f: t.clone() for f, t in TR.get_path(plan.serving_tree, s.path)
                    .arrays().items()} for s in treg}
    held = {s.name: TR.get_path(plan.serving_tree, s.path) for s in treg}
    plan.refresh(to_port(params2), to_port(masks2), versions2, donate=False)
    for s in treg:
        for f, t in held[s.name].arrays().items():
            assert torch.equal(t, old[s.name][f]), (s.name, f)
    stack = next(s for s in treg if s.name == name)
    assert not torch.equal(TR.get_path(plan.serving_tree, stack.path).indices,
                           old[name]["indices"])


def test_refresh_to_a_format_without_a_grouped_launch_raises():
    """auto at bucket 1 serves granite's experts condensed; half of their
    neurons ablated, the reference's cost model picks condensed_over_active
    for them. That refresh raised until the expert stacks had a grouped K4
    (K4-moe); it now re-exports the stacks the reference's refresh does,
    each leaf equal to the reference's (integers exactly) and to a fresh
    port export."""
    m = _model(GRANITE, ())
    treg = m["treg"]
    versions = {s.name: 0 for s in treg}
    plan = TP.build_plan(m["tcfg"], treg, m["tparams"], m["tmasks"], batch_size=1,
                         path="auto", mask_versions=dict(versions), profile=PROFILE)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"], batch_size=1,
                          path="auto", mask_versions=dict(versions))
    assert {plan.representation_of(s.name) for s in treg
            if TR.is_expert_stack(s, m["tcfg"])} == {"condensed"}
    masks = to_port(m["jmasks"])
    for s in treg:
        TR.get_path(masks, s.path)[..., : s.d_out // 2] = False
    jmasks = jax.tree.map(jnp.asarray, bridge.to_jax_numpy(masks))
    versions2 = {s.name: 1 for s in treg}
    jchanged = jplan.refresh(m["jparams"], jmasks, versions2, donate=False)
    assert plan.refresh(m["tparams"], masks, versions2) == jchanged
    assert jplan.representation_of("blocks/w_gate") == "condensed_over_active"
    fresh = TP.build_plan(m["tcfg"], treg, m["tparams"], masks, batch_size=1, path="auto",
                          mask_versions=dict(versions2), profile=PROFILE)
    for s in treg:
        assert plan.representation_of(s.name) == jplan.representation_of(s.name), s.name
        leaf = TR.get_path(plan.serving_tree, s.path)
        _assert_matches_reference(leaf, JR.get_path(jplan.serving_tree, s.path), s.name)
        _assert_equal_leaves(leaf, TR.get_path(fresh.serving_tree, s.path), s.name)
