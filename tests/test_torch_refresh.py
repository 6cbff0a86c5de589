"""Incremental refresh in the port (``Plan.refresh``, the formats'
``donate_refresh`` / ``refresh_values``, ``ServingEngine.refresh``) against
the reference, on the CPU.

On the reference's smoke qwen3 (weights and masks bridged from
``PRNGKey(0)``), each of the reference's refresh tests in
``tests/test_plan.py`` is held here against the reference itself: only the
changed stacks re-export, with ``export_calls`` and ``value_refreshes``
equal to the reference plan's; a values-only refresh reuses the indices;
the served snapshot follows params that train on; ablation flips a stack
as the reference decides; a refreshed plan serves the reference's tokens.
The port's form of donation is a ``copy_`` into the old tensors: a
same-shape refresh keeps every ``data_ptr``, ``donate=False`` leaves the old
leaves intact, and every refreshed leaf equals a fresh port export exactly
on every format, int8 and fp8 included (and the reference's refreshed leaf:
integers exactly, floats within FLOAT_TOL). ``ServingEngine.refresh`` at a
chunk boundary mid-generation gives the reference engine's tokens exactly
on condensed, condensed_over_active, int8 condensed and masked. A no-op
refresh with host versions fetches nothing from the device, and a shared
``export_cache`` exports each stack once across plan keys. Last, the
engine owns what it serves: training the caller's state in place moves
nothing until a refresh.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402

# refreshed float leaves against the reference's refreshed leaves (both are
# gathers of the same float32 weights; integer arrays are held exactly)
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)
GEN = 6


def _t(tree):
    """A reference tree (params or masks) as the port's tensors."""
    return bridge.from_jax_numpy(jax.tree.map(np.asarray, tree))


def _prompts(b=2, t=8, seed=1, vocab=None):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    m = smoke_model()
    profile = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                    for f in dataclasses.fields(TP.HardwareProfile)})
    return dict(m, profile=profile, tmasks=_t(m["jmasks"]),
                prompts=_prompts(vocab=m["tcfg"].vocab_size))


def _ablate(reg, masks, frac=0.25):
    """The reference test's ablation: the last ``frac`` of each stack's
    output neurons cut (tests/test_plan.py)."""
    out = {}
    for s in reg:
        m = JR.get_path(masks, s.path)
        cut = s.d_out - max(1, int(s.d_out * frac))
        JR._set_path(out, s.path, m & (jnp.arange(s.d_out) < cut)[None, :])
    return out


def _rolled(reg, masks, idx=0):
    """Stack ``idx``'s mask rolled by one input row: a rewire at an
    unchanged fan-in and column activity (the reference's ``_bump``)."""
    out = jax.tree.map(lambda x: x, masks)
    s = reg[idx]
    JR.set_path(out, s.path, jnp.roll(JR.get_path(masks, s.path), 1, axis=-2))
    return out


def _trained_on(reg, params, scale=0.1, seed=7):
    """Every sparse stack's weights perturbed (training went on)."""
    out = jax.tree.map(lambda x: x, params)
    for s in reg:
        w = JR.get_path(out, s.path)
        JR._set_path(out, s.path, w + scale * jax.random.normal(jax.random.PRNGKey(seed),
                                                                w.shape))
    return out


def _plans(smoke, params, masks, path="auto", values_dtype=None, versions=None):
    """The reference plan and the port's, built from the same trees."""
    v = versions or {s.name: 0 for s in smoke["jreg"]}
    jp = JP.build_plan(smoke["jcfg"], smoke["jreg"], params, masks, batch_size=1, path=path,
                       mask_versions=dict(v), values_dtype=values_dtype)
    tp = TP.build_plan(smoke["tcfg"], smoke["treg"], _t(params), _t(masks), batch_size=1,
                       path=path, mask_versions=dict(v), profile=smoke["profile"],
                       values_dtype=values_dtype)
    return jp, tp


def _leaf(plan, s):
    return TR.get_path(plan.serving_tree, s.path)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn) else t).numpy()


def _assert_matches_reference(tleaf, jleaf, d_out=None):
    """Integers exactly, floats within FLOAT_TOL. The reference regathers a
    clipped column into condensed_over_active's padding rows (its scatter
    drops them); the port keeps them +0 as a fresh export does, so those
    rows are left out of the comparison. A bf16-storage leaf that the
    reference re-exports comes back at float32 there (ROADMAP section 3);
    its values are held at the plan's bf16 width."""
    assert type(tleaf).format_name == type(jleaf).format_name
    for f, t in tleaf.arrays().items():
        want = np.asarray(getattr(jleaf, f))
        if want.dtype.name in ("bfloat16", "float8_e4m3fn"):
            want = want.astype(np.float32)
        if t.dtype == torch.bfloat16:
            want = torch.from_numpy(np.array(want)).to(t.dtype).float().numpy()
        got = _np(t)
        if f == "values" and d_out is not None and hasattr(tleaf, "out_index"):
            live = (_np(tleaf.out_index) < d_out)[..., None]
            got, want = np.where(live, got, 0), np.where(live, want, 0)
        if np.issubdtype(got.dtype, np.floating):
            np.testing.assert_allclose(got, want, **FLOAT_TOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


def _assert_equal_leaves(a, b):
    assert type(a) is type(b)
    assert a.arrays().keys() == b.arrays().keys()
    for f, t in a.arrays().items():
        assert t.dtype == getattr(b, f).dtype and torch.equal(t, getattr(b, f)), f
    for f in type(a)._static_fields:
        assert getattr(a, f) == getattr(b, f), f


def _generate(smoke, params, tree, gen=GEN):
    return TE.generate(smoke["tcfg"], TE.M.serving_params(smoke["tcfg"], params), tree,
                       torch.as_tensor(smoke["prompts"]), gen).numpy()


def _jgenerate(smoke, params, masks, gen=GEN):
    return np.asarray(JS.generate(smoke["jcfg"], params, masks, jnp.asarray(smoke["prompts"]),
                                  gen_len=gen))


# ---------------------------------------------------------------------------
# Plan.refresh against the reference's
# ---------------------------------------------------------------------------

def test_refresh_reexports_only_changed_stacks(smoke):
    jreg, treg, jparams, jmasks = smoke["jreg"], smoke["treg"], smoke["jparams"], smoke["jmasks"]
    jp, tp = _plans(smoke, jparams, jmasks)
    assert tp.export_calls == jp.export_calls == len(treg)
    versions = {s.name: 0 for s in treg}
    assert tp.refresh(smoke["tparams"], smoke["tmasks"], versions, refresh_values=False) == []
    assert tp.export_calls == len(treg)

    target = jreg[1]
    new_masks = jax.tree.map(lambda m: m, jmasks)
    JR._set_path(new_masks, target.path, JR.get_path(_ablate([target], jmasks), target.path))
    new_versions = dict(versions, **{target.name: 1})
    before = {s.name: _leaf(tp, s) for s in treg}
    jchanged = jp.refresh(jparams, new_masks, new_versions, refresh_values=False)
    tchanged = tp.refresh(smoke["tparams"], _t(new_masks), new_versions, refresh_values=False)
    assert tchanged == jchanged == [target.name]
    assert (tp.export_calls, tp.value_refreshes) == (jp.export_calls, jp.value_refreshes) \
        == (len(treg) + 1, 0)
    assert tp.mask_versions == jp.mask_versions
    for s in treg:
        assert (_leaf(tp, s) is before[s.name]) == (s.name != target.name)
    _assert_matches_reference(_leaf(tp, treg[1]), JR.get_path(jp.serving_tree, target.path),
                              target.d_out)


def test_refresh_values_regathers_unchanged_stacks_without_resort(smoke):
    jreg, treg, jparams, jmasks = smoke["jreg"], smoke["treg"], smoke["jparams"], smoke["jmasks"]
    jp, tp = _plans(smoke, jparams, jmasks)
    before = {s.name: (_leaf(tp, s).indices, _leaf(tp, s).values.clone()) for s in treg}
    target = jreg[1]
    new_masks = jax.tree.map(lambda m: m, jmasks)
    JR._set_path(new_masks, target.path, JR.get_path(_ablate([target], jmasks), target.path))
    versions = {s.name: int(s.name == target.name) for s in jreg}
    assert jp.refresh(jparams, new_masks, versions) == \
        tp.refresh(smoke["tparams"], _t(new_masks), versions) == [target.name]
    assert (tp.export_calls, tp.value_refreshes) == (jp.export_calls, jp.value_refreshes) \
        == (len(treg) + 1, len(treg) - 1)
    for s in treg:
        if s.name == target.name:
            continue
        leaf = _leaf(tp, s)
        assert leaf.indices is before[s.name][0]           # reused, not re-sorted
        assert torch.equal(leaf.values, before[s.name][1])  # same params: same values


@pytest.mark.parametrize("ablated", [False, True])
def test_refresh_keeps_snapshot_coherent_when_params_train_on(smoke, ablated):
    """Weights train on with no mask change: the refreshed plan serves the
    new weights, as the masked path and the reference do."""
    jreg, jparams = smoke["jreg"], smoke["jparams"]
    masks = _ablate(jreg, smoke["jmasks"]) if ablated else smoke["jmasks"]
    jp, tp = _plans(smoke, jparams, masks)
    new_params = _trained_on(jreg, jparams)
    versions = {s.name: 0 for s in jreg}
    assert jp.refresh(new_params, masks, versions) == []
    assert tp.refresh(_t(new_params), _t(masks), versions) == []
    assert tp.value_refreshes == jp.value_refreshes == len(jreg)
    want = _jgenerate(smoke, new_params, masks)
    np.testing.assert_array_equal(_generate(smoke, _t(new_params), tp.serving_tree), want)
    np.testing.assert_array_equal(_jgenerate(smoke, new_params, jp.serving_tree), want)
    for s in smoke["treg"]:
        _assert_matches_reference(_leaf(tp, s), JR.get_path(jp.serving_tree, s.path), s.d_out)


def test_refresh_flips_representation_as_the_reference_does(smoke):
    jreg, jparams, jmasks = smoke["jreg"], smoke["jparams"], smoke["jmasks"]
    jp, tp = _plans(smoke, jparams, jmasks)
    assert tp.representation_of(jreg[0].name) == jp.representation_of(jreg[0].name) \
        == "condensed"
    abl = _ablate(jreg, jmasks)
    versions = {s.name: 1 for s in jreg}
    jp.refresh(jparams, abl, versions)
    tp.refresh(smoke["tparams"], _t(abl), versions)
    for s in jreg:
        assert tp.representation_of(s.name) == jp.representation_of(s.name) \
            == "condensed_over_active"
    # the refreshed plan serves the new masks: the reference's tokens
    np.testing.assert_array_equal(_generate(smoke, smoke["tparams"], tp.serving_tree),
                                  _jgenerate(smoke, jparams, abl))


# ---------------------------------------------------------------------------
# the port's donation: copy_ into the old tensors
# ---------------------------------------------------------------------------

def _ptrs(plan, reg):
    return {s.name: {f: t.data_ptr() for f, t in _leaf(plan, s).arrays().items()} for s in reg}


def test_same_shape_refresh_keeps_every_data_ptr(smoke):
    """A values-only refresh and a rewire at an unchanged fan-in both write
    into the old tensors: every data_ptr kept, tokens equal masked."""
    jreg, treg, jparams, jmasks = smoke["jreg"], smoke["treg"], smoke["jparams"], smoke["jmasks"]
    _, tp = _plans(smoke, jparams, jmasks, path="condensed")
    ptrs = _ptrs(tp, treg)
    new_params = jax.tree.map(lambda x: x * 1.5, jparams)
    assert tp.refresh(_t(new_params), smoke["tmasks"], {s.name: 0 for s in treg}) == []
    assert _ptrs(tp, treg) == ptrs
    rolled = jmasks
    for i in range(len(jreg)):
        rolled = _rolled(jreg, rolled, i)
    changed = tp.refresh(_t(new_params), _t(rolled), {s.name: 1 for s in treg})
    assert sorted(changed) == sorted(s.name for s in treg)
    assert tp.export_calls == 2 * len(treg)
    assert _ptrs(tp, treg) == ptrs
    np.testing.assert_array_equal(_generate(smoke, _t(new_params), tp.serving_tree),
                                  _jgenerate(smoke, new_params, rolled))


def test_refresh_donate_false_preserves_old_leaves(smoke):
    treg = smoke["treg"]
    _, tp = _plans(smoke, smoke["jparams"], smoke["jmasks"], path="condensed")
    old = {s.name: _leaf(tp, s) for s in treg}
    kept = {s.name: old[s.name].values.clone() for s in treg}
    new_params = _t(jax.tree.map(lambda x: x * 1.5, smoke["jparams"]))
    tp.refresh(new_params, smoke["tmasks"], {s.name: 0 for s in treg}, donate=False)
    for s in treg:
        assert torch.equal(old[s.name].values, kept[s.name])
        assert _leaf(tp, s).values.data_ptr() != old[s.name].values.data_ptr()
        assert torch.equal(_leaf(tp, s).values, (kept[s.name].float() * 1.5).to(
            kept[s.name].dtype))


CASES = [(p, vd) for p in ("condensed", "condensed_over_active")
         for vd in (None, "bf16", "int8", "fp8")] + \
        [("structured", None), ("structured", "int8"), ("structured", "fp8")]


@pytest.mark.parametrize("path,values_dtype", CASES)
@pytest.mark.parametrize("donate", [True, False])
def test_refreshed_leaves_equal_a_fresh_export(smoke, path, values_dtype, donate):
    """Values-only, same-shape rewire and changed-shape refreshes each equal
    a fresh port export of the same trees exactly (structured on
    ablation-only masks, its exact regime; quantized structured leaves
    regather their panel through ``refresh_values``), and the condensed
    family's equal the reference's refreshed leaves."""
    jreg, treg, jparams = smoke["jreg"], smoke["treg"], smoke["jparams"]
    base = smoke["jmasks"] if path != "structured" else _ablate(
        jreg, jax.tree.map(lambda m: jnp.ones_like(m), smoke["jmasks"]))
    masks = _ablate(jreg, base, 0.25)
    jp, tp = _plans(smoke, jparams, masks, path=path, values_dtype=values_dtype)
    p2 = _trained_on(jreg, jparams)
    more = _ablate(jreg, base, 0.5)            # the active count moves: new shapes
    steps = ((p2, masks, 0), (p2, _rolled(jreg, masks), 1), (jparams, more, 2))
    for params, m, version in steps:
        versions = {s.name: version for s in jreg}
        before = {s.name: {f: (t.data_ptr(), tuple(t.shape))
                           for f, t in _leaf(tp, s).arrays().items()} for s in treg}
        tp.refresh(_t(params), _t(m), versions, donate=donate)
        fresh = TP.build_plan(smoke["tcfg"], treg, _t(params), _t(m), batch_size=1, path=path,
                              profile=smoke["profile"], values_dtype=values_dtype)
        for s in treg:
            leaf, want = _leaf(tp, s), _leaf(fresh, s)
            if path == "structured":
                leaf = leaf.refresh_values(TR.get_path(_t(params), s.path),
                                           TR.get_path(_t(m), s.path), donate=donate)
                _assert_equal_leaves(leaf, want)
                continue
            _assert_equal_leaves(leaf, want)
            # the storage is kept exactly when donating at unchanged shapes
            same_shapes = all(shape == tuple(getattr(want, f).shape)
                              for f, (_, shape) in before[s.name].items())
            kept = all(t.data_ptr() == before[s.name][f][0] for f, t in leaf.arrays().items())
            assert kept == (donate and same_shapes)
        if path != "structured":
            jp.refresh(params, m, versions, donate=False)
            assert (tp.export_calls, tp.value_refreshes) == (jp.export_calls, jp.value_refreshes)
            for s in treg:
                _assert_matches_reference(_leaf(tp, s), JR.get_path(jp.serving_tree, s.path),
                                          s.d_out)


# ---------------------------------------------------------------------------
# host fetches and shared exports
# ---------------------------------------------------------------------------

def _count_fetches(monkeypatch):
    """Count the calls that move a tensor's numbers to the host."""
    calls = {"n": 0}
    for name in ("tolist", "item", "__int__", "__float__", "__bool__", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, **kw):
            calls["n"] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    return calls


def test_noop_refresh_with_host_versions_fetches_nothing(smoke, monkeypatch):
    treg = smoke["treg"]
    _, tp = _plans(smoke, smoke["jparams"], smoke["jmasks"], path="condensed")
    versions = {s.name: 0 for s in treg}
    calls = _count_fetches(monkeypatch)
    assert tp.refresh(smoke["tparams"], smoke["tmasks"], versions) == []
    assert calls["n"] == 0
    # tensor counters: one fetch for all of them; a changed stack adds the
    # one fetch of its stats
    assert tp.refresh(smoke["tparams"], smoke["tmasks"],
                      {k: torch.tensor(v, dtype=torch.int32) for k, v in versions.items()}) == []
    assert calls["n"] == 1
    calls["n"] = 0
    moved = dict(versions, **{treg[0].name: 1})
    assert tp.refresh(smoke["tparams"], smoke["tmasks"], moved) == [treg[0].name]
    assert calls["n"] == 1


def _engine(smoke, params, masks, path="condensed", **kw):
    kw.setdefault("profile", smoke["profile"])
    return TE.ServingEngine(smoke["tcfg"], params, masks, smoke["treg"], path=path,
                            gen_chunk=4, **kw)


def test_engine_refresh_exports_each_stack_once_across_plan_keys(smoke, monkeypatch):
    treg = smoke["treg"]
    versions = {s.name: 0 for s in treg}
    eng = _engine(smoke, smoke["tparams"], smoke["tmasks"], mask_versions=versions)
    p1, p8 = eng.plan_for(eng.plan_key(1)), eng.plan_for(eng.plan_key(8))
    assert p1 is not p8
    calls = {"n": 0}
    real = TP.COND.recondense_stack_leaf

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(TP.COND, "recondense_stack_leaf", counting)
    new_masks = _t(_rolled(smoke["jreg"], smoke["jmasks"]))
    changed = eng.refresh(smoke["tparams"], new_masks, dict(versions, **{treg[0].name: 1}))
    assert {n for names in changed.values() for n in names} == {treg[0].name}
    assert calls["n"] == 1
    for s in treg:
        assert _leaf(p1, s) is _leaf(p8, s)
    # tensor counters are fetched once; the engine keeps host ints after
    fetches = _count_fetches(monkeypatch)
    eng.refresh(smoke["tparams"], new_masks,
                {k: torch.tensor(v) for k, v in eng._mask_versions.items()}, donate=False)
    assert fetches["n"] == 1
    fetches["n"] = 0
    eng.refresh(smoke["tparams"], new_masks, eng._mask_versions, donate=False)
    assert fetches["n"] == 0


# ---------------------------------------------------------------------------
# ServingEngine.refresh mid-generation, against the reference engine
# ---------------------------------------------------------------------------

ENGINE_CASES = [("condensed", None, False), ("condensed_over_active", None, True),
                ("condensed", "int8", False), ("masked", None, False)]


@pytest.mark.parametrize("path,values_dtype,ablated", ENGINE_CASES)
def test_engine_refresh_mid_generation_equals_the_reference(smoke, path, values_dtype, ablated):
    """Half of a 16-token request on gen-1, ``refresh`` at the chunk
    boundary, the rest on gen-2 (one stack rewired, every float param
    trained on): the reference engine's tokens exactly. In place, no decode
    step is made again and every leaf keeps its storage; ``donate=False``
    gives the same tokens."""
    jreg, jparams = smoke["jreg"], smoke["jparams"]
    masks = _ablate(jreg, smoke["jmasks"]) if ablated else smoke["jmasks"]
    versions = {s.name: 0 for s in jreg}
    masks2 = _rolled(jreg, masks)
    params2 = jax.tree.map(lambda x: x * 1.01, jparams)
    versions2 = dict(versions, **{jreg[0].name: 1})
    prompts = smoke["prompts"]

    jeng = JE.ServingEngine(smoke["jcfg"], jparams, masks, jreg, path=path,
                            mask_versions=dict(versions), gen_chunk=4, values_dtype=values_dtype)
    rid = jeng.submit(jnp.asarray(prompts), 16)
    jeng.step(max_chunks=2)
    jeng.refresh(params2, masks2, versions2, donate=False)
    jeng.step()
    [jres] = jeng.retire(rid)

    tokens = {}
    for donate in (True, False):
        eng = _engine(smoke, _t(jparams), _t(masks), path=path, mask_versions=versions,
                      values_dtype=values_dtype)
        rid = eng.submit(prompts, 16)
        eng.step(max_chunks=2)
        key = eng.plan_key(prompts.shape[0])
        plan = None if path == "masked" else eng.plan_for(key)
        ptrs = None if plan is None else _ptrs(plan, smoke["treg"])
        mask_ptrs = TE._storage(eng.masks)
        captures, programs = eng.captures, eng.program_count("decode")
        calls = None if plan is None else plan.export_calls
        eng.refresh(_t(params2), _t(masks2), versions2, donate=donate)
        eng.step()
        [res] = eng.retire(rid)
        tokens[donate] = res.tokens.numpy()
        assert TE._storage(eng.masks) == mask_ptrs
        assert eng.program_count("decode") == programs
        if plan is not None:
            assert plan.export_calls == calls + 1
        if donate:
            assert eng.captures == captures and not res.cold
            if plan is not None:
                assert _ptrs(plan, smoke["treg"]) == ptrs
        else:
            assert eng.captures == captures + (plan is not None)
    np.testing.assert_array_equal(tokens[True], np.asarray(jres.tokens))
    np.testing.assert_array_equal(tokens[False], tokens[True])


def test_engine_refresh_that_moves_max_active_recaptures_once(smoke):
    """condensed_over_active with the active count moved: the leaves are
    rebuilt, the decode program of the new shapes is made once, the result
    that rode it is cold, and the tokens are the reference engine's."""
    jreg, jparams = smoke["jreg"], smoke["jparams"]
    m1, m2 = _ablate(jreg, smoke["jmasks"], 0.5), _ablate(jreg, smoke["jmasks"], 0.25)
    versions, versions2 = {s.name: 0 for s in jreg}, {s.name: 1 for s in jreg}
    prompts = smoke["prompts"]
    jeng = JE.ServingEngine(smoke["jcfg"], jparams, m1, jreg, path="condensed_over_active",
                            mask_versions=dict(versions), gen_chunk=4)
    rid = jeng.submit(jnp.asarray(prompts), 12)
    jeng.step(max_chunks=1)
    jeng.refresh(jparams, m2, versions2, donate=False)
    jeng.step()
    [jres] = jeng.retire(rid)

    eng = _engine(smoke, _t(jparams), _t(m1), path="condensed_over_active",
                  mask_versions=versions)
    rid = eng.submit(prompts, 12)
    eng.step(max_chunks=1)
    programs, captures = eng.program_count("decode"), eng.captures
    eng.refresh(_t(jparams), _t(m2), versions2)
    eng.step()
    [res] = eng.retire(rid)
    assert eng.program_count("decode") == programs + 1
    assert eng.captures == captures + 1 and res.cold
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))


# ---------------------------------------------------------------------------
# the engine owns what it serves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["condensed", "masked"])
def test_engine_serves_its_own_copy_while_the_trainer_steps_in_place(smoke, path):
    """The reference engine and the port's, built from one state (float32
    compute); two port training steps then update the port's state in
    place, with no refresh. Both engines serve the same tokens, as before
    the steps: the port engine serves its own copies."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree.map(np.array, jstate.params)
    jmasks = jax.tree.map(np.array, jstate.masks)
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    prompts = smoke["prompts"]
    jeng = JE.ServingEngine(jcfg, jax.tree.map(jnp.asarray, jparams),
                            jax.tree.map(jnp.asarray, jmasks), smoke["jreg"], path=path,
                            gen_chunk=4)
    teng = _engine(smoke, tstate.params, tstate.masks, path=path)
    rid = teng.submit(prompts, 8)
    teng.step()
    [before] = teng.retire(rid)

    step = TT.make_train_step(tcfg, smoke["treg"], TSc.warmup_cosine(3e-3, 1, 4))
    data = JD.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    embed = tstate.params["embed"].clone()
    for i in range(2):
        tstate, _ = step(tstate, {k: torch.as_tensor(np.asarray(v))
                                  for k, v in data.batch(i).items()})
    assert not torch.equal(tstate.params["embed"], embed)   # the state moved in place

    rid = teng.submit(prompts, 8)
    teng.step()
    [after] = teng.retire(rid)
    jrid = jeng.submit(jnp.asarray(prompts), 8)
    jeng.step()
    [jres] = jeng.retire(jrid)
    np.testing.assert_array_equal(after.tokens.numpy(), before.tokens.numpy())
    np.testing.assert_array_equal(after.tokens.numpy(), np.asarray(jres.tokens))
