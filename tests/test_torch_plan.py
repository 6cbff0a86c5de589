"""The port's serving plans against the reference's ``repro.sparse.plan``.

Both sides get the same smoke qwen3 weights and masks (the reference's,
bridged through numpy) and the same hardware rates: the port's
``HardwareProfile`` is fed the reference ``DEFAULT_PROFILE``'s values here,
in the test, so that the cost tables can be compared; the port's own
default carries H100 rates. Decisions, cost tables, stats and plan text
must be equal, and the exported leaves' integer arrays identical.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import autotune as JAT  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

ARCH = "qwen3-1.7b"
BATCHES = (1, 8, 256)
MASK_KINDS = ("plain", "ablated", "ablation_only")
INT_FIELDS = ("indices", "out_index", "active_index", "neuron_active", "mask")


def _ablate(reg, masks, frac, only):
    """The reference tests' helpers: the last ``frac`` of each stack's
    neurons ablated on top of the masks, or masks of pure ablation."""
    out = {}
    for s in reg:
        m = JR.get_path(masks, s.path)
        cut = s.d_out - max(1, int(s.d_out * frac))
        col = (jnp.arange(s.d_out) < cut)[None, :]
        JR._set_path(out, s.path, jnp.broadcast_to(col, m.shape) if only else m & col)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    jreg = JR.build_registry(jcfg)
    jparams = JM.init_params(jcfg, key, JR.k_fan_map(jcfg, jreg))
    jmasks = JR.init_sparsity_state(jcfg, key, jreg)["masks"]
    masks = {"plain": jmasks, "ablated": _ablate(jreg, jmasks, 0.25, False),
             "ablation_only": _ablate(jreg, jmasks, 0.25, True)}
    tcfg = tconfigs.get_smoke_config(ARCH)
    profile = TP.HardwareProfile(**{
        f.name: getattr(JP.DEFAULT_PROFILE, f.name)
        for f in dataclasses.fields(TP.HardwareProfile)})
    return dict(jcfg=jcfg, jreg=jreg, jparams=jparams, masks=masks, tcfg=tcfg,
                treg=TR.build_registry(tcfg),
                tparams=bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams)),
                tmasks={k: bridge.from_jax_numpy(jax.tree.map(np.asarray, m))
                        for k, m in masks.items()},
                profile=profile)


def _plans(r, kind, batch, path="auto"):
    jplan = JP.build_plan(r["jcfg"], r["jreg"], r["jparams"], r["masks"][kind],
                          batch_size=batch, path=path)
    tplan = TP.build_plan(r["tcfg"], r["treg"], r["tparams"], r["tmasks"][kind],
                          batch_size=batch, path=path, profile=r["profile"])
    return jplan, tplan


def _assert_leaves_equal(jleaf, tleaf):
    assert type(tleaf).format_name == type(jleaf).format_name
    for f in INT_FIELDS:
        if hasattr(tleaf, f):
            np.testing.assert_array_equal(getattr(tleaf, f).numpy(),
                                          np.asarray(getattr(jleaf, f)), err_msg=f)
    if getattr(tleaf, "values", None) is not None:
        np.testing.assert_allclose(tleaf.values.numpy(), np.asarray(jleaf.values), rtol=1e-6)
    elif hasattr(tleaf, "values"):  # a float structured leaf stores no panel, as there
        assert jleaf.values is None


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("batch", BATCHES)
def test_auto_plan_equals_reference(setup, kind, batch):
    r = setup
    jplan, tplan = _plans(r, kind, batch)
    assert list(tplan.decisions) == list(jplan.decisions)
    for name, jdec in jplan.decisions.items():
        tdec = tplan.decisions[name]
        assert tdec.representation == jdec.representation, name
        assert tuple(tdec.stats) == pytest.approx(tuple(jdec.stats))
        assert tdec.est_s.keys() == jdec.est_s.keys()
        for rep, s in jdec.est_s.items():
            assert tdec.est_s[rep] == pytest.approx(s, rel=1e-12), (name, rep)
    for s in r["jreg"]:
        _assert_leaves_equal(JR.get_path(jplan.serving_tree, s.path),
                             TR.get_path(tplan.serving_tree, s.path))
    assert tplan.weight_bytes() == jplan.weight_bytes()
    assert tplan.describe(requested_batch=3) == jplan.describe(requested_batch=3)


@pytest.mark.parametrize("path", ["masked", "condensed", "structured",
                                  "condensed_over_active"])
def test_forced_plans_export_the_reference_layouts(setup, path):
    r = setup
    jplan, tplan = _plans(r, "ablated", 8, path)
    for s in r["jreg"]:
        assert tplan.representation_of(s.name) == path
        _assert_leaves_equal(JR.get_path(jplan.serving_tree, s.path),
                             TR.get_path(tplan.serving_tree, s.path))
    # the value-storing formats keep their values at the compute dtype
    leaf = TR.get_path(tplan.serving_tree, r["treg"][0].path)
    if getattr(leaf, "values", None) is not None:
        assert leaf.values.dtype == getattr(torch, r["tcfg"].dtype)


def test_batch_buckets_match_reference():
    assert TP.BATCH_BUCKETS == JAT.BATCH_BUCKETS
    for b in (1, 2, 7, 8, 9, 31, 32, 33, 128, 129, 2048, 2049, 9000, 40000):
        assert TP.batch_bucket(b) == JAT.batch_bucket(b), b


def test_gather_rate_interpolates_as_the_reference():
    kw = dict(name="two-point", hbm_bytes_per_s=1e12, mxu_flops_per_s=1e14,
              gather_flops_per_s=2e12, gather_flops_per_s_large=5e11)
    jprof, tprof = JP.HardwareProfile(**kw), TP.HardwareProfile(**kw)
    for b in (1, 8, 9, 64, 511, 512, 4096):
        assert tprof.gather_rate(b) == pytest.approx(jprof.gather_rate(b), rel=1e-12)


def test_structured_joins_auto_only_for_ablation_only_stacks(setup):
    """structured keeps active columns dense: auto may pick it only where
    every surviving column is fully dense (with the port's own rates)."""
    r = setup
    for kind in MASK_KINDS:
        for s in r["treg"]:
            stats = TF.realized_stats(TR.get_path(r["tmasks"][kind], s.path))
            for batch in (1, 8, 64, 256):
                dec = TP.select_representation(s, batch_size=batch, itemsize=4, stats=stats)
                cands = {"masked", "condensed"}
                if kind != "plain":
                    cands.add("condensed_over_active")
                if kind == "ablation_only":
                    cands.add("structured")
                assert dec.representation in cands
                assert dec.est_s[dec.representation] == min(dec.est_s[c] for c in cands)


def test_default_profile_is_the_h100s(setup):
    p = TP.DEFAULT_PROFILE
    assert (p.name, p.hbm_bytes_per_s, p.mxu_flops_per_s) == ("h100-sxm", 3.35e12, 989e12)
    assert all(getattr(p, f.name) != getattr(JP.DEFAULT_PROFILE, f.name)
               for f in dataclasses.fields(TP.HardwareProfile)
               if f.name in ("name", "hbm_bytes_per_s", "mxu_flops_per_s",
                             "gather_flops_per_s"))


def test_build_plan_rejects_unknown_path(setup):
    r = setup
    with pytest.raises(ValueError, match="unknown serving path"):
        TP.build_plan(r["tcfg"], r["treg"], r["tparams"], r["tmasks"]["plain"], path="csr")
