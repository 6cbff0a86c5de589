"""``ServingEngine.refresh`` on stacks with two leading axes against the
JAX reference engine, on the CPU: granite-moe's expert stacks (L, E) and
gemma3's ``g_local`` (g, r) at smoke size (and at 8 layers, rem 2), the
reference's weights and masks bridged from ``PRNGKey(0)``
(``tests/_torch_zoo_model.py``), one two-axis stack rewired and every float
param trained on.

On granite's paged engine the refresh lands mid-request at a chunk
boundary; on gemma3's slab engine, which serves a request in one dispatch,
between two requests. Tokens equal the reference engine's exactly; every
same-shape leaf and the masks keep their storage and no decode step is
made again (the slab engine keeps its captured steps).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import _model, _prompts, rewired_generation, to_port  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})


def _ptrs(plan, reg):
    return {s.name: {f: t.data_ptr() for f, t in TR.get_path(plan.serving_tree, s.path)
                     .arrays().items()} for s in reg}


def _engines(m, path, values_dtype, versions):
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path=path,
                            mask_versions=dict(versions), gen_chunk=4,
                            values_dtype=values_dtype)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path=path,
                            mask_versions=dict(versions), gen_chunk=4,
                            values_dtype=values_dtype, profile=PROFILE)
    return jeng, teng


@pytest.mark.parametrize("path,values_dtype", [("condensed", None), ("condensed", "int8"),
                                               ("masked", None)])
def test_moe_engine_refresh_mid_request_equals_the_reference(path, values_dtype):
    """Half of a 16-token request, ``refresh`` with one expert stack
    rewired at the chunk boundary, the rest: the reference engine's tokens;
    every leaf and mask kept in place and no decode step made again."""
    m = _model(GRANITE, ())
    versions, params2, masks2, versions2 = rewired_generation(m, "blocks/w_gate")
    prompts = _prompts(m["tcfg"], 2, 8, seed=1)
    jeng, teng = _engines(m, path, values_dtype, versions)
    rid = jeng.submit(jnp.asarray(prompts), 16)
    jeng.step(max_chunks=2)
    jeng.refresh(params2, masks2, versions2, donate=False)
    jeng.step()
    [jres] = jeng.retire(rid)

    assert teng.paged
    rid = teng.submit(prompts, 16)
    teng.step(max_chunks=2)
    plan = None if path == "masked" else teng.plan_for(teng.plan_key(2))
    ptrs = None if plan is None else _ptrs(plan, m["treg"])
    mask_ptrs = TE._storage(teng.masks)
    captures = teng.captures
    changed = teng.refresh(to_port(params2), to_port(masks2), versions2)
    teng.step()
    [res] = teng.retire(rid)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert teng.captures == captures and not res.cold
    assert TE._storage(teng.masks) == mask_ptrs
    if plan is not None:
        assert [n for names in changed.values() for n in names] == ["blocks/w_gate"]
        assert _ptrs(plan, m["treg"]) == ptrs


@pytest.mark.parametrize("kw,path,values_dtype", [
    ((), "condensed", None), ((), "condensed", "int8"), ((), "auto", None),
    ((("n_layers", 8),), "condensed", None)],
    ids=["gemma3-condensed", "gemma3-int8", "gemma3-auto", "gemma3-rem2-condensed"])
def test_gemma3_slab_engine_refresh_equals_the_reference(kw, path, values_dtype):
    """The slab engine serves a request in one dispatch: a request, a
    refresh with one (g, r) stack rewired, a second request, whose tokens
    are the reference engine's after its refresh; the captured decode step
    of the first request's signature serves the second (nothing rebuilt)."""
    m = _model("gemma3-1b", kw)
    versions, params2, masks2, versions2 = rewired_generation(m, "g_local/w_down")
    prompts = _prompts(m["tcfg"], 2, 12, seed=2)
    jeng, teng = _engines(m, path, values_dtype, versions)
    toks = {}
    for name, eng, p in (("ref", jeng, jnp.asarray(prompts)), ("port", teng, prompts)):
        r1 = eng.submit(p, 6)
        eng.step()
        if name == "port":
            assert not teng.paged
            key = teng.plan_key(2)
            plan = teng.plan_for(key)
            ptrs = _ptrs(plan, m["treg"])
            decoders = dict(teng._legacy_decoders[key])
            calls = plan.export_calls
            eng.refresh(to_port(params2), to_port(masks2), versions2)
        else:
            eng.refresh(params2, masks2, versions2, donate=False)
        r2 = eng.submit(p, 6)
        eng.step()
        toks[name] = [np.asarray(eng.retire(r)[0].tokens) for r in (r1, r2)]
    for want, got in zip(toks["ref"], toks["port"]):
        np.testing.assert_array_equal(got, want)
    assert plan.export_calls == calls + 1
    assert _ptrs(plan, m["treg"]) == ptrs
    assert teng._legacy_decoders[key] == decoders
