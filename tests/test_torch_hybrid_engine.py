"""The hybrid family (zamba2-7b smoke: two groups of two Mamba2 layers, each
followed by the shared attention + MLP block, then one more layer) served
against the JAX reference on the CPU.

The slab engine (``paged=None`` picks it: SSM state has no paged form;
``paged=True`` and speculative decoding are refused, as in the reference)
gives the reference engine's tokens on masked, condensed, int8 condensed
and auto, and again for a request repeated through the same captured
decode step. A refresh of the shared block's ``w_down`` (no leading axis)
and of an ``m_groups`` stack (lead (g, r)) between two requests, and a
live-sync drain of the shared stack, serve the reference
engine's tokens on the new weights, every plan leaf written in place and
no decode step made again. The model itself is in
``tests/test_torch_hybrid.py``; plans, formats, the launch search, the
trainer and the CLIs in ``tests/test_torch_hybrid_plan.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import speculative as JSP  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import speculative as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.sync import DirChannel, Publisher, Subscriber  # noqa: E402
from repro_torch.sync import engine_from_snapshot  # noqa: E402

from _torch_zoo_model import _model, _prompts, rewired_generation, to_port  # noqa: E402

ARCH = "zamba2-7b"


def _engines(m, path, values_dtype=None, **kw):
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path=path,
                            values_dtype=values_dtype, **kw)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path=path,
                            values_dtype=values_dtype, **kw)
    return jeng, teng


@pytest.mark.parametrize("path,values_dtype", [("masked", None), ("condensed", None),
                                               ("condensed", "int8"), ("auto", None)])
def test_slab_engine_tokens_equal_the_reference_engine(path, values_dtype):
    """Two requests of one shape (fused into one slab, 18 tokens: one full
    SSD chunk and a padded one): the reference engine's tokens, then a
    repeat of the second through the same captured decode step (its SSM
    state zeroed at prefill)."""
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    reqs = [(_prompts(cfg, 2, 18, seed=1), 6), (_prompts(cfg, 1, 18, seed=2), 6)]
    jeng, teng = _engines(m, path, values_dtype)
    assert not teng.paged and not jeng.paged
    out = []
    for eng, to in ((jeng, jnp.asarray), (teng, torch.from_numpy)):
        ids = [eng.submit(to(p), g) for p, g in reqs]
        eng.step()
        res = {r.id: r for r in eng.retire()}
        out.append([np.asarray(res[i].tokens) for i in ids])
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)
    key = teng.plan_key(3)
    decoders = dict(teng._legacy_decoders[key])
    rid = teng.submit(reqs[1][0], reqs[1][1])
    teng.step()
    [res] = teng.retire(rid)
    np.testing.assert_array_equal(res.tokens.numpy(), out[1][1])
    assert teng._legacy_decoders[key] == decoders and not res.cold


def test_paged_and_speculative_serving_are_refused_as_in_the_reference():
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    assert not TM.supports_paged(cfg)
    with pytest.raises(ValueError, match="paged serving requires"):
        TE.ServingEngine(cfg, m["tparams"], m["tmasks"], m["treg"], paged=True)
    with pytest.raises(ValueError, match="paged pool serves"):
        TM.init_paged_pool(cfg, 4, 4, "cpu")
    with pytest.raises(ValueError, match="speculative decoding runs on the paged"):
        TE.ServingEngine(cfg, m["tparams"], m["tmasks"], m["treg"], path="condensed",
                         speculative=SP.SpecConfig(gamma=2))
    with pytest.raises(ValueError, match="speculative decoding runs on the paged"):
        JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed",
                         speculative=JSP.SpecConfig(gamma=2))


@pytest.mark.parametrize("name", ["shared_attn/w_down", "m_groups/in_x"])
def test_engine_refresh_between_requests_equals_the_reference(name):
    """A request, a refresh of one stack (the shared block's, lead (); or a
    Mamba2 group stack, lead (g, r)), the same request again: the reference
    engine's tokens both times (the slab engine serves a request in one
    dispatch, so the refresh lands between the two), every plan leaf in its
    own storage and no decode step captured again."""
    m = _model(ARCH, ())
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    prompts = _prompts(m["tcfg"], 2, 12, seed=5)
    jeng, teng = _engines(m, "condensed", mask_versions=dict(versions), gen_chunk=4)
    out = []
    for eng, p in ((jeng, jnp.asarray(prompts)), (teng, prompts)):
        r1 = eng.submit(p, 8)
        eng.step()
        out.append([np.asarray(eng.retire(r1)[0].tokens)])
    plan = teng.plan_for(teng.plan_key(2))
    ptrs = TE._storage(plan.serving_tree)
    decoders = dict(teng._legacy_decoders[teng.plan_key(2)])
    jchanged = jeng.refresh(params2, masks2, versions2, donate=False)
    tchanged = teng.refresh(to_port(params2), to_port(masks2), versions2)
    assert list(tchanged.values()) == list(jchanged.values()) == [[name]]
    for i, (eng, p) in enumerate(((jeng, jnp.asarray(prompts)), (teng, prompts))):
        r2 = eng.submit(p, 8)
        eng.step()
        out[i].append(np.asarray(eng.retire(r2)[0].tokens))
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)
    assert TE._storage(plan.serving_tree) == ptrs
    assert teng._legacy_decoders[teng.plan_key(2)] == decoders
    assert not np.array_equal(out[1][0], out[1][1])  # the new weights serve


def test_engine_sync_drain_of_the_shared_stack_equals_the_reference_refresh(tmp_path):
    """A port ``Publisher`` streams a snapshot, then a generation with the
    shared block's ``w_down`` rewired (its records carry a stack with no
    leading axis); an engine built from the stream drains it between two
    requests: the reference engine's tokens on the new weights, the drained
    leaf equal to a fresh export, written in place, no decode step made
    again."""
    m = _model(ARCH, ())
    name = "shared_attn/w_down"
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    prompts = _prompts(m["tcfg"], 2, 8, seed=3)
    ch = DirChannel(str(tmp_path))
    pub = Publisher(m["tcfg"], m["treg"], ch, path="condensed", batch_size=2)
    pub.publish(params=to_port(m["jparams"]), masks=to_port(m["jmasks"]),
                mask_versions=dict(versions))
    eng = engine_from_snapshot(m["tcfg"], Subscriber(ch.subscribe("r0")), registry=m["treg"],
                               device="cpu", gen_chunk=4)
    assert not eng.paged
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed",
                            mask_versions=dict(versions), gen_chunk=4)
    rids = [eng.submit(prompts, 8)]
    jrids = [jeng.submit(jnp.asarray(prompts), 8)]
    eng.step()
    jeng.step()
    plan = eng.plan_for(eng.plan_key(2))
    ptrs = TE._storage(plan.serving_tree)
    decoders = dict(eng._legacy_decoders[eng.plan_key(2)])
    info = pub.publish(params=to_port(params2), masks=to_port(masks2),
                       mask_versions=dict(versions2))
    assert info["topology"] == [name]
    jeng.refresh(params2, masks2, versions2, donate=False)
    rids.append(eng.submit(prompts, 8))
    jrids.append(jeng.submit(jnp.asarray(prompts), 8))
    eng.step()
    jeng.step()
    assert eng._sync_generation == 2 and eng.last_drain_s > 0
    for rid, jrid in zip(rids, jrids):
        [res], [jres] = eng.retire(rid), jeng.retire(jrid)
        np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert not res.cold
    assert TE._storage(plan.serving_tree) == ptrs
    assert eng._legacy_decoders[eng.plan_key(2)] == decoders
    s = next(s for s in m["treg"] if s.name == name)
    assert s.lead == ()
    want = TR.get_path(TE.PLAN.build_plan(m["tcfg"], m["treg"], to_port(params2),
                                          to_port(masks2), batch_size=2,
                                          path="condensed").serving_tree, s.path)
    got = TR.get_path(plan.serving_tree, s.path)
    for f, t in want.arrays().items():
        assert torch.equal(getattr(got, f), t), f
