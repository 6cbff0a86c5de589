"""A live-sync drain on stacks with two leading axes against the JAX
reference, on the CPU: gemma3's ``g_local`` (g, r) and granite-moe's expert
stacks (L, E) at smoke size, the reference's weights and masks bridged from
``PRNGKey(0)`` (``tests/_torch_zoo_model.py``).

A drain of a generation with one two-axis stack rewired, into an engine
built from the stream, serves the tokens of the reference engine refreshed
with the same trees, mid-request on granite's paged engine and between
requests on gemma3's slab engine, every leaf written in place and no
decode step made again. The wire itself is in
``tests/test_torch_lead2_sync.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.sync import DirChannel, Publisher, Subscriber  # noqa: E402
from repro_torch.sync import engine_from_snapshot  # noqa: E402

from _torch_zoo_model import _model, _prompts, rewired_generation, to_port  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
CASES = [("gemma3-1b", "g_local/w_down"), (GRANITE, "blocks/w_gate")]
IDS = ["gemma3", "granite"]


@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_engine_sync_drain_equals_the_reference_refresh(tmp_path, arch, name):
    m = _model(arch, ())
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    prompts = _prompts(m["tcfg"], 2, 8, seed=3)
    ch = DirChannel(str(tmp_path))
    pub = Publisher(m["tcfg"], m["treg"], ch, path="condensed", batch_size=2)
    pub.publish(params=to_port(m["jparams"]), masks=to_port(m["jmasks"]),
                mask_versions=dict(versions))
    eng = engine_from_snapshot(m["tcfg"], Subscriber(ch.subscribe("r0")), registry=m["treg"],
                               device="cpu", gen_chunk=4)
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed",
                            mask_versions=dict(versions), gen_chunk=4)
    paged = eng.paged
    assert paged == (arch == GRANITE)
    # granite: half a request, the drain at the chunk boundary, the rest;
    # gemma3's slab engine serves a request in one dispatch: the drain runs
    # at the top of the next request's step
    rids = [eng.submit(prompts, 16)]
    jrids = [jeng.submit(jnp.asarray(prompts), 16)]
    eng.step(max_chunks=2)
    jeng.step(max_chunks=2)
    plan = eng.plan_for(eng.plan_key(2))
    ptrs = TE._storage(plan.serving_tree)
    captures = eng.captures
    decoders = dict(eng._legacy_decoders.get(eng.plan_key(2), {}))
    info = pub.publish(params=to_port(params2), masks=to_port(masks2),
                       mask_versions=dict(versions2))
    assert info["topology"] == [name]
    jeng.refresh(params2, masks2, versions2, donate=False)
    if not paged:
        rids.append(eng.submit(prompts, 16))
        jrids.append(jeng.submit(jnp.asarray(prompts), 16))
    eng.step()
    jeng.step()
    assert eng._sync_generation == 2 and eng.last_drain_s > 0
    for rid, jrid in zip(rids, jrids):
        [res], [jres] = eng.retire(rid), jeng.retire(jrid)
        np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert not res.cold     # the request served after the drain made no decode step
    assert TE._storage(plan.serving_tree) == ptrs
    assert eng.captures == captures
    if not paged:
        assert eng._legacy_decoders[eng.plan_key(2)] == decoders
    s = next(s for s in m["treg"] if s.name == name)
    want = TR.get_path(TE.PLAN.build_plan(m["tcfg"], m["treg"], to_port(params2), to_port(masks2),
                                          batch_size=2, path="condensed").serving_tree, s.path)
    got = TR.get_path(plan.serving_tree, s.path)
    for f, t in want.arrays().items():
        assert torch.equal(getattr(got, f), t), f
