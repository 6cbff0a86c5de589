"""Self-draft speculative decoding in the port (``launch/speculative.py``,
the engine's ``spec_round``, ``plan.derive_draft_tree`` /
``price_speculation`` and ``model.paged_verify_step``), on the CPU.

Against the reference, on its smoke qwen3 weights and masks (bridged):
``paged_verify_step``'s logits and pool; the draft trees' kinds and integer
leaves (``out_index``, ``active_index``, ``neuron_active``) exactly; the
``SpecEstimate`` fields under the same profile numbers; the speculative
engine's tokens and ``SpecStats`` integers.

Within the port, the reference's own contract (``tests/test_speculative.py``):
speculative greedy == plain greedy, token for token, on condensed,
structured (ablation-only masks), condensed_over_active, auto with
``force`` and int8 condensed, and under every rollback edge case: every
draft rejected, overshoot into the garbage page with rejection at a page
boundary, admission in mid-generation, a sync update between rounds. The
draft's value tensors are the target's own objects (no extra weight bytes).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import speculative as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import speculative as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import paged as PG  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as REG  # noqa: E402
from repro_torch.sync import DirChannel, Publisher, Subscriber, engine_from_snapshot  # noqa: E402

from _torch_smoke_model import smoke_masks, smoke_model  # noqa: E402

# (path, masks, values_dtype): the configurations speculation is held on
CASES = [("condensed", "plain", None), ("structured", "ablation_only", None),
         ("condensed_over_active", "ablated", None), ("auto", "plain", None),
         ("condensed", "plain", "int8")]


def _prompts(b, t, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _t(tree):
    return bridge.from_jax_numpy({"blocks": {k: np.array(v) for k, v in tree["blocks"].items()}})


@pytest.fixture(scope="module")
def smoke():
    m = smoke_model()
    jm = smoke_masks()
    profile = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                    for f in dataclasses.fields(TP.HardwareProfile)})
    return dict(m, jm=jm, tm={k: _t(v) for k, v in jm.items()}, profile=profile)


def _engine(smoke, path="condensed", masks="plain", spec=None, **kw):
    kw.setdefault("profile", smoke["profile"])
    return TE.ServingEngine(smoke["tcfg"], smoke["tparams"], smoke["tm"][masks], smoke["treg"],
                            path=path, speculative=spec, **kw)


def _spec(gamma=3, ablation=0.5, force=True):
    return SP.SpecConfig(gamma=gamma, draft_ablation=ablation, force=force)


def _serve(eng, prompts, gen):
    rid = eng.submit(prompts, gen)
    eng.step()
    [res] = eng.retire(rid)
    return res


def _serve_all(eng, subs):
    rids = [eng.submit(p, g) for p, g in subs]
    eng.step()
    return [eng.retire(r)[0] for r in rids]


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket,rows", [(8, (5, 2)), (1, (0,))])
def test_paged_verify_step_matches_reference_and_sequential_decode(smoke, bucket, rows):
    """After a bucket-padded prefill, one verify over 4 positions: logits
    and live pages within the paged decode tests' tolerance of the
    reference's, and each position's argmax the argmax of 4 sequential port
    decode steps, bitwise (pools too, at the bucket the engine pads to)."""
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    rng = np.random.default_rng(1)
    t, nb, bs, n = 8, 4, 4, 4
    tokens = np.zeros((bucket, t), np.int32)
    table = np.zeros((bucket, nb), np.int32)
    lens = np.zeros((bucket,), np.int32)
    for i, row in enumerate(rows):
        take = t - 2 * i
        tokens[row, :take] = rng.integers(0, tcfg.vocab_size, take)
        table[row] = 1 + i * nb + np.arange(nb)
        lens[row] = take
    feed = rng.integers(0, tcfg.vocab_size, (bucket, n)).astype(np.int32)
    pages = 1 + len(rows) * nb
    jpool = JM.init_paged_pool(jcfg, pages, bs)
    _, jpool = JM.paged_prefill_step(jcfg, smoke["jparams"], smoke["jmasks"],
                                     {"tokens": jnp.asarray(tokens)}, jpool, jnp.asarray(table),
                                     jnp.asarray(lens))
    jl, jpool = JM.paged_verify_step(jcfg, smoke["jparams"], smoke["jmasks"],
                                     {"tokens": jnp.asarray(feed)}, jpool, jnp.asarray(table),
                                     jnp.asarray(lens))
    tmasks = smoke["tm"]["plain"]
    pool = TM.init_paged_pool(tcfg, pages, bs, device="cpu")
    tab, ln = torch.from_numpy(table), torch.from_numpy(lens)
    TM.paged_prefill_step(tcfg, smoke["tparams"], tmasks, {"tokens": torch.from_numpy(tokens)},
                          pool, tab, ln)
    seq_pool = {k: v.clone() for k, v in pool.items()}
    tl, _ = TM.paged_verify_step(tcfg, smoke["tparams"], tmasks,
                                 {"tokens": torch.from_numpy(feed)}, pool, tab, ln)
    assert tuple(tl.shape) == (bucket, n, tcfg.vocab_padded)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    live = list(range(1, pages))
    for k in ("pk", "pv"):
        np.testing.assert_allclose(pool[k].numpy()[:, live], np.asarray(jpool[k])[:, live],
                                   atol=1e-5, rtol=0)
    seq = torch.stack([TM.paged_decode_step(tcfg, smoke["tparams"], tmasks,
                                            {"tokens": torch.from_numpy(feed[:, i:i + 1])},
                                            seq_pool, tab, ln + i)[0] for i in range(n)], dim=1)
    assert torch.equal(tl.argmax(-1), seq.argmax(-1))
    if bucket > 1:
        assert torch.equal(tl, seq)
        assert all(torch.equal(pool[k], seq_pool[k]) for k in pool)


# ---------------------------------------------------------------------------
# the draft tree and its price, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,masks,values_dtype", CASES)
def test_draft_tree_and_estimate_match_reference(smoke, path, masks, values_dtype):
    """Kinds and integer leaves of the draft tree exactly the reference's;
    every draft value tensor a target tensor object (extra == 0, shared
    bytes the reference's); ``SpecEstimate`` within 1e-6 relative under the
    same profile numbers."""
    jreg, treg = smoke["jreg"], smoke["treg"]
    jmasks = smoke["jm"][masks]
    jeng = JE.ServingEngine(smoke["jcfg"], smoke["jparams"], jmasks, jreg, path=path,
                            values_dtype=values_dtype)
    teng = _engine(smoke, path, masks, values_dtype=values_dtype)
    jkey, tkey = jeng.plan_key(2), teng.plan_key(2)
    assert jkey.formats == tkey.formats
    jtarget = jeng.plan_for(jkey).serving_tree
    ttarget = teng.plan_for(tkey).serving_tree
    jdraft, jrep = JP.derive_draft_tree(jreg, jtarget, smoke["jparams"], jmasks, 0.5)
    tdraft, trep = TP.derive_draft_tree(treg, ttarget, teng.params, teng.masks, 0.5)
    assert trep == jrep
    for js, ts in zip(jreg, treg):
        jl, tl = JR.get_path(jdraft, js.path), REG.get_path(tdraft, ts.path)
        assert type(tl).__name__ == type(jl).__name__
        for f in ("out_index", "active_index", "neuron_active"):
            if getattr(jl, f, None) is not None:
                assert np.array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f))), f
        target = REG.get_path(ttarget, ts.path)
        for f in ("values", "scales"):
            if getattr(tl, f, None) is not None:
                assert getattr(tl, f) is getattr(target, f)
    assert TP.draft_weight_overhead_bytes(treg, ttarget, tdraft) == \
        JP.draft_weight_overhead_bytes(jreg, jtarget, jdraft)
    assert TP.draft_weight_overhead_bytes(treg, ttarget, tdraft)[1] == 0
    jest = JP.price_speculation(jreg, jtarget, jdraft, batch_size=8, gamma=3, acceptance=0.7,
                                profile=JP.DEFAULT_PROFILE)
    test = TP.price_speculation(treg, ttarget, tdraft, batch_size=8, gamma=3, acceptance=0.7,
                                profile=smoke["profile"])
    for f in dataclasses.fields(JP.SpecEstimate):
        assert getattr(test, f.name) == pytest.approx(getattr(jest, f.name), rel=1e-6), f.name
    assert test.worthwhile == jest.worthwhile
    assert test.spec_s_per_token == pytest.approx(jest.spec_s_per_token, rel=1e-6)


def test_expected_tokens_per_dispatch_matches_reference():
    for a in (0.0, 0.3, 0.7, 1.0, 1.5):
        for g in (0, 1, 3, 5):
            assert TP.expected_tokens_per_dispatch(a, g) == \
                pytest.approx(JP.expected_tokens_per_dispatch(a, g), rel=1e-12)


@pytest.mark.parametrize("path,masks", [("condensed", "plain"), ("structured", "ablation_only")])
def test_engine_tokens_and_stats_match_reference_engine(smoke, path, masks):
    """The speculative engine's tokens and SpecStats integers are the
    reference speculative engine's, for a 2-stream and a 1-stream request."""
    subs = [(_prompts(2, 8, 3, smoke["tcfg"].vocab_size), 10),
            (_prompts(1, 6, 4, smoke["tcfg"].vocab_size), 7)]
    jeng = JE.ServingEngine(smoke["jcfg"], smoke["jparams"], smoke["jm"][masks], smoke["jreg"],
                            path=path, speculative=JSP.SpecConfig(gamma=3, draft_ablation=0.5,
                                                                  force=True))
    jrids = [jeng.submit(jnp.asarray(p), g) for p, g in subs]
    jeng.step()
    jres = [jeng.retire(r)[0] for r in jrids]
    tres = _serve_all(_engine(smoke, path, masks, _spec()), subs)
    for j, t in zip(jres, tres):
        assert np.array_equal(t.tokens.numpy(), np.asarray(j.tokens))
        assert {k: t.spec[k] for k in ("rounds", "drafted", "matched", "committed")} == \
            {k: j.spec[k] for k in ("rounds", "drafted", "matched", "committed")}


# ---------------------------------------------------------------------------
# speculative == plain greedy within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,masks,values_dtype", CASES)
def test_spec_tokens_bitwise_equal_plain(smoke, path, masks, values_dtype):
    """Bucket 8 and bucket 1 groups: tokens equal the plain engine's, the
    stats land in ``Result.spec``, one verify per round commits >= 1 token,
    one draft and one verify step per group, and a second wave is warm."""
    vocab = smoke["tcfg"].vocab_size
    subs = [(_prompts(2, 8, 3, vocab), 10), (_prompts(1, 8, 5, vocab), 9)]
    base = _serve_all(_engine(smoke, path, masks, values_dtype=values_dtype), subs)
    eng = _engine(smoke, path, masks, _spec(), values_dtype=values_dtype)
    res = _serve_all(eng, subs)
    for b, r, (p, g) in zip(base, res, subs):
        assert b.spec is None
        assert torch.equal(r.tokens, b.tokens)
        assert r.spec["committed"] == p.shape[0] * g
        assert 1 <= r.spec["rounds"] <= g
        assert r.spec["full_dispatches_per_token"] <= 1.0
    assert eng.program_count("draft") == eng.program_count("verify") == 2
    assert eng.program_count("decode") == 0
    again = _serve_all(eng, subs)
    assert [torch.equal(a.tokens, r.tokens) for a, r in zip(again, res)] == [True, True]
    assert not any(a.cold for a in again)
    assert eng.program_count("draft") == eng.program_count("verify") == 2
    # every page went back to the pool
    for runner in eng._runners.values():
        assert runner.alloc.available == runner.num_blocks - 1


def test_acceptance_is_one_at_draft_ablation_zero(smoke):
    """A draft at ablation 0 is the target itself (through K4's sentinel
    form): every draft accepted, one verify per gamma + 1 tokens."""
    p = _prompts(2, 8, 3, smoke["tcfg"].vocab_size)
    base = _serve(_engine(smoke), p, 12)
    res = _serve(_engine(smoke, spec=_spec(ablation=0.0)), p, 12)
    assert torch.equal(res.tokens, base.tokens)
    assert res.spec["acceptance_rate"] == 1.0
    assert res.spec["rounds"] == 3
    assert res.spec["full_dispatches_per_token"] == pytest.approx(1 / 4)


def test_draft_tree_shares_every_value_tensor(smoke):
    eng = _engine(smoke, spec=_spec(gamma=2))
    key = eng.plan_key(2)
    draft = eng.draft_tree_for(key)
    target = eng.serving_tree_for(key)
    shared, extra = TP.draft_weight_overhead_bytes(smoke["treg"], target, draft)
    assert extra == 0 and shared > 0
    assert set(eng._draft_reports[key].values()) == {"sentinel"}


# ---------------------------------------------------------------------------
# rewind edge cases (the reference's tests/test_speculative.py)
# ---------------------------------------------------------------------------

def test_all_drafts_rejected_every_round(smoke, monkeypatch):
    """A draft corrupted after its dispatch (every guess + 1) is rejected
    every round: one token a round, the drafted KV rewound each time, and
    the tokens still plain greedy's."""
    vocab = smoke["tcfg"].vocab_size
    p = _prompts(2, 8, 5, vocab)
    base = _serve(_engine(smoke), p, 8)
    eng = _engine(smoke, spec=_spec())
    real = TE._Decoder.run

    def run(decoder, n):
        real(decoder, n)
        if any(decoder is r.draft for r in eng._runners.values()):
            st = decoder.state
            st.toks[:, 1:n].copy_((st.toks[:, 1:n] + 1) % vocab)
            st.cur.copy_((st.cur + 1) % vocab)

    monkeypatch.setattr(TE._Decoder, "run", run)
    res = _serve(eng, p, 8)
    assert torch.equal(res.tokens, base.tokens)
    assert res.spec["acceptance_rate"] < 0.2
    assert res.spec["rounds"] >= 8 - 1
    # each rejection recorded where the target's pick beat the draft's, at
    # a generated token the stream emits
    assert res.spec["rejected"]
    assert all(0 <= i < 2 and 1 <= q < 8 for i, q in res.spec["rejected"])


def test_overshoot_into_garbage_page_and_boundary_rejection(smoke, monkeypatch):
    """No overshoot page is ever granted (the allocator is starved after
    admission) and pages hold 2 tokens: draft and verify writes past the
    held pages clamp into the garbage page, commits are capped at the held
    capacity, and the tokens are still plain greedy's."""
    p = _prompts(2, 8, 7, smoke["tcfg"].vocab_size)
    base = _serve(_engine(smoke, block_size=2), p, 6)
    real_alloc = PG.BlockAllocator.alloc
    left = {"n": 2}                     # one alloc call per admitted row

    def starved(self, n):
        if left["n"] <= 0:
            raise RuntimeError("paged KV pool exhausted (test starvation)")
        left["n"] -= 1
        return real_alloc(self, n)

    monkeypatch.setattr(PG.BlockAllocator, "alloc", starved)
    res = _serve(_engine(smoke, block_size=2, spec=_spec()), p, 6)
    assert torch.equal(res.tokens, base.tokens)
    assert res.spec["committed"] == 2 * 6


def test_mid_generation_admission_interleaves_with_rollback(smoke):
    vocab = smoke["tcfg"].vocab_size
    pa, pb = _prompts(1, 8, 11, vocab), _prompts(1, 8, 13, vocab)
    base = _engine(smoke)
    ra, rb = _serve(base, pa, 10), _serve(base, pb, 6)
    eng = _engine(smoke, spec=_spec())
    rid_a = eng.submit(pa, 10)
    eng.step(max_chunks=2)              # a is mid-generation, rollbacks live
    rid_b = eng.submit(pb, 6)           # joins at the next round boundary
    for _ in range(32):
        eng.step(max_chunks=1)
        if len(eng._done) == 2:
            break
    [res_a], [res_b] = eng.retire(rid_a), eng.retire(rid_b)
    assert torch.equal(res_a.tokens, ra.tokens)
    assert torch.equal(res_b.tokens, rb.tokens)


def test_sync_update_between_rounds_stays_bitwise(smoke, tmp_path):
    """A published update adopted between rounds drops the cached draft,
    which is derived again from the new weights; the stream equals a plain
    engine refreshed with the same weights at the same committed length."""
    treg = smoke["treg"]
    versions = {s.name: 0 for s in treg}
    params, masks = smoke["tparams"], smoke["tm"]["plain"]
    prompts = _prompts(2, 8, 17, smoke["tcfg"].vocab_size)
    ch = DirChannel(str(tmp_path))
    pub = Publisher(smoke["tcfg"], treg, ch, path="condensed", batch_size=2)
    pub.publish(params=params, masks=masks, mask_versions=versions)
    sub = Subscriber(ch.subscribe("r0"))
    eng = engine_from_snapshot(smoke["tcfg"], sub, registry=treg, device="cpu",
                               profile=smoke["profile"], speculative=_spec())
    rid = eng.submit(prompts, 16)
    eng.step(max_chunks=2)
    key = eng.plan_key(2)
    runner = eng._runners[key]
    committed = int(runner.lengths[runner.active[rid].rows[0]]) - 8
    assert 2 <= committed <= 8
    old_draft = eng.draft_tree_for(key)

    s0 = treg[0]
    masks2 = {"blocks": dict(masks["blocks"])}
    REG.set_path(masks2, s0.path, torch.roll(REG.get_path(masks, s0.path), 1, dims=-2))
    params2 = {k: ({n: v * 1.01 for n, v in t.items()} if isinstance(t, dict) else t * 1.01)
               for k, t in params.items()}
    versions2 = dict(versions, **{s0.name: 1})
    pub.publish(params=params2, masks=masks2, mask_versions=versions2)
    old_index = {s.name: REG.get_path(old_draft, s.path).out_index.clone() for s in treg}
    captures = eng.captures
    eng.step()
    [res] = eng.retire(rid)
    assert eng._sync_generation == 2
    # the draft was derived again and written into the old draft's tensors
    # (the shapes held), so no graph was made again
    draft = eng.draft_tree_for(key)
    assert draft is old_draft
    assert eng.captures == captures
    fresh, _ = TP.derive_draft_tree(treg, eng.serving_tree_for(key), eng.params, eng.masks,
                                    0.5)
    for s in treg:
        assert torch.equal(REG.get_path(draft, s.path).out_index,
                           REG.get_path(fresh, s.path).out_index)
    assert any(not torch.equal(REG.get_path(draft, s.path).out_index, old_index[s.name])
               for s in treg)
    assert res.spec["committed"] == 2 * 16

    ref = _engine(smoke, mask_versions=dict(versions), gen_chunk=1)
    rid2 = ref.submit(prompts, 16)
    ref.step(max_chunks=committed)
    ref.refresh(params2, masks2, versions2, donate=False)
    ref.step()
    [res2] = ref.retire(rid2)
    assert res2.spec is None
    assert torch.equal(res.tokens, res2.tokens)


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------

def test_speculative_refuses_masked_and_unpaged(smoke):
    sc = _spec(gamma=2, force=False)
    with pytest.raises(ValueError, match="masked"):
        _engine(smoke, "masked", spec=sc)
    with pytest.raises(ValueError, match="paged"):
        _engine(smoke, paged=False, spec=sc)
    with pytest.raises(ValueError, match="gamma"):
        SP.SpecConfig(gamma=0)


def test_auto_can_decline_speculation(smoke):
    """``--path auto`` without ``force`` keeps the price in charge: a key
    whose price declines serves plain decode and keeps its estimate; a price
    made to favour the draft (acceptance 1 and a draft step priced at 0)
    runs it."""
    p = _prompts(2, 8, 19, smoke["tcfg"].vocab_size)
    eng = _engine(smoke, "auto", spec=_spec(force=False))
    res = _serve(eng, p, 6)
    est = eng.spec_estimate_for(res.plan_key)
    assert est is not None
    assert (eng.draft_tree_for(res.plan_key) is None) == (not est.worthwhile)
    assert (res.spec is None) == (not est.worthwhile)
    declined = dataclasses.replace(est, draft_step_s=est.target_step_s,
                                   verify_s=4 * est.target_step_s, acceptance=0.0,
                                   expected_tokens=1.0)
    assert not declined.worthwhile
    assert dataclasses.replace(est, draft_step_s=0.0, expected_tokens=4.0,
                               verify_s=est.target_step_s).worthwhile


def test_a_dropped_engine_is_freed_without_the_cyclic_collector(smoke):
    """An engine and its runners hold no cycle (a runner reaches its engine
    by a weak reference), so dropping a speculative engine that served frees
    it, its runners and their steps at once, with the cyclic collector off:
    a graph is never destroyed by a collection that runs inside another
    capture."""
    import gc
    import weakref
    eng = _engine(smoke, spec=_spec())
    _serve(eng, _prompts(2, 8, 23, smoke["tcfg"].vocab_size), 4)
    [runner] = eng._runners.values()
    refs = [weakref.ref(o) for o in (eng, runner, runner.decoder or runner.draft,
                                      runner.verify, runner.state)]
    gc.disable()
    try:
        del eng, runner
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_a_refresh_with_new_shapes_remakes_the_draft_and_counts_it(smoke):
    """A refresh whose export changes a condensed leaf's fan-in (k) cannot be
    written in place: the draft is derived anew into new tensors, its step and
    the verify's are made again, and ``captures`` counts both."""
    treg = smoke["treg"]
    versions = {s.name: 0 for s in treg}
    masks = smoke["tm"]["plain"]
    prompts = _prompts(2, 8, 29, smoke["tcfg"].vocab_size)
    eng = _engine(smoke, spec=_spec(), mask_versions=dict(versions))
    rid = eng.submit(prompts, 12)
    eng.step(max_chunks=1)
    key = eng.plan_key(2)
    old_draft = eng.draft_tree_for(key)
    captures = eng.captures
    s0 = treg[0]
    m0 = REG.get_path(masks, s0.path)
    masks2 = {"blocks": dict(masks["blocks"])}
    REG.set_path(masks2, s0.path, m0 | torch.roll(m0, 1, dims=-2))    # a wider fan-in
    eng.refresh(smoke["tparams"], masks2, dict(versions, **{s0.name: 1}))
    eng.step()
    [res] = eng.retire(rid)
    assert eng.draft_tree_for(key) is not old_draft
    assert eng.captures == captures + 2
    assert res.spec["committed"] == 2 * 12


def test_spec_dispatch_off_the_cpu_never_runs_eagerly():
    """A draft or verify step whose state is not on the CPU and has no
    captured graph raises instead of running eagerly."""
    st = TE._new_state(1, 4, "meta")
    with pytest.raises(RuntimeError, match="captured graph"):
        TE._Decoder(lambda: None, st).run(3)     # gamma draft steps
    with pytest.raises(RuntimeError, match="captured graph"):
        TE._Decoder(lambda: None, st).run(1)     # one verify
