"""Self-draft speculative decoding on the MoE family (granite-moe-1b at smoke
dims) against the JAX reference on the CPU.

The reference's weights and masks (``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Held to the reference:
``paged_verify_step``'s logits (float32, within 1e-5) at buckets 1 and 8;
the speculative engine's tokens and ``SpecStats`` counts on condensed at
draft ablation 0.5 and 0.0 and on condensed_over_active with half of every
expert's neurons ablated; the draft trees' kinds and integer leaves, their
weight overhead, ``price_speculation`` and ``auto``'s accept or decline; and
the serve CLI's ``--speculative`` stream.

A verify routes its B * (gamma + 1) rows as one group, as the reference's
does, so its capacity drops need not be the decode steps' (a kept quirk of
the reference's, ROADMAP section 3): with a capacity factor that drops
nothing the verify's argmax is that of gamma + 1 sequential decode steps.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import speculative as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import speculative as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import TOL, _model, _prompts  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})
STATS = ("rounds", "drafted", "matched", "committed")


@functools.lru_cache(maxsize=None)
def _masks(kind: str):
    """(the port's masks, the reference's): the SRigL masks (``plain``),
    the same with the first half of every stack's neurons emptied
    (``ablated``), or every input of the second half's neurons kept
    (``ablation_only``: whole columns, no fine-grained sparsity)."""
    m = _model(GRANITE, ())
    if kind == "plain":
        return m["tmasks"], m["jmasks"]
    masks = bridge.from_jax_numpy(bridge.to_jax_numpy(m["tmasks"]))
    for s in m["treg"]:
        mask = TR.get_path(masks, s.path)
        if kind == "ablation_only":
            mask[...] = True
        mask[..., : s.d_out // 2] = False
    return masks, jax.tree.map(jnp.asarray, bridge.to_jax_numpy(masks))


def _verify_pair(cfg_kw: tuple, bucket: int, rows: tuple):
    """A bucket-padded paged prefill, then one verify over 4 positions, in
    the reference and in the port, and 4 sequential port decode steps from
    the same pool: (reference logits, port logits, sequential logits)."""
    m = _model(GRANITE, cfg_kw)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
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
    _, jpool = JM.paged_prefill_step(jcfg, m["jparams"], m["jmasks"],
                                     {"tokens": jnp.asarray(tokens)}, jpool, jnp.asarray(table),
                                     jnp.asarray(lens))
    jl, _ = JM.paged_verify_step(jcfg, m["jparams"], m["jmasks"], {"tokens": jnp.asarray(feed)},
                                 jpool, jnp.asarray(table), jnp.asarray(lens))
    pool = TM.init_paged_pool(tcfg, pages, bs, device="cpu")
    tab, ln = torch.from_numpy(table), torch.from_numpy(lens)
    TM.paged_prefill_step(tcfg, m["tparams"], m["tmasks"], {"tokens": torch.from_numpy(tokens)},
                          pool, tab, ln)
    seq_pool = {k: v.clone() for k, v in pool.items()}
    tl, _ = TM.paged_verify_step(tcfg, m["tparams"], m["tmasks"],
                                 {"tokens": torch.from_numpy(feed)}, pool, tab, ln)
    seq = torch.stack([TM.paged_decode_step(tcfg, m["tparams"], m["tmasks"],
                                            {"tokens": torch.from_numpy(feed[:, i:i + 1])},
                                            seq_pool, tab, ln + i)[0] for i in range(n)], dim=1)
    return np.asarray(jl), tl, seq


@pytest.mark.parametrize("bucket,rows", [(8, (5, 2)), (1, (0,))])
def test_paged_verify_step_matches_the_reference(bucket, rows):
    """The verify on the MoE family, refused until this slice: logits
    within 1e-5 of the reference's on the same pool, table and lengths."""
    jl, tl, _ = _verify_pair((), bucket, rows)
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


def test_the_verify_routes_its_rows_as_one_group_as_the_reference_does():
    """The kept quirk: the verify routes bucket x (gamma + 1) rows as one
    group at that group's capacity. At granite's full width that is 32 rows
    with capacity 10 at bucket 8 and gamma 3, where decode's 8-row groups
    have capacity 8 and never drop. At smoke size the verify's logits equal
    the reference's (above), and with a capacity factor that drops nothing
    in either group its real rows' argmax is that of 4 sequential decode
    steps."""
    full = TC.get_config(GRANITE)
    jfull = JC.get_config(GRANITE)
    assert TMoE.capacity_for(full, 32) == 10 and TMoE.capacity_for(full, 8) == 8
    assert min(jfull.moe_group_size, 32) == 32
    e, k = jfull.n_experts, jfull.top_k_experts
    assert min(32, max(-(-32 * k * int(100 * jfull.capacity_factor) // (100 * e)), k)) == 10
    jl, tl, seq = _verify_pair((("capacity_factor", 4.0),), 8, (5, 2))
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    live = [5, 2]
    assert torch.equal(tl[live].argmax(-1), seq[live].argmax(-1))
    np.testing.assert_allclose(tl[live].numpy(), seq[live].numpy(), **TOL)


# ---------------------------------------------------------------------------
# the speculative engine against the reference's
# ---------------------------------------------------------------------------

ENGINE_CASES = [("condensed", "plain", 0.5), ("condensed", "plain", 0.0),
                ("condensed_over_active", "ablated", 0.5)]


@pytest.mark.parametrize("path,masks,ablation", ENGINE_CASES)
def test_engine_tokens_and_stats_match_the_reference_engine(path, masks, ablation):
    """The port's speculative engine serves a 2-stream and a 1-stream
    request with the reference speculative engine's tokens, and with its
    rounds, drafts, matches and commits; every page comes back."""
    m = _model(GRANITE, ())
    tmasks, jmasks = _masks(masks)
    subs = [(_prompts(m["tcfg"], 2, 8, 3), 7), (_prompts(m["tcfg"], 1, 6, 4), 5)]
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], jmasks, m["jreg"], path=path,
                            speculative=JSP.SpecConfig(gamma=3, draft_ablation=ablation,
                                                       force=True))
    jrids = [jeng.submit(jnp.asarray(p), g) for p, g in subs]
    jeng.step()
    jres = [jeng.retire(r)[0] for r in jrids]
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], tmasks, m["treg"], path=path,
                            profile=PROFILE,
                            speculative=SP.SpecConfig(gamma=3, draft_ablation=ablation,
                                                      force=True))
    rids = [teng.submit(p, g) for p, g in subs]
    teng.step()
    tres = [teng.retire(r)[0] for r in rids]
    for j, t in zip(jres, tres):
        assert np.array_equal(t.tokens.numpy(), np.asarray(j.tokens))
        assert {s: t.spec[s] for s in STATS} == {s: j.spec[s] for s in STATS}
        assert t.spec["acceptance_rate"] == pytest.approx(j.spec["acceptance_rate"], rel=1e-12)
    for runner in teng._runners.values():
        assert runner.alloc.available == runner.num_blocks - 1


# ---------------------------------------------------------------------------
# the draft tree and its price on (L, E) expert leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,masks", [("condensed", "plain"), ("structured", "ablated"),
                                        ("masked", "ablation_only"),
                                        ("condensed_over_active", "ablated")])
def test_draft_trees_and_prices_on_expert_leaves_match_the_reference(path, masks):
    """``derive_draft_tree``'s report and integer leaves, the weight
    overhead and ``price_speculation`` (rtol 1e-6) equal the reference's on
    the expert stacks: a condensed target drafts sentinel
    condensed-over-active rows per expert, a structured one a column subset,
    an ablation-only masked one a subset and a fine-sparse masked one
    itself; experts are priced over their L * E replicas."""
    m = _model(GRANITE, ())
    tmasks, jmasks = _masks(masks)
    jtarget = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=8,
                            path=path).serving_tree
    ttarget = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], tmasks, batch_size=8,
                            path=path, profile=PROFILE).serving_tree
    jdraft, jrep = JP.derive_draft_tree(m["jreg"], jtarget, m["jparams"], jmasks, 0.5)
    tdraft, trep = TP.derive_draft_tree(m["treg"], ttarget, m["tparams"], tmasks, 0.5)
    assert trep == jrep
    want = {"condensed": "sentinel", "condensed_over_active": "sentinel",
            "structured": "subset", "masked": "subset"}[path]
    assert {trep[s.name] for s in m["treg"] if TR.is_expert_stack(s, m["tcfg"])} == {want}
    for js, ts in zip(m["jreg"], m["treg"]):
        jl, tl = JR.get_path(jdraft, js.path), TR.get_path(tdraft, ts.path)
        assert type(tl).__name__ == type(jl).__name__
        for f in ("out_index", "active_index", "neuron_active"):
            if getattr(jl, f, None) is not None:
                assert np.array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f))), f
    assert TP.draft_weight_overhead_bytes(m["treg"], ttarget, tdraft) == \
        JP.draft_weight_overhead_bytes(m["jreg"], jtarget, jdraft)
    assert TP.draft_weight_overhead_bytes(m["treg"], ttarget, tdraft)[1] == 0
    for b in (1, 8):
        jest = JP.price_speculation(m["jreg"], jtarget, jdraft, batch_size=b, gamma=3)
        test = TP.price_speculation(m["treg"], ttarget, tdraft, batch_size=b, gamma=3,
                                    profile=PROFILE)
        for f in dataclasses.fields(JP.SpecEstimate):
            assert getattr(test, f.name) == pytest.approx(getattr(jest, f.name), rel=1e-6)
        assert test.worthwhile == jest.worthwhile


def test_a_fine_sparse_masked_expert_stack_drafts_as_itself():
    """The SRigL masks keep fine-grained sparsity, so a masked target's
    stacks are not ablation-only and draft as themselves, in both."""
    m = _model(GRANITE, ())
    jt = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"], batch_size=8,
                       path="masked").serving_tree
    tt = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], m["tmasks"], batch_size=8,
                       path="masked", profile=PROFILE).serving_tree
    _, jrep = JP.derive_draft_tree(m["jreg"], jt, m["jparams"], m["jmasks"], 0.5)
    _, trep = TP.derive_draft_tree(m["treg"], tt, m["tparams"], m["tmasks"], 0.5)
    assert trep == jrep and set(trep.values()) == {"identity"}


@pytest.mark.parametrize("acceptance", [0.05, 0.99])
def test_auto_accepts_or_declines_as_the_reference(acceptance):
    """``path="auto"``: the engine's ``spec_estimate_for`` equals the
    reference engine's, and so does its decision to speculate."""
    m = _model(GRANITE, ())
    sc = dict(gamma=3, draft_ablation=0.5, acceptance=acceptance)
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="auto",
                            speculative=JSP.SpecConfig(**sc))
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path="auto",
                            profile=PROFILE, speculative=SP.SpecConfig(**sc))
    for b in (1, 8):
        jkey, tkey = jeng.plan_key(b), teng.plan_key(b)
        assert tkey.formats == jkey.formats
        jest, test = jeng.spec_estimate_for(jkey), teng.spec_estimate_for(tkey)
        assert (jest is None) == (test is None)
        if jest is not None:
            assert test.worthwhile == jest.worthwhile
            assert test.spec_s_per_token == pytest.approx(jest.spec_s_per_token, rel=1e-6)
            assert test.base_s_per_token == pytest.approx(jest.base_s_per_token, rel=1e-6)


def test_the_cli_speculates_on_granite_with_the_reference_stream(capsys, monkeypatch):
    """``--speculative`` on granite, the CLI's weights and masks replaced by
    the reference's: the first stream printed is the reference speculative
    engine's on the same prompts, and a ``[serve:spec]`` line follows."""
    from repro_torch.launch import serve as TSv
    m = _model(GRANITE, ())
    monkeypatch.setattr(TSv.M, "init_params", lambda cfg, gen, k_fan=None: m["tparams"])
    monkeypatch.setattr(TSv.REG, "init_sparsity_state",
                        lambda cfg, gen, reg: {"masks": m["tmasks"]})
    tokens = TSv.main(["--arch", GRANITE, "--smoke", "--device", "cpu", "--path", "condensed",
                       "--speculative", "--batch", "2", "--prompt-len", "8", "--gen", "6"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[serve] first stream:"))
    assert "[serve:spec] gamma=3" in out
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed",
                            speculative=JSP.SpecConfig(gamma=3, draft_ablation=0.5, force=True))
    rid = jeng.submit(jnp.asarray(tokens[:, :8].numpy()), 6)
    jeng.step()
    [jres] = jeng.retire(rid)
    assert line == f"[serve] first stream: {np.asarray(jres.tokens)[0, -6:].tolist()}"
