"""The MoE family (granite-moe-1b, kimi-k2 at smoke dims) against the JAX
reference on the CPU: configs and registry, the parameter layout, the loss
with the routers' aux term and its gradients, prefill and decode on masked
and condensed, the engines' tokens, the CLI, one SRigL update over the (L,
E) expert stacks, plans on every representation with half of the experts'
neurons ablated, and what the port once refused (speculation among it).

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, indices and
tokens are held equal exactly; float32 logits, losses and gradients within
rtol = atol = 1e-5. On the CPU every condensed expert stack runs the plain
version of the expert-grouped launch (K1-moe).

Capacity makes an MoE output depend on its routing group: a prefill of 4 x
32 tokens at smoke size (group 64, capacity 40) can drop tokens, and an
engine's padding rows route too. So the port's engine is held to the
reference's engine and its ``generate`` to the reference's ``generate``,
on the same requests.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import TOL, _model, _prompts, condensed_trees  # noqa: E402

GRANITE, KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
ARCHS = [GRANITE, KIMI]


# ---------------------------------------------------------------------------
# configs, registry, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_registries_equal_the_reference(arch, getter):
    jc, tc = getattr(JC, getter)(arch), getattr(TC, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.is_moe and tc.family == "moe"
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas) for s in treg] == [
        (s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)
    assert [TR.is_expert_stack(s, tc) for s in treg] == [False, True, True, True]


@pytest.mark.parametrize("arch,fans", [
    (GRANITE, {"wo": 69, "w_gate": 103, "w_up": 103, "w_down": 52}),
    (KIMI, {"wo": 319, "w_gate": 718, "w_up": 718, "w_down": 205})])
def test_full_width_fan_ins(arch, fans):
    cfg = TC.get_config(arch)
    reg = TR.build_registry(cfg)
    assert TR.k_fan_map(cfg, reg) == fans
    assert [s.lead for s in reg] == [(cfg.n_layers,)] + [(cfg.n_layers, cfg.n_experts)] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_mask_layouts_equal_the_reference(arch):
    m = _model(arch, ())
    cfg = m["tcfg"]
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, gen, TR.k_fan_map(cfg, m["treg"]))
    state = TR.init_sparsity_state(cfg, gen, m["treg"])
    for jtree, ttree in ((m["jparams"], params), (m["jmasks"], state["masks"]),
                         (m["jactive"], state["neuron_active"])):
        jflat = bridge.flatten(jax.tree.map(np.asarray, jtree))
        tflat = bridge.flatten(ttree)
        assert sorted(jflat) == sorted(tflat)
        for k, v in jflat.items():
            assert tuple(tflat[k].shape) == v.shape, k
            assert str(tflat[k].dtype).removeprefix("torch.") == str(v.dtype), k
    assert params["blocks"]["router"].dtype == torch.float32
    assert params["blocks"]["w_gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                                cfg.d_ff)


# ---------------------------------------------------------------------------
# training: loss with aux, gradients, one SRigL update over (L, E)
# ---------------------------------------------------------------------------

def _batch(cfg, seed: int = 0, b: int = 4, t: int = 32) -> dict:
    """4 x 32 tokens: two groups of 64 at smoke size, capacity 40 each."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _loss_and_grads(m, batch: dict):
    jout, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(m["jcfg"], p, m["jmasks"], b), has_aux=True))(
            m["jparams"], jax.tree.map(jnp.asarray, batch))
    params = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jparams"]))
    leaves = bridge.flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    tout = TM.loss_fn(m["tcfg"], params, m["tmasks"],
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    tout[0].backward()
    return jout, jg, tout, {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_gradients_and_an_srigl_update_over_the_expert_stacks(arch):
    m = _model(arch, ())
    (jtotal, jparts), jg, (ttotal, tparts), tg = _loss_and_grads(m, _batch(m["tcfg"]))
    assert tparts["aux_loss"].item() > 0
    for got, want in ((ttotal, jtotal), (tparts["loss"], jparts["loss"]),
                      (tparts["aux_loss"], jparts["aux_loss"])):
        np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(ttotal.item(),
                               tparts["loss"].item() + 0.01 * tparts["aux_loss"].item(),
                               rtol=1e-6)
    jflat = bridge.flatten(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == tg.keys()
    for k, v in jflat.items():
        np.testing.assert_allclose(tg[k].numpy(), v, err_msg=k, **TOL)

    # one SRigL update on the same dense gradients, one (E, d, ff) slab a layer
    grads_np = {k: np.asarray(v) for k, v in jflat.items()}
    drop = np.float32(0.3)
    jnew, jstats = JR.dst_update(
        m["jcfg"], m["jreg"], m["jparams"], jax.tree.map(jnp.asarray, bridge.unflatten(grads_np)),
        {"masks": m["jmasks"], "neuron_active": m["jactive"]}, drop, jax.random.PRNGKey(0))
    tnew, tstats = TR.dst_update(
        m["tcfg"], m["treg"], m["tparams"], bridge.from_jax_numpy(grads_np),
        {"masks": m["tmasks"], "neuron_active": m["tactive"]}, drop)
    for key in ("masks", "neuron_active"):
        jf = bridge.flatten(jax.tree.map(np.asarray, jnew[key]))
        tf = bridge.flatten(tnew[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(), jf[k], err_msg=f"{key}/{k}")
    moved = 0
    for s in m["treg"]:
        for f, v in jstats[s.name].items():
            np.testing.assert_array_equal(tstats[s.name][f].numpy(), np.asarray(v),
                                          err_msg=f"{s.name}/{f}")
        assert tstats[s.name]["fan_in"].shape == s.lead
        moved += int(tstats[s.name]["n_pruned"].sum())
    assert moved > 0


def test_moe_batches_are_the_dense_familys():
    cfg = TC.get_smoke_config(GRANITE)
    a = TD.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, batch_size=2, seed=3,
                       family="moe").batch(1)
    b = TD.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, batch_size=2, seed=3).batch(1)
    assert a.keys() == b.keys() == {"tokens", "targets"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    batch = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 2, 8)
    assert batch["tokens"].shape == (2, 8)


def test_the_train_cli_takes_granite(capsys):
    from repro_torch.launch import train as TTr
    state = TTr.main(["--arch", GRANITE, "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] done at step 2" in out and int(state.step) == 2


# ---------------------------------------------------------------------------
# serving: prefill + decode, generate, the engines
# ---------------------------------------------------------------------------

def _trees(m, path: str):
    """(reference serving tree, port serving tree) for ``path``: the
    condensed exports built once per process (``condensed_trees``)."""
    if path == "masked":
        return m["jmasks"], m["tmasks"]
    return condensed_trees(m["tcfg"].name, ())


@pytest.mark.parametrize("path", ["masked", "condensed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(arch, path):
    m = _model(arch, ())
    cfg_j, cfg_t = m["jcfg"], m["tcfg"]
    jtree, ttree = _trees(m, path)
    if path == "condensed":
        leaf = ttree["blocks"]["w_gate"]
        assert leaf.values.shape[:2] == (cfg_t.n_layers, cfg_t.n_experts)
    prompts = _prompts(cfg_t, 4, 32, seed=1)  # two groups of 64, capacity 40
    jcache = JM.init_cache(cfg_j, 4, 40)
    tcache = TM.init_cache(cfg_t, 4, 40, "cpu")
    jl, jcache = JM.prefill_step(cfg_j, m["jparams"], jtree, {"tokens": jnp.asarray(prompts)},
                                 jcache)
    tl, tcache = TM.prefill_step(cfg_t, m["tparams"], ttree,
                                 {"tokens": torch.from_numpy(prompts)}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for _ in range(4):
        jl, jcache = JM.decode_step(cfg_j, m["jparams"], jtree, {"tokens": jnp.asarray(tok)},
                                    jcache)
        tl, tcache = TM.decode_step(cfg_t, m["tparams"], ttree,
                                    {"tokens": torch.from_numpy(tok)}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_the_reference(arch):
    m = _model(arch, ())
    prompts = _prompts(m["tcfg"], 4, 32, seed=2)
    for path in ("masked", "condensed"):
        jtree, ttree = _trees(m, path)
        want = np.asarray(JE.generate(m["jcfg"], m["jparams"], jtree, jnp.asarray(prompts), 6))
        got = TE.generate(m["tcfg"], m["tparams"], ttree, torch.from_numpy(prompts), 6)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def _engine_tokens(m, path: str, reqs, values_dtype=None):
    """Each request's tokens from the reference's paged engine and the
    port's, submitted together and stepped once."""
    out = []
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path=path,
                            values_dtype=values_dtype)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path=path,
                            values_dtype=values_dtype)
    assert teng.paged and jeng.paged
    for eng, to in ((jeng, jnp.asarray), (teng, torch.from_numpy)):
        ids = [eng.submit(to(p), g) for p, g in reqs]
        eng.step()
        res = {r.id: r for r in eng.retire()}
        out.append([np.asarray(res[i].tokens) for i in ids])
    return out, teng


@pytest.mark.parametrize("path", ["masked", "condensed", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_tokens_equal_the_reference_engine(arch, path):
    """Requests at buckets 1 and 8 (decode groups of 1 and 8 rows: nothing
    dropped), prompts padded to 32 and 64 (prefill groups of 64 over padded
    rows, capacity 40)."""
    m = _model(arch, ())
    cfg = m["tcfg"]
    reqs = [(_prompts(cfg, 4, 32, seed=1), 9), (_prompts(cfg, 3, 20, seed=2), 6),
            (_prompts(cfg, 1, 7, seed=3), 5)]
    (jt, tt), teng = _engine_tokens(m, path, reqs)
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t, j)
    if path == "auto":
        plan = teng.plan_for(teng.plan_key(4))
        assert {plan.representation_of(s.name) for s in m["treg"]} <= {"masked", "condensed"}


def test_int8_engine_tokens_equal_the_reference_engine():
    """Quantized condensed experts: the codes and scales through K2-moe's
    plain version."""
    m = _model(GRANITE, ())
    reqs = [(_prompts(m["tcfg"], 2, 16, seed=4), 6)]
    (jt, tt), teng = _engine_tokens(m, "condensed", reqs, values_dtype="int8")
    np.testing.assert_array_equal(tt[0], jt[0])
    leaf = teng.serving_tree_for(teng.plan_key(2))["blocks"]["w_up"]
    assert leaf.values.dtype == torch.int8 and leaf.scales.shape[:2] == (2, 4)


def test_the_serve_cli_streams_equal_on_masked_and_condensed(capsys):
    from repro_torch.launch import serve as TSv
    first = {}
    for path in ("condensed", "masked"):
        TSv.main(["--arch", GRANITE, "--smoke", "--device", "cpu", "--path", path,
                  "--batch", "4", "--prompt-len", "32", "--gen", "6"])
        out = capsys.readouterr().out
        first[path] = next(line for line in out.splitlines() if "first stream" in line)
    assert first["condensed"] == first["masked"]


# ---------------------------------------------------------------------------
# what this slice refuses
# ---------------------------------------------------------------------------

def test_engine_refusals_name_their_roadmap_item(capsys, tmp_path, monkeypatch):
    """What this family once refused now runs as the reference does:
    speculation (the engine, the CLI and ``paged_verify_step``, refused
    naming item 8 until speculation on MoE was ported: each now equals the
    reference's), and refresh, live sync and the launch search on the (L, E)
    expert stacks (refused until item 8's two-leading-axes step; their
    parity with the reference is in ``tests/test_torch_lead2*.py``)."""
    from repro.launch import speculative as JSP
    from repro_torch.launch import serve as TSv
    from repro_torch.launch.speculative import SpecConfig
    from repro_torch.sparse import autotune as AT
    from repro_torch.sync import DirChannel, Publisher, Subscriber
    m = _model(GRANITE, ())
    args = (m["tcfg"], m["tparams"], m["tmasks"], m["treg"])
    prompts = _prompts(m["tcfg"], 1, 6, 5)
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed",
                            speculative=JSP.SpecConfig(force=True))
    jrid = jeng.submit(jnp.asarray(prompts), 4)
    jeng.step()
    [jres] = jeng.retire(jrid)
    spec = TE.ServingEngine(*args, path="condensed", speculative=SpecConfig(force=True))
    rid = spec.submit(prompts, 4)
    spec.step()
    [res] = spec.retire(rid)
    assert np.array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert res.spec["rounds"] == jres.spec["rounds"]
    monkeypatch.setattr(TSv.M, "init_params", lambda cfg, gen, k_fan=None: m["tparams"])
    monkeypatch.setattr(TSv.REG, "init_sparsity_state",
                        lambda cfg, gen, reg: {"masks": m["tmasks"]})
    tokens = TSv.main(["--arch", GRANITE, "--smoke", "--device", "cpu", "--path", "condensed",
                       "--speculative", "--batch", "1", "--prompt-len", "6", "--gen", "4"])
    jrid = jeng.submit(jnp.asarray(tokens[:, :6].numpy()), 4)
    jeng.step()
    [jcli] = jeng.retire(jrid)
    out = capsys.readouterr().out
    assert f"[serve] first stream: {np.asarray(jcli.tokens)[0, -4:].tolist()}" in out
    assert "[serve:spec]" in out
    monkeypatch.undo()
    eng = TE.ServingEngine(*args, path="condensed",
                           mask_versions={s.name: 0 for s in m["treg"]})
    eng.plan_for(eng.plan_key(1))
    changed = eng.refresh(m["tparams"], m["tmasks"], {s.name: 1 for s in m["treg"]})
    assert [sorted(names) for names in changed.values()] == [
        sorted(s.name for s in m["treg"])]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    AT.reset_cache_state()
    try:
        assert {"blocks/w_gate", "blocks/w_down"} <= set(eng.autotune(1, dtype=torch.float32,
                                                                      reps=1))
    finally:
        AT.reset_cache_state()
    pub = Publisher(m["tcfg"], m["treg"], DirChannel(str(tmp_path / "sync")), path="condensed")
    pub.publish(params=m["tparams"], masks=m["tmasks"],
                mask_versions={s.name: 1 for s in m["treg"]})
    sub = Subscriber(DirChannel(str(tmp_path / "sync")).subscribe("r"))
    sub.poll()
    eng.attach_subscriber(sub)
    assert eng._sync_generation == sub.generation == 1
    feed = np.array([[3, 7]], np.int32)
    jpool = JM.init_paged_pool(m["jcfg"], 4, 4)
    jl, _ = JM.paged_verify_step(m["jcfg"], m["jparams"], m["jmasks"],
                                 {"tokens": jnp.asarray(feed)}, jpool,
                                 jnp.zeros((1, 1), jnp.int32), jnp.zeros((1,), jnp.int32))
    pool = TM.init_paged_pool(m["tcfg"], 4, 4, "cpu")
    tl, _ = TM.paged_verify_step(m["tcfg"], m["tparams"], m["tmasks"],
                                 {"tokens": torch.from_numpy(feed)}, pool,
                                 torch.zeros((1, 1), dtype=torch.int32),
                                 torch.zeros((1,), dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _half_ablated(m):
    """The model's masks with the first half of every stack's neurons
    emptied: (the port's masks, the reference's)."""
    masks = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jmasks"]))
    for s in m["treg"]:
        TR.get_path(masks, s.path)[..., : s.d_out // 2] = False
    return masks, jax.tree.map(jnp.asarray, bridge.to_jax_numpy(masks))


@pytest.mark.parametrize("path", ["structured", "condensed_over_active"])
def test_plans_refuse_formats_without_a_grouped_launch(path):
    """A plan forced to structured or condensed_over_active raised on the
    expert stacks until their grouped launches (K5-moe, K4-moe) were ported;
    it now builds, every stack on ``path`` as in the reference's plan, the
    expert leaves keeping the (L, E) lead and their integer arrays equal to
    the reference's."""
    m = _model(GRANITE, ())
    masks, jmasks = _half_ablated(m)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=1, path=path)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks, batch_size=1, path=path)
    for s in m["treg"]:
        assert tplan.representation_of(s.name) == jplan.representation_of(s.name) == path
        leaf, jleaf = (TR.get_path(t.serving_tree, s.path) for t in (tplan, jplan))
        assert tuple(leaf.arrays()["active_index" if path == "structured" else "values"]
                     .shape[:len(s.lead)]) == s.lead
        for f, t in leaf.arrays().items():
            if not t.dtype.is_floating_point:
                np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jleaf, f)),
                                              err_msg=f"{s.name}/{f}")


def test_auto_raises_where_the_reference_would_pick_another_format():
    """Half of each stack's neurons ablated: at bucket 1 the reference's
    cost model picks condensed_over_active for the expert stacks. The
    port's plan raised there until K4-moe was ported; it now decides every
    stack as the reference does."""
    m = _model(GRANITE, ())
    masks, jmasks = _half_ablated(m)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=1,
                          path="auto")
    picked = {jplan.representation_of(s.name) for s in m["jreg"] if s.path[-1] != "wo"}
    assert picked - {"masked", "condensed"}
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], masks, batch_size=1, path="auto")
    assert {s.name: tplan.representation_of(s.name) for s in m["treg"]} == \
        {s.name: jplan.representation_of(s.name) for s in m["jreg"]}
