"""The configs beyond qwen3-1.7b against the JAX reference, on the CPU at
smoke dims: their registries, parameter and cache layouts, prefill and
decode logits (gemma3-1b's local rings wrapped), the plans and formats on
gemma3's (g, r) stacks, checkpoints of the grouped layout, the refusals and
the CLIs. gemma3-1b runs at its smoke config (6 layers: 2 groups of 2 local
+ 1 global, no remainder) and at 8 layers (a ``g_rem`` of 2, as at full
width).

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, indices,
batches and tokens are held equal exactly; float32 logits, losses and
gradients within rtol = atol = 1e-5, as ``tests/test_torch_models.py``
states. On the CPU every sparse linear runs K1's plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

from _torch_zoo_model import (ALL, GEMMA, TOL, _assert_trees_close, _ids, _model,  # noqa: E402
                              _prompts, condensed_trees)


# ---------------------------------------------------------------------------
# layout: registry, params, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", ALL, ids=_ids(ALL))
def test_registry_stacks_densities_and_fan_ins_equal(arch, kw):
    m = _model(arch, kw)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in m["treg"]] == [(s.path, s.d_in, s.d_out, s.lead, s.density,
                                     s.n_replicas, s.name) for s in m["jreg"]]
    assert TR.k_fan_map(m["tcfg"], m["treg"]) == JR.k_fan_map(m["jcfg"], m["jreg"])
    # the same trees: the params' and masks' paths and shapes, the masks equal
    jp = bridge.flatten(jax.tree.map(np.asarray, m["jparams"]))
    tp = TM.init_params(m["tcfg"], torch.Generator().manual_seed(0),
                        TR.k_fan_map(m["tcfg"], m["treg"]))
    assert {k: v.shape for k, v in jp.items()} == {
        k: tuple(v.shape) for k, v in bridge.flatten(tp).items()}
    tstate = TR.init_sparsity_state(m["tcfg"], torch.Generator().manual_seed(0), m["treg"])
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tstate["masks"]).items()} == {
        k: v.shape for k, v in bridge.flatten(jax.tree.map(np.asarray, m["jmasks"])).items()}


def test_gemma_grouped_layout_at_eight_layers():
    m = _model("gemma3-1b", (("n_layers", 8),))
    cfg = m["tcfg"]
    assert TM.group_counts(cfg) == (2, 2, 2)
    assert TM.block_stacks(cfg) == [("g_local", (2, 2)), ("g_global", (2,)), ("g_rem", (2,))]
    windows = [w for _, _, w in TM._block_order(cfg)]
    assert windows == [cfg.window_for_layer(i) for i in range(cfg.n_layers)]
    assert [s.lead for s in m["treg"]][::4] == [(2, 2), (2,), (2,)]
    # full width: 4 groups of 5 local + 1 global, then 2 local layers
    assert TM.group_counts(TC.get_config("gemma3-1b")) == (4, 5, 2)


@pytest.mark.parametrize("arch,kw", GEMMA, ids=_ids(GEMMA))
def test_init_cache_rings_and_full_caches_equal_the_reference(arch, kw):
    m = _model(arch, kw)
    jc = JM.init_cache(m["jcfg"], 3, 40)
    tc = TM.init_cache(m["tcfg"], 3, 40, "cpu")
    jflat = bridge.flatten(jax.tree.map(np.asarray, jc))
    tflat = bridge.flatten(tc)
    assert {k: v.shape for k, v in jflat.items()} == {k: tuple(v.shape)
                                                      for k, v in tflat.items()}
    assert tc["g_local"]["k"].shape[2:4] == (3, m["tcfg"].sliding_window)   # rings
    assert tc["g_global"]["k"].shape[1:3] == (3, 40)                         # full
    assert not TM.supports_paged(m["tcfg"]) and not JM.supports_paged(m["jcfg"])


# ---------------------------------------------------------------------------
# serving: prefill + decode logits, rings wrapped
# ---------------------------------------------------------------------------

def _prefill_decode(m, serve_j, serve_t, prompts, steps: int, max_len: int):
    """Logits of the reference's and the port's prefill and ``steps``
    greedy decode steps (fed the reference's argmax), and both caches."""
    b = prompts.shape[0]
    jcache = JM.init_cache(m["jcfg"], b, max_len)
    tcache = TM.init_cache(m["tcfg"], b, max_len, "cpu")
    jprefill = jax.jit(functools.partial(JM.prefill_step, m["jcfg"]))
    jdecode = jax.jit(functools.partial(JM.decode_step, m["jcfg"]))
    jl, jcache = jprefill(m["jparams"], serve_j, {"tokens": jnp.asarray(prompts)}, jcache)
    tl, tcache = TM.prefill_step(m["tcfg"], m["tparams"], serve_t,
                                 {"tokens": torch.from_numpy(prompts)}, tcache)
    out = [(np.asarray(jl), tl.numpy())]
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = jdecode(m["jparams"], serve_j, {"tokens": jnp.asarray(nxt)}, jcache)
        tl, tcache = TM.decode_step(m["tcfg"], m["tparams"], serve_t,
                                    {"tokens": torch.from_numpy(nxt)}, tcache)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jcache, tcache


@pytest.mark.parametrize("path", ["masked", "condensed"])
@pytest.mark.parametrize("arch,kw", ALL, ids=_ids(ALL))
def test_prefill_and_decode_logits_equal_the_reference(arch, kw, path):
    """gemma3: a 24-token prompt against the 16-token window, then 12 decode
    steps, so the local rings wrap in prefill and again in decode."""
    m = _model(arch, kw)
    if path == "masked":
        serve_j, serve_t = m["jmasks"], m["tmasks"]
    else:
        serve_j, serve_t = condensed_trees(arch, kw)
        for s in m["treg"]:  # indices exactly, the (g, r) stacks included
            np.testing.assert_array_equal(TR.get_path(serve_t, s.path).indices.numpy(),
                                          np.asarray(JR.get_path(serve_j, s.path).indices))
    prompts = _prompts(m["tcfg"], 3, 24)
    logits, jcache, tcache = _prefill_decode(m, serve_j, serve_t, prompts, 12, 40)
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, **TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == 36
    _assert_trees_close({k: v for k, v in jcache.items() if k != "len"},
                        {k: v for k, v in tcache.items() if k != "len"}, **TOL)


def _ablated(m, frac: float = 0.25) -> tuple[dict, dict]:
    """The masks with the last ``frac`` of each stack's output neurons cut,
    as the reference's and the port's trees."""
    out = {}
    for s in m["jreg"]:
        cut = s.d_out - max(1, int(s.d_out * frac))
        JR.set_path(out, s.path, JR.get_path(m["jmasks"], s.path)
                    & (jnp.arange(s.d_out) < cut)[None, :])
    return out, bridge.from_jax_numpy(jax.tree.map(np.asarray, out))


@pytest.mark.parametrize("path,batch", [("auto", 1), ("auto", 256),
                                        ("condensed_over_active", 4), ("structured", 4)])
def test_plans_and_exports_on_the_grouped_stacks_equal_the_reference(path, batch):
    """The plan's per-stack decisions and every format's arrays on stacks
    with two leading dims (g_local's (g, r)), and ``unstack`` two levels
    deep down to one layer."""
    from repro.sparse import plan as JP
    from repro_torch.sparse import plan as TP
    m = _model(*GEMMA[1])
    jmasks, tmasks = _ablated(m)
    profile = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                    for f in dataclasses.fields(TP.HardwareProfile)})
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=batch,
                          path=path)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], tmasks, batch_size=batch,
                          path=path, profile=profile)
    assert {n: d.representation for n, d in tplan.decisions.items()} == {
        n: d.representation for n, d in jplan.decisions.items()}
    for s in m["treg"]:
        jleaf, tleaf = JR.get_path(jplan.serving_tree, s.path), TR.get_path(tplan.serving_tree,
                                                                           s.path)
        assert type(tleaf).format_name == type(jleaf).format_name
        assert tleaf.spec().n_replicas == s.n_replicas == int(np.prod(s.lead))
        for f, arr in tleaf.arrays().items():
            want = np.asarray(getattr(jleaf, f))
            if arr.dtype.is_floating_point:
                np.testing.assert_allclose(arr.numpy(), want, rtol=1e-6, err_msg=f)
            else:
                np.testing.assert_array_equal(arr.numpy(), want, err_msg=f)
        layers = [tleaf.layer(i) for i in range(s.lead[0])]
        if len(s.lead) == 2:
            layers = [g.layer(j) for g in layers for j in range(s.lead[1])]
        first = next(iter(tleaf.arrays()))
        flat = getattr(tleaf, first).reshape(-1, *getattr(tleaf, first).shape[len(s.lead):])
        assert len(layers) == s.n_replicas
        for i, layer in enumerate(layers):
            assert torch.equal(getattr(layer, first), flat[i])
    assert tplan.weight_bytes() == jplan.weight_bytes()


# ---------------------------------------------------------------------------
# plumbing: checkpoints, the bridge, what stays refused
# ---------------------------------------------------------------------------

def test_grouped_train_state_round_trips_through_both_checkpoints(tmp_path):
    """gemma3's nested g_local / g_global / g_rem paths: the reference's npz
    restores into a port template bitwise and back."""
    kw = dict(GEMMA[1][1])
    jcfg = JC.get_smoke_config("gemma3-1b").replace(**kw)
    tcfg = TC.get_smoke_config("gemma3-1b").replace(**kw)
    js = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    want = bridge.flatten(jax.tree.map(np.asarray, js)._asdict())
    assert any(k.startswith("params/g_local/") for k in want)
    assert any(k.startswith("params/g_rem/") for k in want)
    template = TSt.init_train_state(tcfg, torch.Generator().manual_seed(1))
    assert sorted(bridge.flatten(bridge.train_state_to_jax_numpy(template))) == sorted(want)
    JCK.save(str(tmp_path / "jax"), js)
    got = TCK.restore(str(tmp_path / "jax"), 0, template)
    have = bridge.flatten(bridge.train_state_to_jax_numpy(got))
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    TCK.save(str(tmp_path / "torch"), got)
    back = JCK.restore(str(tmp_path / "torch"), 0,
                       JSt.init_train_state(jcfg, jax.random.PRNGKey(1)))
    again = bridge.flatten(jax.tree.map(np.asarray, back)._asdict())
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)
    # the bridge: a condensed serving tree keeps the nested paths
    cond = condensed_trees(*GEMMA[1])[1]
    flat = bridge.flatten(cond)
    assert "g_local/w_down/values" in flat and flat["g_local/w_down/values"].shape[:2] == (2, 2)
    leaf = cond["g_local"]["w_down"]
    assert [[t.values.shape for t in g.unstack()] for g in leaf.unstack()] == [
        [leaf.values.shape[2:]] * 2] * 2


@pytest.mark.parametrize("family,kw", [
    ("moe", dict(n_experts=4, top_k_experts=2)), ("ssm", dict(ssm_state=16)),
    ("hybrid", dict(ssm_state=16)), ("audio", dict(n_codebooks=4)),
    ("vit", dict(causal=False))])
def test_unported_families_are_refused_naming_item_8(family, kw):
    cfg = TC.get_smoke_config("qwen3-1.7b").replace(family=family, **kw)
    if family == "hybrid":
        # ported since item 8 step 6 (the rest: tests/test_torch_hybrid*.py);
        # two groups of one Mamba2 layer, each followed by the shared block
        cfg = cfg.replace(hybrid_attn_every=1)
        TM.check_supported(cfg)
        params = TM.init_params(cfg, torch.Generator())
        assert params["m_groups"]["in_x"].shape == (2, 1, cfg.d_model, cfg.d_inner)
        assert params["shared_attn"]["w_gate"].shape == (cfg.d_model, cfg.d_ff)
        assert [s.name for s in TR.build_registry(cfg)][-1] == "shared_attn/w_down"
        TD.SyntheticLM(vocab_size=16, seq_len=4, batch_size=1, family=family)
        return
    if family == "ssm":
        # ported since item 8 step 5 (the rest: tests/test_torch_ssm*.py)
        TM.check_supported(cfg)
        params = TM.init_params(cfg, torch.Generator())
        assert params["blocks"]["in_x"].shape == (cfg.n_layers, cfg.d_model, cfg.d_inner)
        assert [s.name for s in TR.build_registry(cfg)] == [
            "blocks/in_z", "blocks/in_x", "blocks/out_proj"]
        TD.SyntheticLM(vocab_size=16, seq_len=4, batch_size=1, family=family)
        return
    if family == "moe":
        # ported since item 8 step 4, its speculative verify since speculation
        # on MoE (the rest: tests/test_torch_moe_model.py,
        # tests/test_torch_moe_speculative.py): the verify equals the reference's
        TM.check_supported(cfg)
        params = TM.init_params(cfg, torch.Generator())
        assert params["blocks"]["w_gate"].shape[:2] == (cfg.n_layers, 4)
        jcfg = JC.get_smoke_config("qwen3-1.7b").replace(family=family, **kw)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        feed = np.array([[3, 7]], np.int32)
        jl, _ = JM.paged_verify_step(jcfg, jparams, {}, {"tokens": jnp.asarray(feed)},
                                     JM.init_paged_pool(jcfg, 2, 4), jnp.zeros((1, 1), jnp.int32),
                                     jnp.zeros((1,), jnp.int32))
        tl, _ = TM.paged_verify_step(cfg, bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams)),
                                     {}, {"tokens": torch.from_numpy(feed)},
                                     TM.init_paged_pool(cfg, 2, 4, "cpu"),
                                     torch.zeros((1, 1), dtype=torch.int32),
                                     torch.zeros((1,), dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        return
    # audio and vit: ported since item 8 steps 7-8 (the rest:
    # tests/test_torch_audio.py, tests/test_torch_vit.py)
    TM.check_supported(cfg)
    params = TM.init_params(cfg, torch.Generator())
    assert [s.name for s in TR.build_registry(cfg)] == [
        "blocks/wo", "blocks/w_gate", "blocks/w_up", "blocks/w_down"]
    data = TD.SyntheticLM(vocab_size=16, seq_len=4, batch_size=1, family=family,
                          n_codebooks=cfg.n_codebooks, d_model=cfg.d_model)
    if family == "audio":
        assert params["embed"].shape == (4, cfg.vocab_padded, cfg.d_model)
        assert params["lm_head"].shape == (4, cfg.d_model, cfg.vocab_padded)
        assert data.batch(0)["tokens"].shape == (1, 4, 4)
        return
    assert params["embed"].shape == (1, cfg.d_model)
    assert params["lm_head"].shape == (cfg.d_model, cfg.n_classes)
    assert set(data.batch(0)) == {"frontend_embeds", "labels"}
    # what no reference config is: a causal ViT, an encoder of another family
    for bad in (cfg.replace(causal=True), cfg.replace(family="dense")):
        with pytest.raises(NotImplementedError, match="not a configuration of the reference"):
            TM.check_supported(bad)



def test_the_clis_take_the_new_archs(capsys):
    """``--arch`` in both CLIs: gemma3-1b served on condensed and masked
    through the slab engine (the same first stream), qwen2-vl-7b trained two
    steps on its vlm batches."""
    from repro_torch.launch import serve as TSv
    from repro_torch.launch import train as TTr
    first = {}
    for path in ("condensed", "masked"):
        TSv.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--path", path,
                  "--batch", "2", "--prompt-len", "20", "--gen", "5"])
        out = capsys.readouterr().out
        first[path] = next(line for line in out.splitlines() if "first stream" in line)
    assert first["condensed"] == first["masked"]
    state = TTr.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "[train] done at step 2" in out and int(state.step) == 2
