"""The encoder-only ViT family (vit-b16, the paper's own transformer) against
the JAX reference on the CPU, at its smoke config (2 layers, 4 heads padded
to 16, 10 classes).

Held here: the config and registry (uniform densities; full-width fan-ins
without allocating), the parameter layout (the (1, d) CLS stub ``embed``
and the (d, n_classes) class head) through the bridge and both npz
checkpoints, ``SyntheticLM``'s and ``make_train_batch``'s vit batches (the
train CLI's [0, 2) label quirk included), the classification loss and its
gradients, one SRigL update with ablation at gamma_sal 0.95, the class
logits over masked, condensed, condensed_over_active and structured serving
trees, the absence of RoPE (the encoder is permutation-equivariant), the
refusals of every decode path, and the train CLI.

The reference's weights and masks (``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, batches and
top-1 classes exactly; float32 logits, losses and gradients within rtol =
atol = 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

from _torch_zoo_model import TOL, _model, to_port  # noqa: E402

ARCH = "vit-b16"
T = 9  # tokens an image at smoke size


def _embeds(cfg, b: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, T, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# config, registry, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_and_registry_equal_the_reference(getter):
    jc, tc = getattr(JC, getter)(ARCH), getattr(TC, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("n_heads_padded", "n_kv_heads_padded", "head_to_kv", "q_dim", "kv_dim"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in treg] == [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas,
                                s.name) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)
    assert len({s.density for s in treg}) == 1  # uniform: one density for every stack


def test_full_width_stacks_and_fan_ins():
    """vit-b16 at full width: 12 heads padded to 16 (q_dim 1024), the
    paper's uniform 90% densities; nothing is allocated."""
    cfg = TC.get_config(ARCH)
    assert (cfg.causal, cfg.n_layers, cfg.d_model, cfg.n_heads_padded, cfg.q_dim, cfg.d_ff,
            cfg.n_classes, cfg.sparsity.distribution, cfg.sparsity.gamma_sal) == (
        False, 12, 768, 16, 1024, 3072, 1000, "uniform", 0.95)
    reg = TR.build_registry(cfg)
    assert [(s.name, s.d_in, s.d_out, s.lead) for s in reg] == [
        ("blocks/wo", 1024, 768, (12,)), ("blocks/w_gate", 768, 3072, (12,)),
        ("blocks/w_up", 768, 3072, (12,)), ("blocks/w_down", 3072, 768, (12,))]
    assert TR.k_fan_map(cfg, reg) == {"wo": 102, "w_gate": 77, "w_up": 77, "w_down": 307}
    jc = JC.get_config(ARCH)
    assert TR.k_fan_map(cfg, reg) == JR.k_fan_map(jc, JR.build_registry(jc))


def test_param_layout_and_the_bridge():
    """The port's init has the reference's paths and shapes: the CLS stub
    ``embed`` (1, d), the class head (d, n_classes), the blocks' stack;
    the reference's params cross to the port and back bitwise."""
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), TR.k_fan_map(cfg, m["treg"]))
    jflat = bridge.flatten(jax.tree.map(np.asarray, m["jparams"]))
    assert {k: v.shape for k, v in jflat.items()} == {
        k: tuple(v.shape) for k, v in bridge.flatten(tp).items()}
    assert tp["embed"].shape == (1, cfg.d_model)
    assert tp["lm_head"].shape == (cfg.d_model, cfg.n_classes)
    assert tp["blocks"]["wo"].shape == (cfg.n_layers, cfg.q_dim, cfg.d_model)
    back = bridge.flatten(bridge.to_jax_numpy(m["tparams"]))
    for k, v in jflat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_train_state_round_trips_through_both_checkpoints(tmp_path):
    """The reference's npz TrainState (the (d, n_classes) head and the CLS
    stub among its leaves) restores into a port template bitwise, and the
    port's save restores into the reference's."""
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    js = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    want = bridge.flatten(jax.tree.map(np.asarray, js)._asdict())
    template = TSt.init_train_state(tcfg, torch.Generator().manual_seed(1))
    assert "params/lm_head" in want and want["params/lm_head"].shape == (
        tcfg.d_model, tcfg.n_classes)
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


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def test_synthetic_batches_equal_the_reference_with_the_cli_label_quirk():
    """The train CLIs pass ``vocab_size=max(cfg.vocab_size, 2)``, which is 2
    for vit, so SyntheticLM's labels are 0 or 1, in both."""
    cfg = TC.get_smoke_config(ARCH)
    kw = dict(vocab_size=max(cfg.vocab_size, 2), seq_len=T, batch_size=5, seed=3,
              family=cfg.family, n_codebooks=cfg.n_codebooks, d_model=cfg.d_model)
    jdata, tdata = JD.SyntheticLM(**kw), TD.SyntheticLM(**kw)
    for step in (0, 7):
        jb, tb = jdata.batch(step), tdata.batch(step)
        assert set(tb) == set(jb) == {"frontend_embeds", "labels"}
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["frontend_embeds"].shape == (5, T, cfg.d_model)
        assert set(np.unique(tb["labels"])) <= {0, 1}
    labels = np.concatenate([tdata.batch(s)["labels"] for s in range(8)])
    assert set(np.unique(labels)) == {0, 1}


def test_make_train_batch_keys_shapes_dtypes_and_label_range():
    """``jax.random`` draws cannot be reproduced in torch: the keys, shapes
    and dtypes are the reference's, the labels in [0, max(n_classes, 2))."""
    cfg = TC.get_smoke_config(ARCH)
    b = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 64, T)
    jb = JD.make_train_batch(JC.get_smoke_config(ARCH), jax.random.PRNGKey(0), 64, T)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in b.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jb.items()}
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < cfg.n_classes
    assert len(set(b["labels"].tolist())) > 2
    again = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 64, T)
    assert all(torch.equal(b[k], again[k]) for k in b)


# ---------------------------------------------------------------------------
# loss, gradients, SRigL
# ---------------------------------------------------------------------------

def _batch(cfg, seed: int = 0, b: int = 3) -> dict:
    labels = np.random.default_rng(seed + 1).integers(0, cfg.n_classes, b).astype(np.int32)
    return {"frontend_embeds": _embeds(cfg, b, seed), "labels": labels}


def test_loss_gradients_and_an_srigl_update_with_ablation_equal_the_reference():
    """The classification loss (mean-pooled hidden states, the head, cross-
    entropy on the labels) and every gradient against ``jax.grad`` (the
    unread CLS stub's gradient zero in both), then one SRigL update at the
    config's gamma_sal 0.95: masks and ``neuron_active`` exactly, with
    neurons ablated."""
    m = _model(ARCH, ())
    batch = _batch(m["tcfg"])
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(m["jcfg"], p, m["jmasks"], b)[0]))(
            m["jparams"], jax.tree.map(jnp.asarray, batch))
    params = to_port(m["jparams"])
    leaves = bridge.flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    tloss, parts = TM.loss_fn(m["tcfg"], params, m["tmasks"],
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert float(parts["aux_loss"]) == 0.0
    jflat = bridge.flatten(jax.tree.map(np.asarray, jg))
    for k, v in jflat.items():
        got = leaves[k].grad
        got = torch.zeros_like(leaves[k]) if got is None else got
        np.testing.assert_allclose(got.numpy(), v, err_msg=k, **TOL)
    assert not jflat["embed"].any()

    assert m["tcfg"].sparsity.gamma_sal == 0.95
    drop = np.float32(0.3)
    jnew, _ = JR.dst_update(
        m["jcfg"], m["jreg"], m["jparams"], jax.tree.map(jnp.asarray, bridge.unflatten(jflat)),
        {"masks": m["jmasks"], "neuron_active": m["jactive"]}, drop, jax.random.PRNGKey(0))
    tnew, _ = TR.dst_update(
        m["tcfg"], m["treg"], m["tparams"], bridge.from_jax_numpy(jflat),
        {"masks": m["tmasks"], "neuron_active": m["tactive"]}, drop)
    for key in ("masks", "neuron_active"):
        jf, tf = bridge.flatten(jax.tree.map(np.asarray, jnew[key])), bridge.flatten(tnew[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(), jf[k], err_msg=f"{key}/{k}")
    ablated = sum(int((~v).sum()) for v in bridge.flatten(tnew["neuron_active"]).values())
    assert ablated > 0


# ---------------------------------------------------------------------------
# the forward over serving trees
# ---------------------------------------------------------------------------

def _ablated(m, only: bool) -> tuple[dict, dict]:
    """Half of each stack's output neurons cut from the masks, or (``only``)
    masks that are that ablation alone (surviving columns dense), as the
    reference's and the port's trees."""
    out = {}
    for s in m["jreg"]:
        keep = (jnp.arange(s.d_out) < s.d_out - max(1, s.d_out // 2))[None, :]
        base = JR.get_path(m["jmasks"], s.path)
        JR.set_path(out, s.path, (jnp.ones_like(base) if only else base) & keep)
    return out, to_port(out)


def _reference_logits(m, tree, x):
    h, pos = JM.embed_inputs(m["jcfg"], m["jparams"], {"frontend_embeds": jnp.asarray(x)})
    hidden, _ = JM.backbone(m["jcfg"], m["jparams"], tree, h, positions=pos)
    pooled = jnp.mean(hidden, axis=1)
    return np.asarray((pooled @ m["jparams"]["lm_head"].astype(pooled.dtype))
                      .astype(jnp.float32)), np.asarray(hidden)


def _port_logits(m, tree, x):
    with torch.no_grad():
        h, pos = TM.embed_inputs(m["tcfg"], m["tparams"],
                                 {"frontend_embeds": torch.from_numpy(x)})
        hidden, _ = TM.backbone(m["tcfg"], m["tparams"], tree, h, positions=pos)
        return TM.class_logits(m["tcfg"], m["tparams"], hidden).numpy(), hidden.numpy()


@pytest.mark.parametrize("path", ["masked", "condensed", "condensed_over_active", "structured"])
def test_class_logits_over_serving_trees_equal_the_reference(path):
    """Each serving tree built by both plans from the same masks
    (condensed_over_active on half-ablated masks, structured on their
    ablation-only projection), the class logits within 1e-5 and the top-1
    classes equal."""
    m = _model(ARCH, ())
    if path in ("masked", "condensed"):
        jmasks, tmasks = m["jmasks"], m["tmasks"]
    else:
        jmasks, tmasks = _ablated(m, only=path == "structured")
    if path == "masked":
        jtree, ttree = jmasks, tmasks
    else:
        jtree = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=3,
                              path=path).serving_tree
        ttree = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], tmasks, batch_size=3,
                              path=path).serving_tree
    x = _embeds(m["tcfg"], seed=5)
    jl, _ = _reference_logits(m, jtree, x)
    tl, _ = _port_logits(m, ttree, x)
    assert tl.shape == (3, m["tcfg"].n_classes) and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_no_rope_the_encoder_is_permutation_equivariant():
    """The encoder takes no positions (the reference applies RoPE only to
    causal configs): the port's hidden states on the tokens permuted are
    the reference's permuted, and its class logits the reference's on the
    tokens in order (RoPE would make the hidden states depend on the
    order)."""
    m = _model(ARCH, ())
    x = _embeds(m["tcfg"], seed=9)
    perm = np.random.default_rng(1).permutation(T)
    jl, jh = _reference_logits(m, m["jmasks"], x)
    tl, th = _port_logits(m, m["tmasks"], x[:, perm])
    np.testing.assert_allclose(th, jh[:, perm], **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


# ---------------------------------------------------------------------------
# what has no decode path, and the CLIs
# ---------------------------------------------------------------------------

def test_every_decode_path_is_refused_as_in_the_reference():
    from repro_torch.launch import serve as TSv
    m = _model(ARCH, ())
    with pytest.raises(SystemExit, match="encoder-only — no decode path"):
        TSv.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    jc, tc = JM.init_cache(m["jcfg"], 2, 8), TM.init_cache(m["tcfg"], 2, 8, "cpu")
    assert set(tc) == set(jc) == {"len"}  # no cache: only the length
    batch = {"frontend_embeds": torch.from_numpy(_embeds(m["tcfg"], 2))}
    for step in (TM.prefill_step, TM.decode_step):
        with pytest.raises(ValueError, match="encoder-only"):
            step(m["tcfg"], m["tparams"], m["tmasks"], batch, tc)
    with pytest.raises(ValueError):  # the reference's scans have no vit branch
        JM.prefill_step(m["jcfg"], m["jparams"], m["jmasks"],
                        {"frontend_embeds": jnp.asarray(batch["frontend_embeds"].numpy())}, jc)
    assert not TM.supports_paged(m["tcfg"]) and not JM.supports_paged(m["jcfg"])


def test_the_train_cli_trains_vit(capsys):
    """``--arch vit-b16 --smoke --device cpu``: SyntheticLM's vit batches
    through the Trainer, the loss finite."""
    from repro_torch.launch import train as TL
    state = TL.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", str(T)])
    out = capsys.readouterr().out
    assert int(state.step) == 2 and "[train] done at step 2" in out
    loss = float(out.split("[trainer] step 0 loss ")[1].split()[0])
    assert np.isfinite(loss)
