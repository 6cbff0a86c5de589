"""The hybrid family (zamba2-7b) against the JAX reference on the CPU, at its
smoke config: 5 Mamba2 layers at ``hybrid_attn_every`` 2, so two groups of
two layers (``m_groups``, lead (2, 2)), each followed by the shared
attention + MLP block (``shared_attn``, no leading axis), then one more
layer (``m_rem``, lead (1,)); every stack kind is present.

Held here: the configs, the registry's names, leads and densities and
``k_fan_map`` at full width (no allocation); the param and cache layouts,
the bridge and the TrainState npz round trip through both checkpoints; the
masked-dense loss and every gradient, the shared block's summed over its
two applications; one SRigL ``dst_update`` over the (g, r), (rem,) and ()
stacks; prefill and decode logits, and greedy tokens, on masked, condensed
and int8 serving trees. Serving through the engine and sync are in
``tests/test_torch_hybrid_engine.py``; the formats and ``Plan.refresh`` on
the shared block's leaves, the launch search, the trainer and the CLIs in
``tests/test_torch_hybrid_plan.py``.

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Tolerances: float32 logits, losses and
gradients within rtol = atol = 1e-5; masks, ``neuron_active``, indices,
stats and tokens exactly.
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
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

from _torch_zoo_model import (TOL, _assert_trees_close, _model, _prompts,  # noqa: E402
                              rewired_generation, to_port)

ARCH = "zamba2-7b"
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})
SHARED = ("wo", "w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# configs, registry, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_and_registry_equal_the_reference(getter):
    jc, tc = getattr(JC, getter)(ARCH), getattr(TC, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas) for s in treg] == [
        (s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_full_width_stacks_and_fan_ins():
    """zamba2-7b's published widths: 13 groups of 6 Mamba2 layers and 3 more,
    the shared block's stacks with no leading axis, the reference's fan-ins
    and about 0.64 B sparse nonzeros at 90% ERK, reckoned without
    allocating."""
    cfg = TC.get_config(ARCH)
    assert TM.hybrid_counts(cfg) == (13, 6, 3)
    reg = TR.build_registry(cfg)
    assert [(s.name, s.d_in, s.d_out, s.lead) for s in reg] == [
        ("m_groups/in_z", 3584, 7168, (13, 6)), ("m_groups/in_x", 3584, 7168, (13, 6)),
        ("m_groups/out_proj", 7168, 3584, (13, 6)),
        ("m_rem/in_z", 3584, 7168, (3,)), ("m_rem/in_x", 3584, 7168, (3,)),
        ("m_rem/out_proj", 7168, 3584, (3,)),
        ("shared_attn/wo", 3584, 3584, ()), ("shared_attn/w_gate", 3584, 14336, ()),
        ("shared_attn/w_up", 3584, 14336, ()), ("shared_attn/w_down", 14336, 3584, ())]
    fans = TR.k_fan_map(cfg, reg)
    assert fans == {"in_z": 360, "in_x": 360, "out_proj": 719, "wo": 479, "w_gate": 300,
                    "w_up": 300, "w_down": 1199}
    nnz = sum(s.n_replicas * s.d_out * fans[s.path[-1]] for s in reg)
    assert 0.63e9 < nnz < 0.65e9
    entries = TM._block_entries(cfg)
    assert len(entries) == 81 + 13
    shared = [e for e in entries if e[0] == "shared_attn"]
    assert [(p, c, w) for _, p, c, w in shared] == [((), (i,), 0) for i in range(13)]


def test_param_cache_layout_and_block_order_equal_the_reference():
    """The port's own init has the reference's paths, shapes and dtypes
    (bf16 params too; ``out_proj`` at the dense fan-in, as in the SSM
    family); the cache's paths and shapes equal the reference's
    ``init_cache`` (13 KV slabs of lead (g,) at full width: 2 here); the
    execution order interleaves the groups and the shared block."""
    m = _model(ARCH, ())
    tcfg, jcfg = m["tcfg"], m["jcfg"]
    assert TM.block_stacks(tcfg) == [("m_groups", (2, 2)), ("m_rem", (1,)), ("shared_attn", ())]
    assert TM._block_order(tcfg) == [
        ("m_groups", (0, 0), 0), ("m_groups", (0, 1), 0), ("shared_attn", (), 0),
        ("m_groups", (1, 0), 0), ("m_groups", (1, 1), 0), ("shared_attn", (), 0),
        ("m_rem", (0,), 0)]
    assert [c for _, _, c, _ in TM._block_entries(tcfg)] == [
        (0, 0), (0, 1), (0,), (1, 0), (1, 1), (1,), (0,)]
    # float32 against the reference's smoke params, bf16 against its shapes
    jbf = tcfg.replace(param_dtype="bfloat16")
    for tc, jp in ((tcfg, m["jparams"]),
                   (jbf, jax.eval_shape(lambda: JM.init_params(
                       jcfg.replace(param_dtype="bfloat16"), jax.random.PRNGKey(0),
                       JR.k_fan_map(jcfg, m["jreg"]))))):
        tp = TM.init_params(tc, torch.Generator().manual_seed(0), TR.k_fan_map(tc, m["treg"]))
        jflat = bridge.flatten(jp)
        tflat = bridge.flatten(tp)
        assert jflat.keys() == tflat.keys()
        for k, v in jflat.items():
            assert tuple(tflat[k].shape) == v.shape, k
            assert str(tflat[k].dtype).removeprefix("torch.") == str(v.dtype), k
    assert tflat["shared_attn/w_down"].shape == (tcfg.d_ff, tcfg.d_model)
    assert tflat["m_groups/in_x"].shape == (2, 2, tcfg.d_model, tcfg.d_inner)
    jcache = JM.init_cache(jcfg, 3, 17)
    tcache = TM.init_cache(tcfg, 3, 17, "cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(
        {k: v for k, v in tcache.items() if k != "len"}).items()} == {
        k: v.shape for k, v in bridge.flatten(jax.tree.map(
            np.asarray, {k: v for k, v in jcache.items() if k != "len"})).items()}
    assert tcache["shared_attn"]["k"].shape[:3] == (2, 3, 17)
    assert tcache["m_groups"]["h"].dtype == tcache["m_rem"]["h"].dtype == torch.float32


def test_train_state_round_trips_through_both_checkpoints(tmp_path):
    """The reference's TrainState npz (params, masks, neuron_active, the
    optimizer's moments and the mask versions of every stack kind, the shared
    block's leaves with no leading axis) restores into a port template
    bitwise and back; the bridge keeps every path."""
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    js = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    want = bridge.flatten(jax.tree.map(np.asarray, js)._asdict())
    assert want["params/shared_attn/w_gate"].shape == (tcfg.d_model, tcfg.d_ff)
    assert want["masks/shared_attn/w_down"].shape == (tcfg.d_ff, tcfg.d_model)
    assert any(k.startswith("masks/m_rem/") for k in want)
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


# ---------------------------------------------------------------------------
# training: loss, gradients, the topology update
# ---------------------------------------------------------------------------

def test_loss_gradients_and_an_srigl_update_equal_the_reference():
    """The masked-dense loss and every gradient against ``jax.grad`` of the
    reference's ``loss_fn`` (the shared block's weights are one tensor read
    by both applications: its gradient is their sum), then one SRigL
    update over the (g, r), (rem,) and () stacks: masks, ``neuron_active``
    and stats exactly."""
    m = _model(ARCH, ())
    toks = _prompts(m["tcfg"], 2, 25, seed=11)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
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
    assert jflat.keys() == leaves.keys()
    for k, v in jflat.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), v, err_msg=k, **TOL)
    for f in SHARED:  # one gradient, no leading axis, dense through the mask
        g = leaves[f"shared_attn/{f}"].grad
        assert g.shape == TR.get_path(m["tmasks"], ("shared_attn", f)).shape
        assert bool((g[~m["tmasks"]["shared_attn"][f]] != 0).any())

    drop = np.float32(0.3)
    jnew, jstats = JR.dst_update(
        m["jcfg"], m["jreg"], m["jparams"], jax.tree.map(jnp.asarray, bridge.unflatten(jflat)),
        {"masks": m["jmasks"], "neuron_active": m["jactive"]}, drop, jax.random.PRNGKey(0))
    tnew, tstats = TR.dst_update(
        m["tcfg"], m["treg"], m["tparams"], bridge.from_jax_numpy(jflat),
        {"masks": m["tmasks"], "neuron_active": m["tactive"]}, drop)
    for key in ("masks", "neuron_active"):
        jf, tf = bridge.flatten(jax.tree.map(np.asarray, jnew[key])), bridge.flatten(tnew[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(), jf[k], err_msg=f"{key}/{k}")
    moved = {}
    for s in m["treg"]:
        for f, v in jstats[s.name].items():
            assert tuple(tstats[s.name][f].shape) == s.lead
            np.testing.assert_array_equal(tstats[s.name][f].numpy(), np.asarray(v),
                                          err_msg=f"{s.name}/{f}")
        moved[len(s.lead)] = moved.get(len(s.lead), 0) + int(tstats[s.name]["n_pruned"].sum())
    assert all(moved[n] > 0 for n in (0, 1, 2)), moved


# ---------------------------------------------------------------------------
# serving: prefill + decode, greedy tokens
# ---------------------------------------------------------------------------

def _trees(m, path: str, values_dtype=None):
    """(reference serving tree, port serving tree): the masks, or each
    framework's plan export at ``values_dtype``."""
    if path == "masked":
        return m["jmasks"], m["tmasks"]
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"], batch_size=2,
                          path=path, values_dtype=values_dtype)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], m["tmasks"], batch_size=2,
                          path=path, values_dtype=values_dtype, profile=PROFILE)
    return jplan.serving_tree, tplan.serving_tree


@functools.lru_cache(maxsize=None)
def _jitted_steps(jcfg):
    """The reference's prefill and decode steps, each one compiled program
    (its eager dispatch of the serving trees' Pallas calls in interpret mode
    is several times slower)."""
    return (jax.jit(functools.partial(JM.prefill_step, jcfg)),
            jax.jit(functools.partial(JM.decode_step, jcfg)))


@pytest.mark.parametrize("path,values_dtype", [("masked", None), ("condensed", None),
                                               ("condensed", "int8")])
def test_prefill_decode_logits_and_greedy_tokens_equal_the_reference(path, values_dtype):
    """A 2 x 21 prompt (the SSD chunk 16: one full and one padded chunk, the
    state carried across), then 6 greedy decode steps, each fed the
    reference's argmax: logits within 1e-5 at every step, the port's argmax
    equal to the reference's, every SSM state and KV slab close at the end,
    and each of the shared block's KV slabs written."""
    m = _model(ARCH, ())
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jtree, ttree = _trees(m, path, values_dtype)
    if path != "masked":
        for s in m["treg"]:
            jleaf, tleaf = JR.get_path(jtree, s.path), TR.get_path(ttree, s.path)
            np.testing.assert_array_equal(tleaf.indices.numpy(), np.asarray(jleaf.indices))
            assert tuple(tleaf.indices.shape[:len(s.lead)]) == s.lead
    toks = _prompts(tcfg, 2, 21, seed=7)
    jcache, tcache = JM.init_cache(jcfg, 2, 28), TM.init_cache(tcfg, 2, 28, "cpu")
    prefill, decode = _jitted_steps(jcfg)
    jl, jcache = prefill(m["jparams"], jtree, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = TM.prefill_step(tcfg, m["tparams"], ttree, {"tokens": torch.from_numpy(toks)},
                                 tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jcache = decode(m["jparams"], jtree, {"tokens": jnp.asarray(tok[:, None])}, jcache)
        tl, tcache = TM.decode_step(tcfg, m["tparams"], ttree,
                                    {"tokens": torch.from_numpy(tok[:, None])}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))
    assert int(tcache["len"]) == int(jcache["len"]) == 27
    _assert_trees_close({k: v for k, v in jcache.items() if k != "len"},
                        {k: v for k, v in tcache.items() if k != "len"}, **TOL)
    for i in range(TM.hybrid_counts(tcfg)[0]):
        assert bool((tcache["shared_attn"]["k"][i, :, :27] != 0).any())
        assert not bool((tcache["shared_attn"]["k"][i, :, 27:] != 0).any())
    # a reset cache prefills as a fresh one: every SSM state zeroed
    TM.reset_cache(tcfg, tcache)
    assert not any(bool(tcache[key][f].any()) for key in ("m_groups", "m_rem")
                   for f in TM.SSM_STATE)
    again, _ = TM.prefill_step(tcfg, m["tparams"], ttree, {"tokens": torch.from_numpy(toks)},
                               tcache)
    fresh, _ = TM.prefill_step(tcfg, m["tparams"], ttree, {"tokens": torch.from_numpy(toks)},
                               TM.init_cache(tcfg, 2, 28, "cpu"))
    assert torch.equal(again, fresh)
