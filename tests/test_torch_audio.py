"""The audio family (musicgen-medium's codebooks) against the JAX reference
on the CPU, at its smoke config (2 layers, 2 codebooks of 64 tokens padded
to 128, 4 heads padded to 16).

Held here: the config and registry (ERK densities; full-width fan-ins
without allocating), the parameter layout (one embedding table and one
head a codebook: ``embed`` (K, Vp, d), ``lm_head`` (K, d, Vp)) through the
bridge and both npz checkpoints, ``SyntheticLM``'s and
``make_train_batch``'s (B, K, T) batches, the loss (the mean of the K
codebooks' cross-entropies) and its gradients, one SRigL update,
``prefill_step`` / ``decode_step`` logits (B, K, V) over masked, condensed
and int8 condensed trees with greedy tokens a codebook, the serving loops'
refusals of (B, K, T) prompts (as the reference's fail or refuse), and the
train CLI.

The reference's weights and masks (``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, batches and
tokens exactly; float32 logits, losses and gradients within rtol = atol =
1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

from _torch_zoo_model import TOL, _model, to_port  # noqa: E402

ARCH = "musicgen-medium"


def _tokens(cfg, b: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, cfg.n_codebooks, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# config, registry, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_and_registry_equal_the_reference(getter):
    jc, tc = getattr(JC, getter)(ARCH), getattr(TC, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("vocab_padded", "n_heads_padded", "n_kv_heads_padded", "head_to_kv",
                 "q_dim", "kv_dim"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in treg] == [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas,
                                s.name) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_full_width_stacks_and_fan_ins():
    """musicgen-medium at full width: 24 heads padded to 32 (q_dim 2048), 4
    codebooks of 2048, ERK densities at 90%; every d_in within K1's decode
    kernel (below 6656); nothing is allocated."""
    cfg = TC.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads_padded, cfg.q_dim, cfg.d_ff,
            cfg.vocab_size, cfg.vocab_padded, cfg.n_codebooks) == (
        48, 1536, 32, 2048, 6144, 2048, 2048, 4)
    reg = TR.build_registry(cfg)
    assert [(s.name, s.d_in, s.d_out, s.lead) for s in reg] == [
        ("blocks/wo", 2048, 1536, (48,)), ("blocks/w_gate", 1536, 6144, (48,)),
        ("blocks/w_up", 1536, 6144, (48,)), ("blocks/w_down", 6144, 1536, (48,))]
    assert TR.k_fan_map(cfg, reg) == {"wo": 276, "w_gate": 148, "w_up": 148, "w_down": 591}
    jc = JC.get_config(ARCH)
    assert TR.k_fan_map(cfg, reg) == JR.k_fan_map(jc, JR.build_registry(jc))
    assert max(s.d_in for s in reg) < 6656
    assert not TM.supports_paged(cfg) and not JM.supports_paged(jc)


def test_param_layout_cache_and_the_bridge():
    """One embedding table and one head a codebook, the blocks' stack and
    KV cache as the dense family's; the reference's params cross to the
    port and back bitwise."""
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), TR.k_fan_map(cfg, m["treg"]))
    jflat = bridge.flatten(jax.tree.map(np.asarray, m["jparams"]))
    assert {k: v.shape for k, v in jflat.items()} == {
        k: tuple(v.shape) for k, v in bridge.flatten(tp).items()}
    k, vp, d = cfg.n_codebooks, cfg.vocab_padded, cfg.d_model
    assert tp["embed"].shape == (k, vp, d) and tp["lm_head"].shape == (k, d, vp)
    back = bridge.flatten(bridge.to_jax_numpy(m["tparams"]))
    for key, v in jflat.items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)
    jc = bridge.flatten(jax.tree.map(np.asarray, JM.init_cache(m["jcfg"], 3, 20)))
    tc = bridge.flatten(TM.init_cache(cfg, 3, 20, "cpu"))
    assert {key: v.shape for key, v in jc.items()} == {
        key: tuple(v.shape) for key, v in tc.items()}


def test_train_state_round_trips_through_both_checkpoints(tmp_path):
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    js = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    want = bridge.flatten(jax.tree.map(np.asarray, js)._asdict())
    assert want["params/embed"].shape == (tcfg.n_codebooks, tcfg.vocab_padded, tcfg.d_model)
    template = TSt.init_train_state(tcfg, torch.Generator().manual_seed(1))
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

def test_synthetic_batches_equal_the_reference():
    """B * K Markov streams drawn as one, row b * K + k codebook k of
    sequence b, as the train CLIs build them."""
    cfg = TC.get_smoke_config(ARCH)
    kw = dict(vocab_size=max(cfg.vocab_size, 2), seq_len=11, batch_size=3, seed=4,
              family=cfg.family, n_codebooks=cfg.n_codebooks, d_model=cfg.d_model)
    jdata, tdata = JD.SyntheticLM(**kw), TD.SyntheticLM(**kw)
    for step in (0, 5):
        jb, tb = jdata.batch(step), tdata.batch(step)
        assert set(tb) == set(jb) == {"tokens", "targets"}
        for k in jb:
            assert tb[k].shape == (3, cfg.n_codebooks, 11) and tb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        np.testing.assert_array_equal(tb["tokens"][..., 1:], tb["targets"][..., :-1])


def test_make_train_batch_keys_shapes_and_dtypes():
    cfg = TC.get_smoke_config(ARCH)
    b = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 3, 11)
    jb = JD.make_train_batch(JC.get_smoke_config(ARCH), jax.random.PRNGKey(0), 3, 11)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in b.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jb.items()}
    assert torch.equal(b["tokens"][..., 1:], b["targets"][..., :-1])
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# loss, gradients, SRigL
# ---------------------------------------------------------------------------

def test_loss_gradients_and_an_srigl_update_equal_the_reference():
    m = _model(ARCH, ())
    toks = _tokens(m["tcfg"], 2, 13, seed=1)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
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
    # every codebook's head and table is trained
    for k in range(m["tcfg"].n_codebooks):
        assert bool(leaves["lm_head"].grad[k].any()) and bool(leaves["embed"].grad[k].any())

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


# ---------------------------------------------------------------------------
# serving: prefill_step / decode_step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trees(path: str, values_dtype: str | None):
    m = _model(ARCH, ())
    if path == "masked":
        return m["jmasks"], m["tmasks"]
    return (JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"], batch_size=2,
                          path=path, values_dtype=values_dtype).serving_tree,
            TP.build_plan(m["tcfg"], m["treg"], m["tparams"], m["tmasks"], batch_size=2,
                          path=path, values_dtype=values_dtype).serving_tree)


@pytest.mark.parametrize("path,values_dtype", [("masked", None), ("condensed", None),
                                               ("condensed", "int8")])
def test_prefill_and_decode_logits_and_greedy_tokens_equal_the_reference(path, values_dtype):
    """Prompts (2, K, 10), then 6 greedy decode steps, each codebook's next
    token its own argmax: the (B, K, Vp) logits within 1e-5 (padded vocab
    columns -inf in both), every codebook's tokens equal, the caches
    close."""
    m = _model(ARCH, ())
    jtree, ttree = _trees(path, values_dtype)
    cfg = m["tcfg"]
    prompts = _tokens(cfg, 2, 10, seed=3)
    jcache, tcache = JM.init_cache(m["jcfg"], 2, 17), TM.init_cache(cfg, 2, 17, "cpu")
    jprefill = jax.jit(functools.partial(JM.prefill_step, m["jcfg"]))
    jdecode = jax.jit(functools.partial(JM.decode_step, m["jcfg"]))
    jl, jcache = jprefill(m["jparams"], jtree, {"tokens": jnp.asarray(prompts)}, jcache)
    tl, tcache = TM.prefill_step(cfg, m["tparams"], ttree,
                                 {"tokens": torch.from_numpy(prompts)}, tcache)
    jtoks, ttoks = [], []
    for step in range(7):
        assert tl.shape == (2, cfg.n_codebooks, cfg.vocab_padded) and tl.dtype == torch.float32
        jl = np.asarray(jl)
        assert bool(torch.isinf(tl[..., cfg.vocab_size:]).all())
        np.testing.assert_allclose(tl[..., :cfg.vocab_size].numpy(), jl[..., :cfg.vocab_size],
                                   err_msg=f"step {step}", **TOL)
        jtoks.append(jl.argmax(-1).astype(np.int32))
        ttoks.append(tl.argmax(-1).to(torch.int32))
        if step == 6:
            break
        jl, jcache = jdecode(m["jparams"], jtree, {"tokens": jnp.asarray(jtoks[-1][..., None])},
                             jcache)
        tl, tcache = TM.decode_step(cfg, m["tparams"], ttree,
                                    {"tokens": ttoks[-1][..., None]}, tcache)
    np.testing.assert_array_equal(torch.stack(ttoks, -1).numpy(), np.stack(jtoks, -1))
    assert int(tcache["len"]) == int(jcache["len"]) == 16
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["blocks"][k].numpy(),
                                   np.asarray(jcache["blocks"][k]), **TOL)


# ---------------------------------------------------------------------------
# what the serving loops refuse, and the CLIs
# ---------------------------------------------------------------------------

def test_the_serving_loops_refuse_audio_prompts_as_the_reference_does():
    """The reference's ``generate`` fails on (B, K, T) prompts (``b, t =
    prompts.shape``) and its ``ServingEngine.submit`` refuses them; the
    port refuses them in ``generate``, ``ServingModel``, the engine and the
    serve CLI with a ValueError that names prefill_step / decode_step."""
    from repro_torch.launch import serve as TSv
    m = _model(ARCH, ())
    prompts = _tokens(m["tcfg"], 2, 6)
    with pytest.raises(ValueError):
        JE.generate(m["jcfg"], m["jparams"], m["jmasks"], jnp.asarray(prompts), 2)
    with pytest.raises(ValueError, match="prefill_step and decode_step"):
        TE.generate(m["tcfg"], m["tparams"], m["tmasks"], torch.from_numpy(prompts), 2)
    with pytest.raises(ValueError, match="prefill_step and decode_step"):
        TE.ServingModel(m["tcfg"], m["tparams"], m["tmasks"]).generate(
            torch.from_numpy(prompts), 2)
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="masked")
    with pytest.raises(ValueError):
        jeng.submit(jnp.asarray(prompts), 2)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path="masked")
    assert not teng.paged
    for p in (prompts, prompts[:, 0]):  # (B, K, T), and (B, T) as the CLI would build
        with pytest.raises(ValueError, match="prefill_step and decode_step"):
            teng.submit(torch.from_numpy(p), 2)
    with pytest.raises(ValueError, match="prefill_step and decode_step"):
        TSv.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_the_train_cli_trains_audio(capsys):
    """``--arch musicgen-medium --smoke --device cpu``: the CLI hands
    ``n_codebooks`` to SyntheticLM, whose (B, K, T) batches train."""
    from repro_torch.launch import train as TL
    state = TL.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert int(state.step) == 2 and "[train] done at step 2" in out
    assert np.isfinite(float(out.split("[trainer] step 0 loss ")[1].split()[0]))
