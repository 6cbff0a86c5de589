"""Training the configs beyond qwen3-1.7b against the JAX reference, on the
CPU at smoke dims: loss, gradients and an SRigL update through gemma3-1b's
grouped backbone (6 and 8 layers), qwen2-vl-7b's M-RoPE, its vlm batches
and train steps, and two Adafactor steps of internlm2-20b (bfloat16 params,
held within one bf16 ulp) and mistral-large-123b.

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, indices,
batches and tokens are held equal exactly; float32 logits, losses and
gradients within rtol = atol = 1e-5, as ``tests/test_torch_models.py``
states. On the CPU every sparse linear runs K1's plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from _torch_zoo_model import GEMMA, TOL, _assert_trees_close, _ids, _model  # noqa: E402


# ---------------------------------------------------------------------------
# training: loss and gradients, one SRigL update, Adafactor
# ---------------------------------------------------------------------------

def _loss_and_grads(m, batch: dict):
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(m["jcfg"], p, m["jmasks"], b)[0]))(
            m["jparams"], jax.tree.map(jnp.asarray, batch))
    params = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jparams"]))
    leaves = bridge.flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    loss = TM.loss_fn(m["tcfg"], params, m["tmasks"],
                      {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})[0]
    loss.backward()
    return (jloss, jg), (loss, {k: v.grad for k, v in leaves.items()})


def _batch(cfg, seed: int = 0, b: int = 2, t: int = 24) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("arch,kw", GEMMA, ids=_ids(GEMMA))
def test_loss_gradients_and_an_srigl_update_through_the_grouped_backbone(arch, kw):
    m = _model(arch, kw)
    (jloss, jg), (tloss, tg) = _loss_and_grads(m, _batch(m["tcfg"]))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    jflat = bridge.flatten(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == tg.keys()
    for k, v in jflat.items():
        np.testing.assert_allclose(tg[k].numpy(), v, err_msg=k, **TOL)

    # one SRigL update on the same dense gradients, (g, r) stacks included
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


def _vlm_batch(cfg, seed: int = 0, b: int = 2, t: int = 12) -> dict:
    """A vlm batch whose three M-RoPE streams differ: t runs on, h and w
    walk a 4-wide patch grid."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    pos = np.arange(t, dtype=np.int32)
    streams = np.stack([pos, pos // 4, pos % 4])
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "frontend_embeds": (rng.standard_normal((b, t, cfg.d_model)) * 0.02
                                ).astype(np.float32),
            "mrope_positions": np.ascontiguousarray(
                np.broadcast_to(streams[:, None], (3, b, t)))}


def test_vlm_loss_and_gradients_with_frontend_embeds_and_distinct_mrope_streams():
    m = _model("qwen2-vl-7b", ())
    batch = _vlm_batch(m["tcfg"])
    (jloss, jg), (tloss, tg) = _loss_and_grads(m, batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    for k, v in bridge.flatten(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(tg[k].numpy(), v, err_msg=k, **TOL)
    # the streams and the embeddings move the loss: they are read
    plain = {k: batch[k] for k in ("tokens", "targets")}
    (jplain, _), (tplain, _) = _loss_and_grads(m, plain)
    np.testing.assert_allclose(tplain.item(), float(jplain), **TOL)
    assert abs(tplain.item() - tloss.item()) > 1e-4


def test_apply_mrope_with_distinct_streams_equals_the_reference():
    rng = np.random.default_rng(5)
    for d in (16, 20, 128):   # 20: the bands do not split evenly
        x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
        pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # equal streams give plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_allclose(
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e4).numpy(),
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e4).numpy(), **TOL)


@pytest.mark.parametrize("seed", [0, 4])
def test_vlm_synthetic_batches_equal_the_reference_bitwise(seed):
    j = JD.SyntheticLM(vocab_size=256, seq_len=10, batch_size=3, seed=seed, d_model=64,
                       family="vlm")
    t = TD.SyntheticLM(vocab_size=256, seq_len=10, batch_size=3, seed=seed, d_model=64,
                       family="vlm")
    for step in (0, 5):
        a, b = j.batch(step), t.batch(step)
        assert a.keys() == b.keys() == {"tokens", "targets", "frontend_embeds",
                                        "mrope_positions"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    cfg = TC.get_smoke_config("qwen2-vl-7b")
    got = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 2, 5)
    want = JD.make_train_batch(JC.get_smoke_config("qwen2-vl-7b"), jax.random.PRNGKey(0), 2, 5)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    np.testing.assert_array_equal(got["mrope_positions"].numpy(),
                                  np.asarray(want["mrope_positions"]))


def test_vlm_train_step_with_microbatches_equals_the_reference():
    """The trainer's step on SyntheticLM vlm batches, split into two
    microbatches (the (3, B, T) streams along their batch axis)."""
    jcfg = JC.get_smoke_config("qwen2-vl-7b")
    tcfg = TC.get_smoke_config("qwen2-vl-7b")
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(JT.make_train_step(jcfg, JR.build_registry(jcfg),
                                       JSc.warmup_cosine(3e-3, 1, 4), microbatches=2))
    tstep = TT.make_train_step(tcfg, TR.build_registry(tcfg), TSc.warmup_cosine(3e-3, 1, 4),
                               microbatches=2)
    data = TD.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=8, batch_size=4, seed=1,
                          d_model=tcfg.d_model, family="vlm")
    for step in range(2):
        batch = data.batch(step)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
    _assert_trees_close(jstate.params, tstate.params, **TOL)


def _ulp_bf16(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each of ``a``'s values (2^-7 of its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("arch", ["internlm2-20b", "mistral-large-123b"])
def test_adafactor_train_steps_equal_the_reference(arch):
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    assert tcfg.optimizer == jcfg.optimizer == "adafactor"
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    before = bridge.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params))
    jstep = jax.jit(JT.make_train_step(jcfg, JR.build_registry(jcfg),
                                       JSc.warmup_cosine(3e-3, 1, 4)))
    tstep = TT.make_train_step(tcfg, TR.build_registry(tcfg), TSc.warmup_cosine(3e-3, 1, 4))
    data = TD.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=8, batch_size=2, seed=0)
    jnew, tnew = jstate, tstate
    for step in range(2):  # the warmup's first step has lr 0
        batch = data.batch(step)
        jnew, jm = jstep(jnew, jax.tree.map(jnp.asarray, batch))
        tnew, tm = tstep(tnew, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
    jp = bridge.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), jnew.params))
    tp = bridge.flatten(tnew.params)
    moved = 0
    for k, v in jp.items():
        got = tp[k].float().numpy()
        if tcfg.param_dtype == "bfloat16":  # within one bf16 ulp of the reference
            assert (np.abs(got - v) <= _ulp_bf16(v)).all(), k
        else:
            np.testing.assert_allclose(got, v, err_msg=k, **TOL)
        moved += int((got != before[k]).sum())
    assert moved > 0
    _assert_trees_close(jnew.opt_state, tnew.opt_state, rtol=1e-4, atol=1e-6)
