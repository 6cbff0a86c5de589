"""The port's training path against the JAX reference, on the CPU.

* ``SyntheticLM`` batches are identical (both draw with numpy from the
  same seeds); the ``Prefetcher`` hands them over as tensors.
* The straight-through mask: the forward value is ``w * mask`` with +0 at
  masked positions, and the gradient is DENSE, equal to the reference's
  (the masked ``w * mask`` the port used before had a zero gradient there).
* ``loss_fn`` and its params gradient on the smoke model: rtol 1e-6 /
  atol 1e-6 (float32; the sums run in other orders).
* A bridged ``TrainState`` trained 6 steps with ``delta_t=3`` by the port's
  ``Trainer`` and by the reference's: the logged losses agree to their 4
  printed decimals (2e-4), params within atol 1e-5, and masks,
  ``neuron_active`` and ``mask_versions`` after the two DST updates are
  EXACTLY equal.
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs, saves
  checkpoints and resumes from them (``--method rigl|set``:
  ``test_torch_rigl_set.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.core import srigl as JS  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.core import srigl as TS  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.mark.parametrize("seed,vocab", [(0, 256), (3, 151_936)])
def test_synthetic_batches_are_identical(seed, vocab):
    j = JP.SyntheticLM(vocab_size=vocab, seq_len=16, batch_size=3, seed=seed)
    t = TP.SyntheticLM(vocab_size=vocab, seq_len=16, batch_size=3, seed=seed)
    for step in (0, 1, 7):
        a, b = j.batch(step), t.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetcher_hands_over_the_batches_as_tensors():
    data = TP.SyntheticLM(vocab_size=50, seq_len=8, batch_size=2, seed=1)
    pre = TP.Prefetcher(data.iterate(), depth=2)
    try:
        for step in range(3):
            got = next(pre)
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            assert np.array_equal(got["tokens"].numpy(), data.batch(step)["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_straight_through_mask_gives_the_reference_dense_gradient():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((12, 9)).astype(np.float32)
    mask = rng.random(w.shape) < 0.3
    x = rng.standard_normal((4, 12)).astype(np.float32)
    cot = rng.standard_normal((4, 9)).astype(np.float32)
    jw = jnp.asarray(w)
    _, jvjp = jax.vjp(lambda w_: jnp.asarray(x) @ JS.apply_mask_for_forward(w_, jnp.asarray(mask)),
                      jw)
    (jg,) = jvjp(jnp.asarray(cot))
    tw = torch.from_numpy(w).requires_grad_()
    fwd = TS.apply_mask_for_forward(tw, torch.from_numpy(mask))
    np.testing.assert_array_equal(fwd.detach().numpy(), w * mask)
    assert not np.signbit(fwd.detach().numpy()[~mask]).any()  # +0, not -0
    with torch.no_grad():  # serving's single select: the same bits
        served = TS.apply_mask_for_forward(tw, torch.from_numpy(mask))
    np.testing.assert_array_equal(served.numpy().view(np.int32),
                                  fwd.detach().numpy().view(np.int32))
    (torch.from_numpy(x) @ fwd).backward(torch.from_numpy(cot))
    g = tw.grad.numpy()
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert np.abs(g[~mask]).min() > 0  # dense: non-zero where the mask is off
    np.testing.assert_allclose(g, x.T @ cot, rtol=1e-5, atol=1e-5)


def _batch(cfg, seed=0, b=2, t=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_loss_and_its_params_gradient_match_the_reference():
    m = smoke_model()
    batch = _batch(m["tcfg"])
    jloss, jg = jax.value_and_grad(
        lambda p: JM.loss_fn(m["jcfg"], p, m["jmasks"], jax.tree.map(jnp.asarray, batch))[0]
    )(m["jparams"])
    params = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jparams"]))
    leaves = bridge.flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    tmasks = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jmasks"]))
    loss = TM.loss_fn(m["tcfg"], params, tmasks, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    jflat = bridge.flatten(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), jflat[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the sparse stacks' gradients are dense
    w_gate = leaves["blocks/w_gate"].grad
    assert bool((w_gate[~tmasks["blocks"]["w_gate"]] != 0).any())


def _cfgs(delta_t: int):
    out = []
    for C in (JCfg, TCfg):
        c = C.get_smoke_config(ARCH)
        out.append(c.replace(sparsity=dataclasses.replace(c.sparsity, delta_t=delta_t)))
    return out


def _losses(lines):
    return [float(line.split(" loss ")[1].split()[0]) for line in lines
            if line.startswith("[trainer] step")]


def test_trainer_matches_the_reference_over_six_steps_with_dst():
    jcfg, tcfg = _cfgs(delta_t=3)
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    jdata = JP.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    tdata = TP.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    jlog, tlog, published = [], [], []
    jout = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, 6), log_every=1).fit(
        jstate, (jax.tree.map(jnp.asarray, b) for b in jdata.iterate()), 6, log_fn=jlog.append)
    trainer = TT.Trainer(cfg=tcfg, lr_fn=TSc.warmup_cosine(3e-3, 1, 6), log_every=1,
                         publisher=lambda s: published.append(
                             {k: int(v) for k, v in s.mask_versions.items()}))
    tout = trainer.fit(tstate, tdata.iterate(), 6, log_fn=tlog.append)
    assert int(tout.step) == 6
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), atol=2e-4)
    assert len(_losses(tlog)) == 6
    # DST ran after steps 3 and 6; the publisher saw the stamped versions
    assert published == [{s: 1 for s in tout.mask_versions}, {s: 2 for s in tout.mask_versions}]
    jo = jax.tree.map(np.asarray, jout)._asdict()
    to = bridge.train_state_to_jax_numpy(tout)
    for key in ("masks", "neuron_active", "mask_versions"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{key}/{k}")
    for key in ("params", "opt_state"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        for k in jf:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5, atol=1e-5, err_msg=f"{key}/{k}")
    for s in trainer.registry:  # the topology did move
        assert not torch.equal(tout.masks["blocks"][s.path[-1]],
                               tstate.masks["blocks"][s.path[-1]])


def test_microbatches_and_a_saliency_window_match_the_reference():
    """make_train_step with 2 microbatches and a 2-step dense-gradient
    window (grad_accum_for_saliency), then make_dst_step reading the
    window: losses and grad norms within rtol 1e-5, the accumulator within
    atol 1e-5, the masks after the update EXACTLY equal."""
    jcfg, tcfg = (c.replace(sparsity=dataclasses.replace(c.sparsity, delta_t=2,
                                                          grad_accum_for_saliency=2))
                  for c in _cfgs(delta_t=2))
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    assert bridge.flatten(tstate.grad_accum).keys() == bridge.flatten(
        jax.tree.map(np.asarray, jstate.grad_accum)).keys()
    jreg, treg = JT.REG.build_registry(jcfg), TT.REG.build_registry(tcfg)
    jstep = jax.jit(JT.make_train_step(jcfg, jreg, JSc.warmup_cosine(3e-3, 1, 4),
                                       microbatches=2))
    tstep = TT.make_train_step(tcfg, treg, TSc.warmup_cosine(3e-3, 1, 4), microbatches=2)
    data = TP.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=8, batch_size=4, seed=2)
    for step in range(2):
        batch = data.batch(step)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jstate = jax.jit(JT.make_dst_step(jcfg, jreg))(jstate, jax.tree.map(jnp.asarray, batch))
    tstate = TT.make_dst_step(tcfg, treg)(tstate, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    jo = jax.tree.map(np.asarray, jstate)._asdict()
    to = bridge.train_state_to_jax_numpy(tstate)
    for k, v in bridge.flatten(jo["grad_accum"]).items():
        np.testing.assert_allclose(bridge.flatten(to["grad_accum"])[k], v, atol=1e-5)
    for key in ("masks", "neuron_active"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{key}/{k}")


def test_cli_trains_on_the_cpu_and_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    state = TL.main(args)
    out = capsys.readouterr().out
    assert "[trainer] step 0 loss" in out and "[train] done at step 4" in out
    assert int(state.step) == 4 and all(np.isfinite(v.numpy()).all() for v in
                                        bridge.flatten(state.params).values())
    again = TL.main(args[:-4] + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and int(again.step) == 6
