"""The port's RigL and SET baselines against the JAX reference, on the CPU.

* ``prune_survivors`` / ``top_k_candidates`` and RigL's masks and stats
  (``n_pruned``, ``n_grown``, ``nnz``, ``n_ablated``) are EXACTLY equal to
  the reference's on the same numpy inputs, for one layer and for a stack
  with ``lead=(2, 3)`` (the reference vmaps both leading axes; the port's
  registry maps the first and ``rigl_update`` loops the second), with the
  reference's float32 drop fraction given to both sides.
* SET regrows from ``jax.random`` in the reference, which torch cannot
  reproduce: its survivors are exact, and its growth is held to the
  invariants (grown positions were inactive, as many as were pruned, nnz
  constant) and to reproducibility by seed and step.
* ``init_sparsity_state``: exactly ``target_nnz`` True per layer.
* The Trainer with ``--method rigl`` over six steps and two updates: masks
  and ``mask_versions`` EXACTLY the reference Trainer's; with SET, the
  versions and the invariants, and a restore at step 3 regrows as an
  uninterrupted run does.
* ITOP rates equal to the reference's for the same masks.
* ``python -m repro_torch.launch.train --method rigl|set --device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.core import rigl as JRig  # noqa: E402
from repro.core import saliency as JSal  # noqa: E402
from repro.core import schedule as JSch  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.core import rigl as TRig  # noqa: E402
from repro_torch.core import saliency as TSal  # noqa: E402
from repro_torch.core import schedule as TSch  # noqa: E402
from repro_torch.core import set_sparse as TSet  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCk  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

ARCH = "qwen3-1.7b"
DROP = JSch.DSTSchedule(delta_t=3, total_steps=8).drop_fraction(3)  # the reference's f32


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape and np.array_equal(a, b), (a, b)


def _layer(seed, shape=(48, 40), density=0.2, ties=False):
    """Masked weights, dense grads and an unstructured mask; with ``ties``
    the magnitudes repeat (and zeros of both signs appear), so the rank
    order of equal values decides."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    if ties:
        w = rng.integers(-3, 4, size=shape).astype(np.float32) / 2
        g = rng.integers(-3, 4, size=shape).astype(np.float32) / 4
        w[rng.random(shape) < 0.1] = -0.0
    else:
        w = rng.standard_normal(shape).astype(np.float32)
        g = rng.standard_normal(shape).astype(np.float32)
    return (w * mask).astype(np.float32), g, mask


@pytest.mark.parametrize("ties", [False, True])
def test_prune_survivors_and_top_k_candidates_equal_the_reference(ties):
    w, g, mask = _layer(0, ties=ties)
    for n in (0, 1, 17, int(mask.sum()) // 3, int(mask.sum())):
        _same(JSal.prune_survivors(jnp.asarray(w), jnp.asarray(mask), jnp.int32(n)),
              TSal.prune_survivors(_t(w), _t(mask), torch.tensor(n, dtype=torch.int32)))
        _same(JSal.top_k_candidates(jnp.abs(jnp.asarray(g)), jnp.asarray(~mask), jnp.int32(n)),
              TSal.top_k_candidates(_t(g).abs(), _t(~mask), torch.tensor(n)))


@pytest.mark.parametrize("seed,ties,drop", [(1, False, DROP), (2, True, DROP),
                                            (3, False, np.float32(0.5))])
def test_rigl_update_equals_the_reference_exactly(seed, ties, drop):
    w, g, mask = _layer(seed, ties=ties)
    d_in, d_out = w.shape
    spec = dict(name="l", d_in=d_in, d_out=d_out, density=0.2)
    jst, jstats = JRig.rigl_update(JRig.RigLSpec(**spec), jnp.asarray(w), jnp.asarray(g),
                                   JRig.RigLState(jnp.asarray(mask)), jnp.float32(drop))
    tst, tstats = TRig.rigl_update(TRig.RigLSpec(**spec), _t(w), _t(g),
                                   TRig.RigLState(_t(mask)), drop)
    _same(jst.mask, tst.mask)
    assert list(jstats) == list(tstats) == ["n_pruned", "n_grown", "nnz", "n_ablated"]
    for k in jstats:
        assert tstats[k].dtype == torch.int32
        _same(jstats[k], tstats[k])
    assert int(tstats["nnz"]) == int(mask.sum()) and int(tstats["n_grown"]) > 0


def _cfgs(method: str, delta_t: int = 3):
    out = []
    for C in (JCfg, TCfg):
        c = C.get_smoke_config(ARCH)
        out.append(c.replace(sparsity=dataclasses.replace(c.sparsity, method=method,
                                                           delta_t=delta_t)))
    return out


def _stack_inputs(lead, d_in=24, d_out=20, seed=4):
    """A registry stack with ``lead`` and its params/grads/state trees."""
    rng = np.random.default_rng(seed)
    shape = (*lead, d_in, d_out)
    mask = rng.random(shape) < 0.25
    w = (rng.standard_normal(shape) * mask).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    # the last neuron of every layer keeps tiny weights and no gradient, so
    # RigL prunes it empty: an implicit ablation
    w[..., -1] *= 1e-6
    g[..., -1] = 0.0
    tree = (lambda a: {"blocks": {"w": a}})
    state = {"masks": tree(mask), "neuron_active": tree(np.ones((*lead, d_out), bool))}
    return ((JR.SparseStack(("blocks", "w"), d_in, d_out, lead, density=0.25),
             TR.SparseStack(("blocks", "w"), d_in, d_out, lead, density=0.25)),
            tree(w), tree(g), state)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_registry_rigl_update_over_a_stack_equals_the_reference(lead):
    (js, ts), w, g, state = _stack_inputs(lead)
    jcfg, tcfg = _cfgs("rigl")
    jnew, jstats = JR.dst_update(jcfg, [js], jax.tree.map(jnp.asarray, w),
                                 jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, state), DROP,
                                 jax.random.PRNGKey(0))
    tnew, tstats = TR.dst_update(tcfg, [ts], bridge.from_jax_numpy(w), bridge.from_jax_numpy(g),
                                 {k: bridge.from_jax_numpy(v) for k, v in state.items()}, DROP)
    for key in ("masks", "neuron_active"):
        _same(jnew[key]["blocks"]["w"], tnew[key]["blocks"]["w"])
    assert set(jstats[ts.name]) == set(tstats[ts.name])
    for k, v in jstats[ts.name].items():
        _same(v, tstats[ts.name][k])
    assert int(tstats[ts.name]["n_ablated"].sum()) >= max(1, int(np.prod(lead)))
    # neuron_active is carried unchanged, though RigL emptied a column
    assert bool(tnew["neuron_active"]["blocks"]["w"].all())


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_set_update_survivors_invariants_and_seed(lead):
    (_, ts), w, g, state = _stack_inputs(lead, seed=6)
    _, tcfg = _cfgs("set")
    args = (tcfg, [ts], bridge.from_jax_numpy(w), bridge.from_jax_numpy(g),
            {k: bridge.from_jax_numpy(v) for k, v in state.items()}, DROP)
    new, stats = TR.dst_update(*args, torch.Generator().manual_seed(7))
    again, _ = TR.dst_update(*args, torch.Generator().manual_seed(7))
    other, _ = TR.dst_update(*args, torch.Generator().manual_seed(8))
    mask, got = state["masks"]["blocks"]["w"], new["masks"]["blocks"]["w"].numpy()
    ww = w["blocks"]["w"]
    _same(got, again["masks"]["blocks"]["w"])
    assert not np.array_equal(got, other["masks"]["blocks"]["w"].numpy())
    st = stats[ts.name]
    layers = zip(mask.reshape(-1, *mask.shape[-2:]), got.reshape(-1, *got.shape[-2:]),
                 ww.reshape(-1, *ww.shape[-2:]), st["n_pruned"].reshape(-1),
                 st["n_grown"].reshape(-1), st["nnz"].reshape(-1))
    for m, n, wl, pruned, grown, nnz in layers:
        n_prune = int(np.floor(DROP * np.float32(m.sum())))
        survive = JSal.prune_survivors(jnp.asarray(wl), jnp.asarray(m), jnp.int32(n_prune))
        _same(np.asarray(survive), n & m)                       # survivors exact
        assert not (n & ~m & np.asarray(survive)).any()
        assert int((n & ~m).sum()) == n_prune == int(grown) == int(pruned)
        assert int(nnz) == int(m.sum()) == int(n.sum())
    assert set(st) == {"n_pruned", "n_grown", "nnz"}
    assert bool(new["neuron_active"]["blocks"]["w"].all())
    with pytest.raises(ValueError, match="Generator"):
        TR.dst_update(*args)


def test_set_update_draws_from_the_generator_only():
    w, _, mask = _layer(9)
    spec = TRig.RigLSpec("l", *w.shape, density=0.2)
    torch.manual_seed(0)
    a, _ = TSet.set_update(spec, _t(w), torch.Generator().manual_seed(1),
                           TRig.RigLState(_t(mask)), DROP)
    torch.manual_seed(1)  # the global generator moves nothing
    b, _ = TSet.set_update(spec, _t(w), torch.Generator().manual_seed(1),
                           TRig.RigLState(_t(mask)), DROP)
    _same(a.mask, b.mask)


@pytest.mark.parametrize("method", ["rigl", "set"])
def test_init_sparsity_state_gives_target_nnz_per_layer(method):
    jcfg, tcfg = _cfgs(method)
    jreg, treg = JR.build_registry(jcfg), TR.build_registry(tcfg)
    jst = JR.init_sparsity_state(jcfg, jax.random.PRNGKey(0), jreg)
    tst = TR.init_sparsity_state(tcfg, torch.Generator().manual_seed(0), treg)
    again = TR.init_sparsity_state(tcfg, torch.Generator().manual_seed(0), treg)
    for js, ts in zip(jreg, treg):
        jm, tm = JR.get_path(jst["masks"], js.path), TR.get_path(tst["masks"], ts.path)
        assert ts.rigl_spec().target_nnz == js.rigl_spec().target_nnz
        per_layer = tm.reshape(tm.shape[0], -1).sum(-1)
        assert tm.shape == jm.shape and tm.dtype == torch.bool
        assert per_layer.tolist() == [ts.rigl_spec().target_nnz] * ts.lead[0]
        _same(np.asarray(jm).reshape(jm.shape[0], -1).sum(-1), per_layer)
        assert torch.equal(tm, TR.get_path(again["masks"], ts.path))
        assert bool(TR.get_path(tst["neuron_active"], ts.path).all())
    # the columns' fan-ins vary: these masks are not constant fan-in
    wg = TR.get_path(tst["masks"], ("blocks", "w_gate"))
    assert wg.sum(-2).min() < wg.sum(-2).max()


def _losses(lines):
    return [float(line.split(" loss ")[1].split()[0]) for line in lines
            if line.startswith("[trainer] step")]


def _fit_both(method: str, steps: int = 6):
    jcfg, tcfg = _cfgs(method)
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    t0 = TSt.state_to(tstate, "cpu")  # fit updates its state in place
    jdata = JP.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    tdata = TP.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    jlog, tlog = [], []
    jout = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, 6), log_every=1).fit(
        jstate, (jax.tree.map(jnp.asarray, b) for b in jdata.iterate()), steps,
        log_fn=jlog.append)
    trainer = TT.Trainer(cfg=tcfg, lr_fn=TSc.warmup_cosine(3e-3, 1, 6), log_every=1)
    tout = trainer.fit(tstate, tdata.iterate(), steps, log_fn=tlog.append)
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), atol=2e-4)
    return (jax.tree.map(np.asarray, jout)._asdict(), bridge.train_state_to_jax_numpy(tout),
            t0, tout, trainer)


def test_trainer_rigl_matches_the_reference_over_two_updates():
    jo, to, t0, tout, trainer = _fit_both("rigl")
    for key in ("masks", "neuron_active", "mask_versions"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{key}/{k}")
    for s in trainer.registry:
        new, old = TR.get_path(tout.masks, s.path), TR.get_path(t0.masks, s.path)
        assert int(tout.mask_versions[s.name]) == 2 and not torch.equal(new, old)
        assert new.reshape(s.lead[0], -1).sum(-1).tolist() == [s.rigl_spec().target_nnz] * 2


def test_trainer_set_versions_invariants_and_restore(tmp_path):
    jo, to, t0, tout, trainer = _fit_both("set")
    jf, tf = ({k: int(v) for k, v in bridge.flatten(o["mask_versions"]).items()}
              for o in (jo, to))
    assert jf == tf and set(tf.values()) == {2}
    for s in trainer.registry:
        new, old = TR.get_path(tout.masks, s.path), TR.get_path(t0.masks, s.path)
        assert not torch.equal(new, old)
        assert new.reshape(s.lead[0], -1).sum(-1).tolist() == [s.rigl_spec().target_nnz] * 2
        assert bool(TR.get_path(tout.neuron_active, s.path).all())
    # the same seed and step regrow the same masks; a restore at step 3
    # (after the first update) regrows at step 6 as the uninterrupted run did
    _, tcfg = _cfgs("set")
    data = TP.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    lr = TSc.warmup_cosine(3e-3, 1, 6)
    first = TT.Trainer(cfg=tcfg, lr_fn=lr, log_every=99).fit(
        TSt.state_to(t0, "cpu"), data.iterate(), 3, log_fn=lambda _: None)
    TCk.save(str(tmp_path), first)
    restored = TCk.restore(str(tmp_path), 3, TSt.state_to(t0, "cpu"))
    rest = TT.Trainer(cfg=tcfg, lr_fn=lr, log_every=99).fit(
        restored, data.iterate(3), 3, log_fn=lambda _: None)
    for s in trainer.registry:
        assert torch.equal(TR.get_path(rest.masks, s.path), TR.get_path(tout.masks, s.path))


def test_set_generator_depends_on_the_key_and_the_step():
    _, tcfg = _cfgs("set")
    st = TSt.init_train_state(tcfg, torch.Generator().manual_seed(0))
    draw = (lambda s: torch.rand(4, generator=TT.set_generator(s)))
    assert torch.equal(draw(st), draw(st))
    assert not torch.equal(draw(st), draw(st._replace(step=st.step + 1)))
    assert not torch.equal(draw(st), draw(st._replace(rng=st.rng + np.uint32(1))))


def test_itop_rates_equal_the_reference():
    jcfg, tcfg = _cfgs("rigl")
    jreg, treg = JR.build_registry(jcfg), TR.build_registry(tcfg)
    masks = [jax.tree.map(np.asarray, JR.init_sparsity_state(jcfg, jax.random.PRNGKey(i),
                                                             jreg)["masks"]) for i in range(3)]
    jitop = JR.init_itop(jreg, {"masks": jax.tree.map(jnp.asarray, masks[0])})
    titop = TR.init_itop(treg, {"masks": bridge.from_jax_numpy(masks[0])})
    assert TR.itop_rate(treg, titop) == JR.itop_rate(jreg, jitop)
    for m in masks[1:]:
        jitop = JR.update_itop(jitop, jax.tree.map(jnp.asarray, m))
        titop = TR.update_itop(titop, bridge.from_jax_numpy(m))
        jr, tr = JR.itop_rate(jreg, jitop), TR.itop_rate(treg, titop)
        assert tr == jr
    first = TR.itop_rate(treg, TR.init_itop(treg, {"masks": bridge.from_jax_numpy(masks[0])}))
    assert all(tr[k] > first[k] for k in tr)


@pytest.mark.parametrize("method", ["rigl", "set"])
def test_cli_trains_rigl_and_set_on_the_cpu(method, capsys):
    state = TL.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
                     "2", "--seq", "8", "--method", method])
    out = capsys.readouterr().out
    assert "[train] done at step 2" in out and int(state.step) == 2
    assert all(np.isfinite(v.numpy()).all() for v in bridge.flatten(state.params).values())
    wg = state.masks["blocks"]["w_gate"]
    assert wg.sum(-2).min() < wg.sum(-2).max()  # unstructured masks
