"""The hybrid family's sparse plumbing against the JAX reference on the CPU,
at zamba2-7b's smoke config (``tests/test_torch_hybrid.py`` has its
layout): the shared attention + MLP block's stacks have no leading axis
(lead ``()``), beside the Mamba2 stacks of lead (g, r) and (rem,).

Held here: every format's export of every stack against the reference's
(integers exactly, floats within 1e-6), the shared leaves' apply and their
``donate_refresh`` written in place (``formats._write_layers`` treats a
lead-() leaf as one layer); ``Plan.refresh`` of the shared stack with the
reference's stacks, counts and prices (one replica, as the reference prices
it); ``tune_registry``'s keys over every stack equal to the reference's;
four ``Trainer`` steps with an SRigL update after steps 2 and 4 against the
reference's; both CLIs at ``--smoke --device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JDP  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.sparse import autotune as JAT  # noqa: E402
from repro.sparse import condensed as JCond  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TDP  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402
from repro_torch.sparse import condensed as TCond  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from _torch_autotune_stubs import _stub_reference_search, caches  # noqa: E402,F401
from _torch_zoo_model import TOL, _model, rewired_generation, to_port  # noqa: E402

ARCH = "zamba2-7b"
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})


# ---------------------------------------------------------------------------
# formats and Plan.refresh on the shared block's leaves (no leading axis)
# ---------------------------------------------------------------------------

def _ablated(m, frac: float = 0.25) -> tuple[dict, dict]:
    """The masks with the last ``frac`` of each stack's output neurons cut,
    as the reference's and the port's trees."""
    out = {}
    for s in m["jreg"]:
        cut = s.d_out - max(1, int(s.d_out * frac))
        JR.set_path(out, s.path, JR.get_path(m["jmasks"], s.path)
                    & (jnp.arange(s.d_out) < cut)[None, :])
    return out, to_port(out)


@pytest.mark.parametrize("path,values_dtype", [
    ("condensed", "int8"), ("condensed_over_active", None), ("condensed_over_active", "int8"),
    ("structured", None), ("structured", "int8")])
def test_every_format_on_the_shared_leaves_equals_the_reference(path, values_dtype):
    """Each format's export of every stack (the shared block's with no
    leading axis) equals the reference's (integers exactly, floats within
    1e-6), applies as the reference's does, and refreshes its values in
    place (``donate_refresh``: same storage, equal to a fresh export)."""
    m = _model(ARCH, ())
    jmasks, tmasks = _ablated(m)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], jmasks, batch_size=4, path=path,
                          values_dtype=values_dtype)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], tmasks, batch_size=4, path=path,
                          values_dtype=values_dtype, profile=PROFILE)
    x = np.random.default_rng(3).standard_normal((3, m["tcfg"].d_ff)).astype(np.float32)
    params2 = {k: v * 1.01 for k, v in bridge.flatten(m["tparams"]).items()}
    params2 = bridge.unflatten(params2)
    fresh = TP.build_plan(m["tcfg"], m["treg"], params2, tmasks, batch_size=4, path=path,
                          values_dtype=values_dtype, profile=PROFILE)
    for s in m["treg"]:
        jleaf, tleaf = JR.get_path(jplan.serving_tree, s.path), TR.get_path(tplan.serving_tree,
                                                                           s.path)
        assert type(tleaf).format_name == type(jleaf).format_name == path
        assert tleaf.spec().n_replicas == s.n_replicas
        for f, arr in tleaf.arrays().items():
            want = np.asarray(getattr(jleaf, f))
            assert tuple(arr.shape[:len(s.lead)]) == s.lead, (s.name, f)
            if arr.dtype.is_floating_point:
                np.testing.assert_allclose(arr.float().numpy(), want.astype(np.float32),
                                           rtol=1e-6, atol=1e-7, err_msg=f"{s.name}/{f}")
            else:
                np.testing.assert_array_equal(arr.numpy(), want, err_msg=f"{s.name}/{f}")
        if s.lead:
            continue
        w = TR.get_path(m["tparams"], s.path)
        xs = x[:, :s.d_in]
        want = np.asarray(jleaf.apply(jnp.asarray(xs), JR.get_path(m["jparams"], s.path)))
        got = tleaf.apply(torch.from_numpy(xs), w)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # a lead-() leaf is one layer: its refresh writes that layer in place
        ptrs = {f: t.data_ptr() for f, t in tleaf.arrays().items()}
        done = tleaf.donate_refresh(TR.get_path(params2, s.path), TR.get_path(tmasks, s.path))
        assert {f: t.data_ptr() for f, t in done.arrays().items()} == ptrs
        for f, t in TR.get_path(fresh.serving_tree, s.path).arrays().items():
            assert torch.equal(getattr(done, f), t), (s.name, f)


def test_write_layers_on_no_leading_axis_is_one_layer_in_place():
    t = torch.arange(12.0).reshape(3, 4)
    flat = TF._flat_lead(t, t.ndim)
    assert flat.shape == (1, 3, 4) and flat.data_ptr() == t.data_ptr()
    out = TF._write_layers({"v": t}, lambda a: {"v": a * 2}, 0, t.clone())
    assert out["v"] is t and torch.equal(t, torch.arange(12.0).reshape(3, 4) * 2)


@pytest.mark.parametrize("values_dtype", [None, "int8"])
def test_plan_refresh_of_the_shared_stack_equals_the_reference(values_dtype):
    """A rewire of ``shared_attn/w_down`` (lead ()): the reference's refreshed
    stacks and counts, every leaf equal to the reference's and to a fresh
    export, every tensor written in place; the shared stacks priced at one
    replica, as the reference prices them."""
    m = _model(ARCH, ())
    name = "shared_attn/w_down"
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    jplan = JP.build_plan(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"], batch_size=1,
                          path="condensed", mask_versions=dict(versions),
                          values_dtype=values_dtype)
    tplan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], m["tmasks"], batch_size=1,
                          path="condensed", mask_versions=dict(versions), profile=PROFILE,
                          values_dtype=values_dtype)
    ptrs = {s.name: {f: t.data_ptr() for f, t in TR.get_path(tplan.serving_tree, s.path)
                     .arrays().items()} for s in m["treg"]}
    assert tplan.refresh(to_port(params2), to_port(masks2), versions2) == \
        jplan.refresh(params2, masks2, versions2, donate=False) == [name]
    assert (tplan.export_calls, tplan.value_refreshes) == (jplan.export_calls,
                                                           jplan.value_refreshes)
    fresh = TP.build_plan(m["tcfg"], m["treg"], to_port(params2), to_port(masks2), batch_size=1,
                          path="condensed", mask_versions=dict(versions2), profile=PROFILE,
                          values_dtype=values_dtype)
    for s in m["treg"]:
        leaf, jleaf = TR.get_path(tplan.serving_tree, s.path), JR.get_path(jplan.serving_tree,
                                                                          s.path)
        for f, t in leaf.arrays().items():
            want = np.asarray(getattr(jleaf, f))
            if t.dtype.is_floating_point:
                np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(t.numpy(), want)
            assert torch.equal(t, getattr(TR.get_path(fresh.serving_tree, s.path), f))
        # priced as the reference prices it: the shared stacks at one
        # replica, though each runs once per group
        assert tplan.decisions[s.name].est_s == pytest.approx(jplan.decisions[s.name].est_s,
                                                              rel=1e-12)
        assert leaf.spec().n_replicas == s.n_replicas == (1 if not s.lead else s.n_replicas)
    assert {s.name: {f: t.data_ptr() for f, t in TR.get_path(tplan.serving_tree, s.path)
                     .arrays().items()} for s in m["treg"]} == ptrs


# ---------------------------------------------------------------------------
# the launch search, the trainer, the CLIs
# ---------------------------------------------------------------------------

def test_tune_registry_keys_over_every_stack_equal_the_reference(caches, monkeypatch):
    """One search per launch shape of every stack, the shared block's
    included: the reference's keys (its timed searches stubbed), at bucket
    8 in float32."""
    _stub_reference_search(monkeypatch)
    m = _model(ARCH, ())
    jout = JAT.tune_registry(m["jreg"], JCond.export_stats(m["jreg"], m["jmasks"]), batch=8,
                             dtype=jnp.float32, reps=1)
    tout = AT.tune_registry(m["treg"], TCond.export_stats(m["treg"], m["tmasks"]), batch=8,
                            dtype=torch.float32, reps=1, device="cpu", cfg=m["tcfg"])
    assert set(tout) == set(jout)
    assert {s.split("/")[0] for s in tout} == {"m_groups", "shared_attn"}
    keys = set(json.loads(caches[0].read_text())["kernels"])
    assert keys == set(json.loads(caches[1].read_text())["kernels"])
    assert keys == {r.key for r in tout.values()}


def test_slab_engine_autotune_equals_the_reference_engine(caches, monkeypatch):
    _stub_reference_search(monkeypatch)
    m = _model(ARCH, ())
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path="condensed")
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path="condensed")
    tuned = teng.autotune(8, reps=1)
    assert not teng.paged and set(tuned) == set(jeng.autotune(8))
    assert {r.key for r in tuned.values()} == set(json.loads(caches[0].read_text())["kernels"])
    assert set(json.loads(caches[0].read_text())["kernels"]) == set(
        json.loads(caches[1].read_text())["kernels"])


def _losses(lines):
    return [float(line.split(" loss ")[1].split()[0]) for line in lines
            if line.startswith("[trainer] step")]


def test_trainer_matches_the_reference_over_four_steps_with_two_srigl_updates():
    """Masked-dense steps with the straight-through mask, an SRigL update
    after steps 2 and 4 over the (g, r), (rem,) and () stacks: losses within
    2e-4 (as ``tests/test_torch_train.py`` holds the dense family), masks,
    ``neuron_active`` and versions exactly, params and optimizer state
    within rtol = atol = 1e-5."""
    jcfg, tcfg = (c.replace(sparsity=dataclasses.replace(c.sparsity, delta_t=2))
                  for c in (JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)))
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    data = dict(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=2, seed=0, family="hybrid")
    jlog, tlog = [], []
    jout = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, 4), log_every=1).fit(
        jstate, (jax.tree.map(jnp.asarray, b) for b in JDP.SyntheticLM(**data).iterate()), 4,
        log_fn=jlog.append)
    trainer = TT.Trainer(cfg=tcfg, lr_fn=TSc.warmup_cosine(3e-3, 1, 4), log_every=1)
    tout = trainer.fit(tstate, TDP.SyntheticLM(**data).iterate(), 4, log_fn=tlog.append)
    assert int(tout.step) == 4 and len(_losses(tlog)) == 4
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), atol=2e-4)
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
    for s in trainer.registry:  # the topology moved on every stack kind
        assert not torch.equal(TR.get_path(tout.masks, s.path), TR.get_path(tstate.masks, s.path))


def test_the_clis_serve_and_train_zamba2(capsys):
    from repro_torch.launch import serve as TSv
    from repro_torch.launch import train as TTr
    first = {}
    for path in ("condensed", "masked"):
        TSv.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--path", path,
                  "--batch", "2", "--prompt-len", "18", "--gen", "6"])
        out = capsys.readouterr().out
        first[path] = next(line for line in out.splitlines() if "first stream" in line)
    assert first["condensed"] == first["masked"]
    TTr.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2"])
    assert "[train] done at step 2" in capsys.readouterr().out
