"""The rest of the port's ``core/``, ``optim/``, ``train/`` and ``data/``
pieces against the reference, and a RigL-trained state served, on the CPU.

* ``grad_compress``: bf16 compression and its error bitwise equal to the
  reference's; int8 codes bitwise, scales within one float32 ulp, the
  error feedback keeping the cumulative sum within one quantization step.
* ``make_train_batch``: its invariants (the reference draws from
  ``jax.random``, which torch cannot reproduce).
* ``largest_feasible_mesh``, ``check_nm`` and ``column_nnz`` equal to the
  reference's; the N:M and unstructured masks keep their counts.
* ``elastic.remesh`` through the port's checkpoints; ``device_health``
  reports no device without a card.
* A state the reference's Trainer trained with RigL (two updates) serves
  through the port's ``generate`` and ``ServingEngine`` on masked,
  condensed (K1 at the realized max fan-in), condensed_over_active and
  auto with tokens EXACTLY the reference's on the same masks and params.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.core import topology as JTop  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import serve as JServe  # noqa: E402
from repro.optim import grad_compress as JGC  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import elastic as JEl  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.core import distributions as TDist  # noqa: E402
from repro_torch.core import topology as TTop  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TServe  # noqa: E402
from repro_torch.optim import grad_compress as TGC  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TPlan  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCk  # noqa: E402
from repro_torch.train import elastic as TEl  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

ARCH = "qwen3-1.7b"


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32)},
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def test_bf16_compression_equals_the_reference_bitwise():
    g = _grads(0)
    jef = JGC.init_error_feedback(jax.tree.map(jnp.asarray, g))
    tef = TGC.init_error_feedback(bridge.from_jax_numpy(g))
    assert TR.get_path(tef, ("a", "w")).dtype == torch.bfloat16
    for step in range(3):
        gi = _grads(step + 1)
        jc, jef = JGC.compress_bf16(jax.tree.map(jnp.asarray, gi), jef)
        tc, tef = TGC.compress_bf16(bridge.from_jax_numpy(gi), tef)
        for j, t in ((jc, tc), (jef, tef)):
            jf, tf = bridge.flatten(j), bridge.flatten(t)
            for k in jf:
                assert tf[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(_np(tf[k]), np.asarray(jf[k], np.float32))


@pytest.mark.parametrize("scale", [1.0, 1e-14, 0.0])
def test_int8_compression_equals_the_reference(scale):
    g = _grads(3, scale)
    jef = JGC.init_error_feedback(jax.tree.map(jnp.asarray, g))
    tef = TGC.init_error_feedback(bridge.from_jax_numpy(g))
    total_true = total_deq = 0.0
    for step in range(4):
        gi = _grads(step + 10, scale)
        jc, jef = JGC.compress_int8(jax.tree.map(jnp.asarray, gi), jef)
        tc, tef = TGC.compress_int8(bridge.from_jax_numpy(gi), tef)
        for path in (("a", "w"), ("b",)):
            (jq, js), (tq, ts) = TR.get_path(jc, path), TR.get_path(tc, path)
            assert tq.dtype == torch.int8 and ts.shape == ()
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
            np.testing.assert_array_equal(_np(TR.get_path(tef, path)),
                                          np.asarray(TR.get_path(jef, path), np.float32))
        deq = TGC.decompress_int8(tc)
        jdeq = JGC.decompress_int8(jc)
        np.testing.assert_allclose(deq["a"]["w"].numpy(), np.asarray(jdeq["a"]["w"]),
                                   rtol=1e-6, atol=0)
        total_true = total_true + gi["a"]["w"]
        total_deq = total_deq + deq["a"]["w"].numpy()
    step_size = float(TR.get_path(tc, ("a", "w"))[1])
    assert np.abs(total_true - total_deq).max() <= step_size + 1e-30


def test_make_train_batch_invariants():
    cfg = TCfg.get_smoke_config(ARCH)
    b = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 3, 11)
    again = TD.make_train_batch(cfg, torch.Generator().manual_seed(0), 3, 11)
    other = TD.make_train_batch(cfg, torch.Generator().manual_seed(1), 3, 11)
    assert set(b) == {"tokens", "targets"}
    for k, v in b.items():
        assert v.shape == (3, 11) and v.dtype == torch.int32 and v.device.type == "cpu"
        assert int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size
        assert torch.equal(v, again[k])
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert not torch.equal(b["tokens"], other["tokens"])
    jb = JD.make_train_batch(JCfg.get_smoke_config(ARCH), jax.random.PRNGKey(0), 3, 11)
    assert {k: (v.shape, str(v.dtype)) for k, v in jb.items()} == {
        k: (tuple(v.shape), "int32") for k, v in b.items()}
    # the audio family's batches (ported since item 8 step 7): (B, K, T)
    audio = cfg.replace(family="audio", n_codebooks=3)
    ab = TD.make_train_batch(audio, torch.Generator().manual_seed(0), 2, 4)
    jab = JD.make_train_batch(JCfg.get_smoke_config(ARCH).replace(family="audio",
                                                                  n_codebooks=3),
                              jax.random.PRNGKey(0), 2, 4)
    assert {k: (tuple(v.shape), "int32") for k, v in ab.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jab.items()}
    assert torch.equal(ab["tokens"][..., 1:], ab["targets"][..., :-1])


def test_largest_feasible_mesh_equals_the_reference():
    for n in (1, 2, 3, 4, 7, 8, 16, 255, 512):
        for mp in (1, 2, 4, 8):
            assert TEl.largest_feasible_mesh(n, mp) == JEl.largest_feasible_mesh(n, mp)


@pytest.mark.parametrize("n,m,seed", [(1, 4, 0), (2, 4, 1), (2, 8, 2), (4, 16, 3), (3, 8, 4)])
def test_nm_masks_and_check_nm_equal_the_reference(n, m, seed):
    g = torch.Generator().manual_seed(seed)
    mask = TTop.random_nm_mask(g, 32, 12, n, m)
    assert TTop.check_nm(mask, n, m) and JTop.check_nm(mask.numpy(), n, m)
    stacked = TTop.random_nm_mask(g, 32, 12, n, m, lead=(2,))
    assert stacked.shape == (2, 32, 12) and TTop.check_nm(stacked, n, m)
    rng = np.random.default_rng(seed)
    for _ in range(4):  # arbitrary masks, mostly not N:M
        arb = rng.random((32, 12)) < rng.random()
        assert TTop.check_nm(torch.from_numpy(arb), n, m) == JTop.check_nm(arb, n, m)
    broken = mask.clone()
    broken[0, 0] = ~broken[0, 0]
    assert not TTop.check_nm(broken, n, m) and not JTop.check_nm(broken.numpy(), n, m)
    # N:M with M = d_in is constant fan-in (the paper's relation)
    assert TTop.check_constant_fan_in(TTop.random_nm_mask(g, 32, 12, 4, 32), 4)
    with pytest.raises(ValueError):
        TTop.random_nm_mask(g, 30, 12, n, m)


def test_unstructured_masks_and_column_nnz():
    g = torch.Generator().manual_seed(0)
    m = TTop.random_unstructured_mask(g, 32, 16, 100, lead=(3,))
    assert m.shape == (3, 32, 16) and m.reshape(3, -1).sum(-1).tolist() == [100] * 3
    assert TTop.random_unstructured_mask(g, 8, 4, 0).sum() == 0
    assert bool(TTop.random_unstructured_mask(g, 8, 4, 32).all())
    with pytest.raises(ValueError):
        TTop.random_unstructured_mask(g, 8, 4, 33)
    nnz = TTop.column_nnz(m)
    assert nnz.dtype == torch.int32 and nnz.shape == (3, 16)
    for layer, got in zip(m, nnz):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JTop.column_nnz(jnp.asarray(layer.numpy()))))


def test_remesh_restores_through_the_ports_checkpoints(tmp_path):
    cfg = TCfg.get_smoke_config(ARCH)
    state = TSt.init_train_state(cfg, torch.Generator().manual_seed(2))
    state = state._replace(step=state.step + 5)
    TCk.save(str(tmp_path), state)
    got = TEl.remesh(None, str(tmp_path), 5, lambda: TSt.init_train_state(
        cfg, torch.Generator().manual_seed(9)))
    assert int(got.step) == 5
    for key in ("params", "masks"):
        want, have = bridge.flatten(getattr(state, key)), bridge.flatten(getattr(got, key))
        assert want.keys() == have.keys()
        assert all(torch.equal(want[k], have[k]) for k in want)


def test_device_health_reports_no_device_without_a_card():
    if torch.cuda.is_available():
        assert set(TEl.device_health()) == {f"cuda:{i}"
                                            for i in range(torch.cuda.device_count())}
    else:
        assert TEl.device_health() == {}
    with pytest.raises(ValueError, match="cpu"):
        TEl.device_health(["cpu"])


# ---------------------------------------------------------------------------
# a RigL-trained state served
# ---------------------------------------------------------------------------

STEPS, DELTA_T = 4, 2
REQUESTS = ((2, 8, 8, 5), (3, 6, 6, 6))  # (batch, prompt, gen, seed): one group


def _prompts(b, t, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def rigl_trained():
    """The reference's smoke qwen3 trained with RigL through two updates,
    bridged into the port, and the reference's tokens: its ``generate`` on
    masked and condensed, and its engine on condensed."""
    base = JCfg.get_smoke_config(ARCH)
    jcfg = base.replace(sparsity=dataclasses.replace(base.sparsity, method="rigl",
                                                     delta_t=DELTA_T))
    init = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    data = JD.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    state = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, STEPS),
                       log_every=STEPS).fit(
        init, (jax.tree.map(jnp.asarray, b) for b in data.iterate()), STEPS,
        log_fn=lambda _: None)
    jreg = JR.build_registry(jcfg)
    prompts = _prompts(4, 8, 3, jcfg.vocab_size)
    gen = {path: np.asarray(JE.generate(
        jcfg, state.params,
        JServe.build_serving_masks(jcfg, jreg, state.params, state.masks, path, batch_size=4),
        jnp.asarray(prompts), 6)) for path in ("masked", "condensed")}
    eng = JE.ServingEngine(jcfg, state.params, state.masks, jreg, path="condensed")
    ids = [eng.submit(jnp.asarray(_prompts(b, t, s, jcfg.vocab_size)), g)
           for b, t, g, s in REQUESTS]
    eng.step()
    engine_tokens = [np.asarray(eng.retire(i)[0].tokens) for i in ids]
    tcfg = TCfg.get_smoke_config(ARCH)
    tcfg = tcfg.replace(sparsity=dataclasses.replace(tcfg.sparsity, method="rigl"))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, state))
    return dict(tcfg=tcfg, treg=TR.build_registry(tcfg), state=tstate, prompts=prompts,
                gen=gen, engine_tokens=engine_tokens,
                versions={k: int(v) for k, v in state.mask_versions.items()})


def test_rigl_state_condenses_at_its_realized_max_fan_in(rigl_trained):
    r = rigl_trained
    assert set(r["versions"].values()) == {STEPS // DELTA_T}
    tree = TC.export_condensed(r["tcfg"], r["treg"], r["state"].params, r["state"].masks)
    stats = TC.export_stats(r["treg"], r["state"].masks)
    for s in r["treg"]:
        mask = TR.get_path(r["state"].masks, s.path)
        fan = TTop.column_nnz(mask)
        leaf = TR.get_path(tree, s.path)
        assert leaf.values.shape[-1] == stats[s.name].k == int(fan.max())
        assert int(fan.min()) < int(fan.max())  # ragged columns, padded to k
        assert int(fan.max()) > TDist.fan_in_from_density(s.d_in, s.density)
        # no mask is ablation-only, so auto never offers structured
        assert stats[s.name].min_fan_in < s.d_in
        dec = TPlan.select_representation(s, batch_size=8, itemsize=4, stats=stats[s.name])
        assert dec.representation != "structured"
        dense = TTop.condensed_to_dense(leaf.values, leaf.indices, s.d_in)
        torch.testing.assert_close(dense, TR.get_path(r["state"].params, s.path) * mask,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("path", ["masked", "condensed", "condensed_over_active", "auto"])
def test_rigl_state_generates_the_references_tokens(rigl_trained, path):
    r = rigl_trained
    tree = TServe.build_serving_masks(r["tcfg"], r["treg"], r["state"].params,
                                      r["state"].masks, path, batch_size=4)
    if path != "masked":
        want_cls = {"condensed": TF.Condensed,
                    "condensed_over_active": TF.CondensedOverActive}.get(path)
        leaves = [TR.get_path(tree, s.path) for s in r["treg"]]
        assert want_cls is None or all(isinstance(leaf, want_cls) for leaf in leaves)
    got = TE.generate(r["tcfg"], r["state"].params, tree, torch.from_numpy(r["prompts"]), 6)
    want = r["gen"]["condensed" if path != "masked" else "masked"]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), r["gen"]["masked"])


@pytest.mark.parametrize("path", ["masked", "condensed", "condensed_over_active", "auto"])
def test_rigl_state_serves_the_reference_engines_tokens(rigl_trained, path):
    r = rigl_trained
    eng = TE.ServingEngine(r["tcfg"], r["state"].params, r["state"].masks, r["treg"],
                           path=path)
    ids = [eng.submit(_prompts(b, t, s, r["tcfg"].vocab_size), g) for b, t, g, s in REQUESTS]
    eng.step()
    for rid, want in zip(ids, r["engine_tokens"]):
        [res] = eng.retire(rid)
        np.testing.assert_array_equal(res.tokens.numpy(), want)
