"""The port's SRigL topology update against the JAX reference.

Same numpy inputs into ``repro.core`` / ``repro.sparse.registry`` and their
counterparts in ``repro_torch``. Ranks, thresholds, normalized magnitudes,
masks, ``neuron_active`` and ``UpdateStats`` must be EXACTLY equal: the
update is integer counts, float32 compares and stable sorts, in the
reference's order. The drop fraction's cosine is the one place the two may
part, by one float32 ulp of the cosine (``DSTSchedule.drop_fraction``'s
docstring).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.core import saliency as JSal  # noqa: E402
from repro.core import schedule as JSch  # noqa: E402
from repro.core import srigl as JS  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import saliency as TSal  # noqa: E402
from repro_torch.core import schedule as TSch  # noqa: E402
from repro_torch.core import srigl as TS  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape and np.array_equal(a, b), (a, b)


def _with_ties(rng, shape):
    """float32 values with repeats, zeros of both signs and -inf."""
    x = rng.integers(-4, 5, size=shape).astype(np.float32) / 2
    x[rng.random(shape) < 0.1] = -0.0
    x[rng.random(shape) < 0.05] = -np.inf
    return x


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_descending_ranks_equal_the_reference_with_ties(axis):
    x = _with_ties(np.random.default_rng(0), (37, 23))
    _same(JSal.descending_ranks(jnp.asarray(x), axis=axis),
          TSal.descending_ranks(_t(x), axis=axis))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_threshold_and_selection_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((64, 48))).astype(np.float32)
    cand = rng.random(v.shape) < 0.4
    for k in (0, 1, 17, int(cand.sum()) // 2, int(cand.sum())):
        jt = JSal.topk_threshold(jnp.asarray(v), jnp.asarray(cand), jnp.int32(k))
        tt = TSal.topk_threshold(_t(v), _t(cand), torch.tensor(k, dtype=torch.int32))
        assert np.float32(jt) == tt.item()  # bitwise
        _same(JSal.select_topk_threshold(jnp.asarray(v), jnp.asarray(cand), jnp.int32(k)),
              TSal.select_topk_threshold(_t(v), _t(cand), torch.tensor(k)))


def test_normalized_equals_the_reference_bitwise():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 30)).astype(np.float32)
    where = rng.random(x.shape) < 0.3
    _same(JSal.normalized(jnp.asarray(x)), TSal.normalized(_t(x)))
    _same(JSal.normalized(jnp.asarray(x), jnp.asarray(where)), TSal.normalized(_t(x), _t(where)))


@pytest.mark.parametrize("total_steps", [8, 100, 4000, 100_000])
def test_dst_schedule_equals_the_reference(total_steps):
    kw = dict(delta_t=3, alpha=0.3, t_end_fraction=0.75, total_steps=total_steps)
    js, ts = JSch.DSTSchedule(**kw), TSch.DSTSchedule(**kw)
    assert js.t_end == ts.t_end
    steps = np.unique(np.linspace(0, total_steps + 5, 400).astype(int))
    for s in steps:
        assert bool(js.is_update_step(int(s))) == ts.is_update_step(int(s))
        a, b = np.float32(js.drop_fraction(int(s))), ts.drop_fraction(int(s))
        assert isinstance(b, np.float32)
        # the cosine is correctly rounded here and XLA's may be one ulp
        # (<= 2**-24 below 1) off; times 0.5 * alpha, plus the product's own
        # rounding, that stays below 2**-25 absolute
        assert abs(float(a) - float(b)) <= 2.0 ** -25, (s, a, b)
    for s in (0, 3, 6, 9):  # the steps the trainer tests update at
        assert np.float32(js.drop_fraction(s)) == ts.drop_fraction(s)


def _layer_inputs(seed, d_in=48, d_out=40, k=9, ablate_cols=0):
    """Weights, dense grads and a constant fan-in mask; the first
    ``ablate_cols`` columns get tiny weights and zero gradients, so SRigL
    ablates them."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    g = rng.standard_normal((d_in, d_out)).astype(np.float32)
    mask = np.zeros((d_in, d_out), bool)
    for c in range(d_out):
        mask[rng.choice(d_in, size=k, replace=False), c] = True
    w[:, :ablate_cols] *= 1e-4
    g[:, :ablate_cols] = 0.0
    return w, g, mask


@pytest.mark.parametrize("ablate_cols,drop", [(0, 0.3), (0, 0.05), (12, 0.5)])
def test_srigl_update_equals_the_reference_exactly(ablate_cols, drop):
    w, g, mask = _layer_inputs(4 + ablate_cols, ablate_cols=ablate_cols)
    d_in, d_out = w.shape
    kw = dict(name="l", d_in=d_in, d_out=d_out, density=9 / d_in, gamma_sal=0.3)
    active = np.ones(d_out, bool)
    jst, jstats = JS.srigl_update(JS.SRigLSpec(**kw), jnp.asarray(w), jnp.asarray(g),
                                  JS.LayerState(jnp.asarray(mask), jnp.asarray(active)),
                                  jnp.float32(drop))
    tst, tstats = TS.srigl_update(TS.SRigLSpec(**kw), _t(w), _t(g),
                                  TS.LayerState(_t(mask), _t(active)), np.float32(drop))
    _same(jst.mask, tst.mask)
    _same(jst.neuron_active, tst.neuron_active)
    for name in JS.UpdateStats._fields:
        _same(getattr(jstats, name), getattr(tstats, name))
    assert (int(tstats.n_ablated) > 0) == bool(ablate_cols)
    assert int(tstats.n_pruned) > 0 and int(tstats.n_grown) > 0
    nnz = tst.mask.sum(0)
    assert bool((nnz[tst.neuron_active] == tstats.fan_in).all())
    assert int(tst.mask.sum()) <= kw["d_out"] * 9


@pytest.mark.parametrize("ablate", [False, True])
def test_dst_update_over_the_smoke_stacks_equals_the_reference(ablate):
    """Every stacked smoke layer slab, one at a time in the port, with the
    SRigL drop fraction at step 3 of a 3-step delta_t schedule. With
    ``ablate`` the first 16 neurons of every layer get tiny weights and no
    gradient, so the update ablates them."""
    m = smoke_model()
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.array, m["jparams"])
    grads = {"blocks": {s.path[-1]: rng.standard_normal((*s.lead, s.d_in, s.d_out))
                        .astype(np.float32) for s in m["jreg"]}}
    if ablate:
        for s in m["jreg"]:
            params["blocks"][s.path[-1]][..., :16] *= 1e-4
            grads["blocks"][s.path[-1]][..., :16] = 0.0
    state = {"masks": jax.tree.map(np.asarray, m["jmasks"]),
             "neuron_active": {"blocks": {s.path[-1]: np.ones((*s.lead, s.d_out), bool)
                                          for s in m["jreg"]}}}
    jnew, jstats = JR.dst_update(
        jcfg, m["jreg"], jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state),
        JSch.DSTSchedule(delta_t=3, total_steps=8).drop_fraction(3), jax.random.PRNGKey(0))
    tnew, tstats = TR.dst_update(
        tcfg, m["treg"], bridge.from_jax_numpy(params), bridge.from_jax_numpy(grads),
        {k: bridge.from_jax_numpy(v) for k, v in state.items()},
        TSch.DSTSchedule(delta_t=3, total_steps=8).drop_fraction(3))
    for key in ("masks", "neuron_active"):
        jf, tf = bridge.flatten(jnew[key]), bridge.flatten(tnew[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            _same(jf[k], tf[k])
    assert jstats.keys() == tstats.keys()
    for name in jstats:
        for f, v in jstats[name].items():
            _same(v, tstats[name][f])
    n_ablated = sum(int(tstats[s.name]["n_ablated"].sum()) for s in m["treg"])
    assert (n_ablated > 0) == ablate
    summary = TR.sparsity_summary(m["treg"], tnew)
    for s in m["treg"]:
        assert summary[s.name]["density"] <= s.srigl_spec(tcfg).k0 / s.d_in + 1e-7


def test_dst_update_refuses_the_methods_not_ported():
    """SRigL, RigL and SET are ported; any other method is refused, as the
    reference refuses it (ValueError)."""
    m = smoke_model()
    cfg = m["tcfg"].replace(sparsity=dataclasses.replace(m["tcfg"].sparsity, method="gmp"))
    with pytest.raises(ValueError, match="gmp"):
        TR.dst_update(cfg, m["treg"], m["tparams"], {}, {}, np.float32(0.1))
    with pytest.raises(ValueError, match="gmp"):
        TR.init_sparsity_state(cfg, torch.Generator(), m["treg"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mask_for_forward_gives_the_references_signed_zeros(dtype):
    """An unmasked -0.0 comes out +0, as the reference's straight-through
    form gives; a masked -0.0 too. Values, sign bits and the dense gradient
    equal the reference's."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.5
    mask[0, :2] = True
    mask[1, :2] = False
    w[0, :2] = -0.0  # kept
    w[1, :2] = -0.0  # dropped
    g = rng.standard_normal((6, 5)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jw = jnp.asarray(w).astype(jdt)
    want, vjp = jax.vjp(lambda w_: JS.apply_mask_for_forward(w_, jnp.asarray(mask)), jw)
    (want_grad,) = vjp(jnp.asarray(g).astype(jdt))
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    got = TS.apply_mask_for_forward(tw, torch.from_numpy(mask))
    got.backward(torch.from_numpy(g).to(tdt))
    want_f32 = np.asarray(want.astype(jnp.float32))
    got_f32 = got.detach().float().numpy()
    np.testing.assert_array_equal(got_f32, want_f32)
    np.testing.assert_array_equal(np.signbit(got_f32), np.signbit(want_f32))
    assert not np.signbit(got_f32[:2, :2]).any()
    np.testing.assert_array_equal(tw.grad.float().numpy(),
                                  np.asarray(want_grad.astype(jnp.float32)))
