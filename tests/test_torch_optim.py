"""The port's optimizers and learning-rate schedules against the JAX reference.

Same numpy params, gradients and masks into ``repro.optim`` and
``repro_torch.optim`` for three updates. Params and moments agree within
rtol 2e-6 (float32: the same operations in the same order; XLA may fuse a
multiply-add or take a power another way, a few ulps). Moments at masked
positions must be EXACTLY zero on both sides.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402

TOL = dict(rtol=2e-6, atol=1e-7)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": rng.standard_normal((2, 6, 5)).astype(np.float32),
                         "ln": rng.standard_normal((2, 5)).astype(np.float32)},
              "embed": rng.standard_normal((7, 5)).astype(np.float32)}
    masks = {"blocks": {"w": rng.random((2, 6, 5)) < 0.4}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(3)]
    return params, masks, grads


def _close(j, t):
    jf, tf = bridge.flatten(jax.tree.map(np.asarray, j)), bridge.flatten(t)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_allclose(np.asarray(tf[k]), jf[k], **TOL, err_msg=k)


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.0}),
                                     ("sgdm", {}), ("sgdm", {"weight_decay": 1e-2}),
                                     ("adafactor", {}), ("adafactor", {"weight_decay": 1e-2})])
def test_optimizer_matches_the_reference_and_zeroes_masked_moments(name, kw):
    params, masks, grads = _inputs(0)
    j_init, j_upd = JO.make_optimizer(name, **kw)
    t_init, t_upd = TO.make_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.from_jax_numpy(params)
    jm, tm = jax.tree.map(jnp.asarray, masks), bridge.from_jax_numpy(masks)
    js, ts = j_init(jp), t_init(tp)
    for step, g in enumerate(grads):
        lr = np.float32(1e-2 * (step + 1))
        jp, js = j_upd(jp, jax.tree.map(jnp.asarray, g), js, jnp.float32(lr), masks=jm)
        tp, ts = t_upd(tp, bridge.from_jax_numpy(g), ts, lr, masks=tm)
    _close(jp, tp)
    _close(js, ts)
    for moment in ("mu", "nu"):
        if moment in ts:
            m = tm["blocks"]["w"]
            t_mom = ts[moment]["blocks"]["w"]
            assert bool((t_mom[~m] == 0).all())
            assert not np.asarray(js[moment]["blocks"]["w"])[~np.asarray(m)].any()
            assert bool((t_mom[m] != 0).any())


def test_adamw_updates_in_place():
    params, masks, grads = _inputs(1)
    init, upd = TO.adamw()
    tp = bridge.from_jax_numpy(params)
    w = tp["blocks"]["w"]
    state = init(tp)
    new_p, new_s = upd(tp, bridge.from_jax_numpy(grads[0]), state, np.float32(1e-2))
    assert new_p["blocks"]["w"] is w and new_s["mu"]["blocks"]["w"] is state["mu"]["blocks"]["w"]
    assert int(new_s["count"]) == 1


@pytest.mark.parametrize("warmup,total,min_lr", [(1, 6, 0.0), (5, 200, 0.0), (10, 1000, 1e-5)])
def test_warmup_cosine_matches_the_reference(warmup, total, min_lr):
    jf, tf = JSc.warmup_cosine(3e-3, warmup, total, min_lr), TSc.warmup_cosine(3e-3, warmup,
                                                                                total, min_lr)
    for s in range(total + 3):
        a, b = np.float32(jf(s)), tf(s)
        assert isinstance(b, np.float32)
        # equal but for the cosine, which may be one float32 ulp off
        assert abs(float(a) - float(b)) <= 3e-3 * 2.0 ** -23, (s, a, b)


def test_warmup_step_matches_the_reference():
    jf, tf = JSc.warmup_step(0.1, 5, (30, 70, 90)), TSc.warmup_step(0.1, 5, (30, 70, 90))
    for s in range(100):
        assert np.float32(jf(s)) == tf(s), s
