"""The structured linear's backward against the reference's custom VJP, on
the CPU.

``ops.structured_linear`` is a ``torch.autograd.Function`` whose forward is
K5 (its plain version here) and whose backward is the reference's
``_structured_bwd``: dx and dw within 1e-5 of ``jax.vjp`` through
``repro.kernels.ops.structured_linear`` in float32, padding entries of
``active_index`` dropped and ablated columns' dw exactly 0. Through
``StructuredFanIn.apply``, ``loss_fn`` over a structured serving tree on
ablation-only masks gives, at the surviving columns, the masked path's
dense gradient, and exact zeros at the ablated ones.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.structured_matmul import padded_active_count  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_smoke_model import smoke_masks, smoke_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, b, d_in, d_out, n_ablated):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d_in)).astype(np.float32)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    dy = rng.standard_normal((b, d_out)).astype(np.float32)
    active = np.ones(d_out, bool)
    active[rng.choice(d_out, size=n_ablated, replace=False)] = False
    a_pad = padded_active_count(int(active.sum()), d_out)
    ai = TF.active_index_from_bools(torch.from_numpy(active), a_pad).numpy()
    return x, w, dy, active, ai


@pytest.mark.parametrize("b,d_in,d_out,n_ablated", [
    (5, 24, 40, 10),      # padding entries past the active count
    (3, 16, 130, 0),      # nothing ablated, a_pad 256 > d_out
    (7, 32, 48, 47),      # all but one ablated
    (4, 20, 256, 100),    # a_pad at the 128-lane tile
])
def test_structured_linear_vjp_equals_the_reference(b, d_in, d_out, n_ablated):
    x, w, dy, active, ai = _case(b + d_out, b, d_in, d_out, n_ablated)
    y_j, vjp = jax.vjp(lambda x_, w_: JO.structured_linear(x_, w_, jnp.asarray(ai)),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = TO.structured_linear(tx, tw, torch.from_numpy(ai))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), **TOL)
    assert tx.grad.dtype == tw.grad.dtype == torch.float32
    assert not tw.grad[:, ~torch.from_numpy(active)].any()  # exact zeros, ablated
    # both gradients of the plain formula, structured_dense, at the survivors
    xd = torch.from_numpy(x).requires_grad_()
    wd = torch.from_numpy(w).requires_grad_()
    TO.structured_dense(xd, wd, torch.from_numpy(active)).backward(torch.from_numpy(dy))
    torch.testing.assert_close(tx.grad, xd.grad, **TOL)
    torch.testing.assert_close(tw.grad, wd.grad, **TOL)


def test_structured_linear_nd_is_differentiable_and_skips_the_graph_when_it_can():
    x, w, dy, active, ai = _case(0, 6, 16, 40, 12)
    x3 = torch.from_numpy(x).reshape(2, 3, 16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = TO.structured_linear_nd(x3, tw, torch.from_numpy(ai))
    assert y.shape == (2, 3, 40) and y.grad_fn is not None
    y.backward(torch.from_numpy(dy).reshape(2, 3, 40))
    y_j, vjp = jax.vjp(lambda x_, w_: JO.structured_linear_nd(x_, w_, jnp.asarray(ai)),
                       jnp.asarray(x).reshape(2, 3, 16), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy).reshape(2, 3, 40))
    np.testing.assert_allclose(x3.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), **TOL)
    with torch.no_grad():  # serving: no graph recorded
        assert TO.structured_linear_nd(x3, tw, torch.from_numpy(ai)).grad_fn is None


def test_loss_over_a_structured_tree_backpropagates_into_the_weights():
    """``loss_fn`` through ``StructuredFanIn.apply`` (K5 forward, the new
    backward) on the smoke model's ablation-only masks: the params gradient
    at each sparse stack equals the masked loss's at the surviving columns
    and is exactly 0 at the ablated ones; every other leaf's gradient
    equals the masked loss's."""
    m = smoke_model()
    cfg, reg = m["tcfg"], m["treg"]
    masks = bridge.from_jax_numpy(jax.tree.map(np.asarray, smoke_masks()["ablation_only"]))
    tree = TC.export_structured(cfg, reg, masks)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    grads = []
    for serving in (tree, masks):
        params = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jparams"]))
        leaves = bridge.flatten(params)
        for v in leaves.values():
            v.requires_grad_()
        loss = TM.loss_fn(cfg, params, serving, batch)[0]
        loss.backward()
        grads.append((loss.item(), {k: v.grad for k, v in leaves.items()}))
    (ls, gs), (lm, gm) = grads
    np.testing.assert_allclose(ls, lm, rtol=1e-6)
    sparse = {"/".join(s.path): s for s in reg}
    for k, g in gs.items():
        if k in sparse:
            active = TR.get_path(masks, sparse[k].path).any(dim=-2)       # (L, d_out)
            cols = active[:, None, :].expand_as(g)
            torch.testing.assert_close(g[cols], gm[k][cols], rtol=1e-5, atol=1e-6)
            assert not g[~cols].any()
            assert bool((~active).any())
        else:
            torch.testing.assert_close(g, gm[k], rtol=1e-5, atol=1e-6, msg=k)
