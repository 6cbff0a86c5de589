"""The SSM family (mamba2-130m) against the JAX reference on the CPU, module
by module and as a model, at smoke dims.

``models/ssm.py``: ``_causal_conv`` with and without a carried state,
``ssd_chunked`` with T not a multiple of the chunk and with a carried
``h0``, ``ssd_decode_step`` and ``ssm_block`` with masks (prefill, then a
decode step from its state), on inputs made from a seed with numpy. The
model: configs and registry (densities and fan-ins exactly, the
``"ssm_out"`` fan-in quirk of ``init_ssm_params``), the parameter layout
(``a_log``, ``d_skip``, ``dt_bias`` float32 in a bf16 model, bridged as
they are), the loss and its gradients, one SRigL update over the three
stacks, prefill + decode against the reference and against the
teacher-forced forward (the reference's own contract, relative 1e-4).

Tolerances: float32 outputs within rtol = atol = 1e-5; masks,
``neuron_active``, stats and tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import TOL, _model, _prompts  # noqa: E402

ARCH = "mamba2-130m"


def _np(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


# ---------------------------------------------------------------------------
# configs, registry, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_and_registry_equal_the_reference(getter):
    jc, tc = getattr(JC, getter)(ARCH), getattr(TC, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.d_inner, tc.ssm_n_heads) == (jc.d_inner, jc.ssm_n_heads)
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density) for s in treg] == [
        (s.path, s.d_in, s.d_out, s.lead, s.density) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_full_width_shapes_and_fan_ins():
    cfg = TC.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.vocab_size, cfg.tie_embeddings, cfg.ssd_chunk) == (
        24, 768, 1536, 24, 64, 128, 50_280, True, 64)
    reg = TR.build_registry(cfg)
    assert [(s.name, s.d_in, s.d_out, s.lead) for s in reg] == [
        ("blocks/in_z", 768, 1536, (24,)), ("blocks/in_x", 768, 1536, (24,)),
        ("blocks/out_proj", 1536, 768, (24,))]
    assert TR.k_fan_map(cfg, reg) == JR.k_fan_map(JC.get_config(ARCH),
                                                  JR.build_registry(JC.get_config(ARCH)))


def test_param_layout_dtypes_and_the_ssm_out_fan_in_quirk():
    """The port's init has the reference's paths, shapes and dtypes, in
    float32 and with bf16 params (``a_log``, ``d_skip``, ``dt_bias`` stay
    float32, and the bridge keeps them so); ``out_proj`` is drawn at the
    dense fan-in (its std is 1/sqrt(d_inner), not 1/sqrt(k)) because the
    reference looks its fan-in up under ``"ssm_out"``."""
    for param_dtype in ("float32", "bfloat16"):
        jcfg = JC.get_smoke_config(ARCH).replace(param_dtype=param_dtype)
        tcfg = TC.get_smoke_config(ARCH).replace(param_dtype=param_dtype)
        jreg = JR.build_registry(jcfg)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0), JR.k_fan_map(jcfg, jreg))
        tp = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            TR.k_fan_map(tcfg, TR.build_registry(tcfg)))
        jflat, tflat = bridge.flatten(jax.tree.map(np.asarray, jp)), bridge.flatten(tp)
        assert jflat.keys() == tflat.keys()
        bridged = bridge.flatten(bridge.from_jax_numpy(jax.tree.map(np.asarray, jp)))
        for k, v in jflat.items():
            want = str(v.dtype).replace("bfloat16", "torch.bfloat16")
            assert tuple(tflat[k].shape) == v.shape, k
            assert str(tflat[k].dtype).removeprefix("torch.") == want.removeprefix("torch."), k
            assert bridged[k].dtype == tflat[k].dtype, k
        for f in ("a_log", "d_skip", "dt_bias"):
            assert tflat[f"blocks/{f}"].dtype == torch.float32
    cfg = TC.get_config(ARCH).replace(n_layers=1)
    reg = TR.build_registry(cfg)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), TR.k_fan_map(cfg, reg))
    std = float(p["blocks"]["out_proj"].std())
    assert abs(std - cfg.d_inner ** -0.5) < 0.02 * cfg.d_inner ** -0.5
    k_x = TR.k_fan_map(cfg, reg)["in_x"]
    assert abs(float(p["blocks"]["in_x"].std()) - k_x ** -0.5) < 0.02 * k_x ** -0.5


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_the_reference(with_state):
    x, w, b = _np(0, 2, 7, 12), _np(1, 4, 12, scale=0.3), _np(2, 12, scale=0.1)
    st = _np(3, 2, 3, 12) if with_state else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, ts = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _ssd_inputs(seed: int, t: int, *, bsz=2, h=3, p=4, n=5):
    x = _np(seed, bsz, t, h, p)
    dt = np.log1p(np.exp(_np(seed + 1, bsz, t, h))).astype(np.float32)
    a = -np.exp(_np(seed + 2, h, scale=0.5)).astype(np.float32)
    return x, dt, a, _np(seed + 3, bsz, t, n), _np(seed + 4, bsz, t, n)


@pytest.mark.parametrize("t,chunk,with_h0", [(19, 8, False), (19, 8, True), (16, 16, True),
                                             (5, 64, False)])
def test_ssd_chunked_equals_the_reference(t, chunk, with_h0):
    ins = _ssd_inputs(10, t)
    h0 = _np(20, 2, 3, 4, 5) if with_h0 else None
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TS.ssd_chunked(*map(torch.from_numpy, ins), chunk=chunk,
                            h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (2, t, 3, 4) and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_ssd_decode_step_equals_the_reference():
    x, dt, a, b, c = _ssd_inputs(30, 1)
    h = _np(31, 2, 3, 4, 5)
    jy, jh = JS.ssd_decode_step(*map(jnp.asarray, (x, dt, a, b, c, h)))
    ty, th = TS.ssd_decode_step(*map(torch.from_numpy, (x, dt, a, b, c, h)))
    _close(ty, jy)
    _close(th, jh)


def test_ssm_block_with_masks_prefill_then_decode_equals_the_reference():
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    jp = JS.SSMParams(**{f: m["jparams"]["blocks"][f][0] for f in JS.SSMParams._fields})
    tp = TS.SSMParams(**{f: m["tparams"]["blocks"][f][0] for f in TS.SSMParams._fields})
    jm = {k: v[0] for k, v in m["jmasks"]["blocks"].items()}
    tm = {k: v[0] for k, v in m["tmasks"]["blocks"].items()}
    assert set(tm) == {"in_z", "in_x", "out_proj"}
    x = _np(40, 2, 21, cfg.d_model)
    jy, jst = JS.ssm_block(m["jcfg"], jp, jnp.asarray(x), jm, chunk=cfg.ssd_chunk)
    ty, tst = TS.ssm_block(cfg, tp, torch.from_numpy(x), tm, chunk=cfg.ssd_chunk)
    _close(ty, jy)
    for t_, j_ in zip(tst, jst):
        _close(t_, j_)
    x1 = _np(41, 2, 1, cfg.d_model)
    jy1, jst1 = JS.ssm_block(m["jcfg"], jp, jnp.asarray(x1), jm, state=jst, decode=True)
    ty1, tst1 = TS.ssm_block(cfg, tp, torch.from_numpy(x1), tm, state=tst, decode=True)
    _close(ty1, jy1)
    for t_, j_ in zip(tst1, jst1):
        _close(t_, j_)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch(cfg, seed: int = 0, b: int = 2, t: int = 24) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_loss_gradients_and_an_srigl_update_equal_the_reference():
    m = _model(ARCH, ())
    batch = _batch(m["tcfg"])
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(m["jcfg"], p, m["jmasks"], b)[0]))(
            m["jparams"], jax.tree.map(jnp.asarray, batch))
    params = bridge.from_jax_numpy(jax.tree.map(np.asarray, m["jparams"]))
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
    # the sparse stacks' gradients are dense (the straight-through mask)
    g = leaves["blocks/in_x"].grad
    assert bool((g[~m["tmasks"]["blocks"]["in_x"]] != 0).any())

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
    moved = 0
    for s in m["treg"]:
        for f, v in jstats[s.name].items():
            np.testing.assert_array_equal(tstats[s.name][f].numpy(), np.asarray(v),
                                          err_msg=f"{s.name}/{f}")
        moved += int(tstats[s.name]["n_pruned"].sum())
    assert moved > 0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def test_prefill_and_decode_equal_the_reference_and_the_forward():
    """Prefill 2 x 13 (chunk 16: one padded chunk) then 7 decode steps: the
    logits equal the reference's at each step (1e-5), and the last ones
    equal the teacher-forced forward's at that position (relative 1e-4,
    the reference's own contract for its decode), the state in f32."""
    m = _model(ARCH, ())
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    toks = _prompts(tcfg, 2, 20, seed=7)
    jcache = JM.init_cache(jcfg, 2, 20)
    tcache = TM.init_cache(tcfg, 2, 20, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache["blocks"].items()} == {
        k: v.shape for k, v in jcache["blocks"].items()}
    assert tcache["blocks"]["h"].dtype == torch.float32
    jl, jcache = JM.prefill_step(jcfg, m["jparams"], m["jmasks"],
                                 {"tokens": jnp.asarray(toks[:, :13])}, jcache)
    tl, tcache = TM.prefill_step(tcfg, m["tparams"], m["tmasks"],
                                 {"tokens": torch.from_numpy(toks[:, :13])}, tcache)
    _close(tl, jl)
    for t in range(13, 20):
        jl, jcache = JM.decode_step(jcfg, m["jparams"], m["jmasks"],
                                    {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache)
        tl, tcache = TM.decode_step(tcfg, m["tparams"], m["tmasks"],
                                    {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tcache)
        _close(tl, jl)
        for f in TM.SSM_STATE:
            _close(tcache["blocks"][f], jcache["blocks"][f])
    assert int(tcache["len"]) == 20
    x, positions = TM.embed_inputs(tcfg, m["tparams"], {"tokens": torch.from_numpy(toks)})
    hidden, _ = TM.backbone(tcfg, m["tparams"], m["tmasks"], x, positions=positions)
    fwd = TM._lm_logits(tcfg, m["tparams"], hidden[:, -1])
    assert _rel(tl.numpy(), fwd.detach().numpy()) < 1e-4
    # a reset cache prefills as a fresh one
    TM.reset_cache(tcfg, tcache)
    again, _ = TM.prefill_step(tcfg, m["tparams"], m["tmasks"],
                               {"tokens": torch.from_numpy(toks[:, :13])}, tcache)
    fresh, _ = TM.prefill_step(tcfg, m["tparams"], m["tmasks"],
                               {"tokens": torch.from_numpy(toks[:, :13])},
                               TM.init_cache(tcfg, 2, 20, "cpu"))
    assert torch.equal(again, fresh)
