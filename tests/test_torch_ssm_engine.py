"""The SSM family (mamba2-130m smoke) served against the JAX reference on
the CPU.

Serving on the slab engine (``paged=None`` picks it: SSM state has no paged
form, and ``paged=True`` is refused as in the reference): tokens equal the
reference engine's on masked, condensed, int8 condensed and auto, and
after a refresh between requests; a second request through the same
captured decode step starts from a zeroed state; ``generate`` equals the
reference's. Training and the CLIs are in ``tests/test_torch_ssm_train.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from _torch_zoo_model import _model, _prompts, rewired_generation, to_port  # noqa: E402

ARCH = "mamba2-130m"


def _engines(m, path, values_dtype=None, **kw):
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path=path,
                            values_dtype=values_dtype, **kw)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path=path,
                            values_dtype=values_dtype, **kw)
    return jeng, teng


@pytest.mark.parametrize("path,values_dtype", [("masked", None), ("condensed", None),
                                               ("condensed", "int8"), ("auto", None)])
def test_slab_engine_tokens_equal_the_reference_engine(path, values_dtype):
    """Two requests of one shape (fused into one slab) and one of another:
    the reference engine's tokens, then a repeat of the first through the
    same captured decode step (its state zeroed at prefill)."""
    m = _model(ARCH, ())
    cfg = m["tcfg"]
    reqs = [(_prompts(cfg, 2, 20, seed=1), 6), (_prompts(cfg, 1, 20, seed=2), 6),
            (_prompts(cfg, 3, 9, seed=3), 4)]
    jeng, teng = _engines(m, path, values_dtype)
    assert not teng.paged and not jeng.paged
    out = []
    for eng, to in ((jeng, jnp.asarray), (teng, torch.from_numpy)):
        ids = [eng.submit(to(p), g) for p, g in reqs]
        eng.step()
        res = {r.id: r for r in eng.retire()}
        out.append([np.asarray(res[i].tokens) for i in ids])
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)
    key = teng.plan_key(3)
    decoders = dict(teng._legacy_decoders[key])
    rid = teng.submit(reqs[2][0], reqs[2][1])
    teng.step()
    [res] = teng.retire(rid)
    np.testing.assert_array_equal(res.tokens.numpy(), out[1][2])
    assert teng._legacy_decoders[key] == decoders and not res.cold


def test_paged_serving_is_refused_as_in_the_reference():
    m = _model(ARCH, ())
    assert not TM.supports_paged(m["tcfg"])
    with pytest.raises(ValueError, match="paged serving requires"):
        TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], paged=True)
    with pytest.raises(ValueError, match="paged pool serves"):
        TM.init_paged_pool(m["tcfg"], 4, 4, "cpu")


def test_generate_equals_the_reference():
    m = _model(ARCH, ())
    prompts = _prompts(m["tcfg"], 3, 10, seed=4)
    want = np.asarray(JS.generate(m["jcfg"], m["jparams"], m["jmasks"], jnp.asarray(prompts),
                                  gen_len=8))
    got = TE.generate(m["tcfg"], TM.serving_params(m["tcfg"], m["tparams"]), m["tmasks"],
                      torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ["condensed", "masked"])
def test_engine_refresh_between_requests_equals_the_reference(path):
    m = _model(ARCH, ())
    versions, params2, masks2, versions2 = rewired_generation(m, "blocks/in_x")
    prompts = _prompts(m["tcfg"], 2, 12, seed=5)
    jeng, teng = _engines(m, path, mask_versions=dict(versions))
    toks = []
    for eng, p, refresh in ((jeng, jnp.asarray(prompts),
                             lambda: jeng.refresh(params2, masks2, versions2, donate=False)),
                            (teng, prompts,
                             lambda: teng.refresh(to_port(params2), to_port(masks2),
                                                  versions2))):
        r1 = eng.submit(p, 6)
        eng.step()
        refresh()
        r2 = eng.submit(p, 6)
        eng.step()
        toks.append([np.asarray(eng.retire(r)[0].tokens) for r in (r1, r2)])
    for j, t in zip(*toks):
        np.testing.assert_array_equal(t, j)
