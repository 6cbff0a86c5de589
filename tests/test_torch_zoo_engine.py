"""Serving the configs beyond qwen3-1.7b against the JAX reference's engine,
on the CPU at smoke dims: gemma3-1b and qwen2-vl-7b on the slab path (as
``supports_paged`` turns them away), internlm2-20b and mistral-large-123b on
the paged pool, masked and condensed; the refusals of the paged and
speculative engines and of refresh, sync and autotune on the grouped
layout; qwen2-vl-7b's greedy ``generate``.

The reference's weights and masks (from ``PRNGKey(0)``) are bridged into the
port (``tests/_torch_zoo_model.py``). Masks, ``neuron_active``, indices,
batches and tokens are held equal exactly; float32 logits, losses and
gradients within rtol = atol = 1e-5, as ``tests/test_torch_models.py``
states. On the CPU every sparse linear runs K1's plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from _torch_zoo_model import GEMMA, _ids, _model, _prompts  # noqa: E402


# ---------------------------------------------------------------------------
# engines: tokens equal the reference engine's
# ---------------------------------------------------------------------------

def _engine_tokens(m, path: str, reqs, paged=None):
    """Each request's tokens from the reference's engine and the port's,
    submitted together and stepped once."""
    out = []
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"], path=path,
                            paged=paged)
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path=path,
                            paged=paged)
    assert teng.paged == jeng.paged
    for eng, to in ((jeng, jnp.asarray), (teng, torch.from_numpy)):
        ids = [eng.submit(to(p), g) for p, g in reqs]
        eng.step()
        res = {r.id: r for r in eng.retire()}
        out.append([np.asarray(res[i].tokens) for i in ids])
    return out, teng


@pytest.mark.parametrize("path", ["masked", "condensed"])
@pytest.mark.parametrize("arch,kw", GEMMA + [("qwen2-vl-7b", ())],
                         ids=_ids(GEMMA + [("qwen2-vl-7b", ())]))
def test_slab_engine_tokens_equal_the_reference_engine(arch, kw, path):
    """gemma3 and qwen2-vl are outside ``supports_paged``: ``paged=None``
    serves them on the slab path, as the reference does; a 24-token prompt
    wraps gemma3's 16-slot rings."""
    m = _model(arch, kw)
    cfg = m["tcfg"]
    reqs = [(_prompts(cfg, 3, 24, seed=1), 9), (_prompts(cfg, 2, 24, seed=2), 9),
            (_prompts(cfg, 1, 5, seed=3), 4)]
    (jt, tt), teng = _engine_tokens(m, path, reqs)
    assert not teng.paged
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t, j)
    # generate: the same greedy tokens
    p = reqs[0][0]
    tree_t = teng.serving_tree_for(teng.plan_key(p.shape[0]))
    np.testing.assert_array_equal(
        TE.generate(cfg, m["tparams"], tree_t, torch.from_numpy(p), 9).numpy(), jt[0])


@pytest.mark.parametrize("path", ["masked", "condensed"])
@pytest.mark.parametrize("arch", ["internlm2-20b", "mistral-large-123b"])
def test_paged_engine_tokens_equal_the_reference_engine(arch, path):
    m = _model(arch, ())
    cfg = m["tcfg"]
    assert TM.supports_paged(cfg) and not cfg.tie_embeddings
    reqs = [(_prompts(cfg, 3, 20, seed=1), 10), (_prompts(cfg, 1, 7, seed=2), 5)]
    (jt, tt), teng = _engine_tokens(m, path, reqs)
    assert teng.paged
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t, j)


def test_engines_refuse_what_the_grouped_and_mrope_layouts_do_not_take(tmp_path, monkeypatch):
    from repro_torch.launch.speculative import SpecConfig
    for arch, kw in (GEMMA[0], ("qwen2-vl-7b", ())):
        m = _model(arch, kw)
        args = (m["tcfg"], m["tparams"], m["tmasks"], m["treg"])
        with pytest.raises(ValueError, match="paged serving requires"):
            TE.ServingEngine(*args, paged=True)
        with pytest.raises(ValueError, match="speculative decoding runs on the paged"):
            TE.ServingEngine(*args, path="condensed", speculative=SpecConfig())
        with pytest.raises(ValueError, match="paged pool serves"):
            TM.init_paged_pool(m["tcfg"], 4, 4, "cpu")
    # refresh, live sync and the launch search run on the grouped layout's
    # (g, r) stacks (parity with the reference: tests/test_torch_lead2*.py)
    from repro_torch.sparse import autotune as AT
    from repro_torch.sync import DirChannel, Publisher, Subscriber
    m = _model(*GEMMA[0])
    eng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path="condensed",
                           mask_versions={s.name: 0 for s in m["treg"]})
    eng.plan_for(eng.plan_key(1))
    changed = eng.refresh(m["tparams"], m["tmasks"], {s.name: 1 for s in m["treg"]})
    assert [sorted(names) for names in changed.values()] == [
        sorted(s.name for s in m["treg"])]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    AT.reset_cache_state()
    try:
        assert "g_local/w_down" in eng.autotune(1, dtype=torch.float32, reps=1)
    finally:
        AT.reset_cache_state()
    pub = Publisher(m["tcfg"], m["treg"], DirChannel(str(tmp_path / "sync")), path="condensed")
    pub.publish(params=m["tparams"], masks=m["tmasks"],
                mask_versions={s.name: 1 for s in m["treg"]})
    sub = Subscriber(DirChannel(str(tmp_path / "sync")).subscribe("r"))
    sub.poll()
    eng.attach_subscriber(sub)
    assert eng._sync_generation == sub.generation == 1


def test_vlm_generate_equals_the_reference():
    m = _model("qwen2-vl-7b", ())
    prompts = _prompts(m["tcfg"], 3, 10)
    want = np.asarray(JE.generate(m["jcfg"], m["jparams"], m["jmasks"], jnp.asarray(prompts), 8))
    got = TE.generate(m["tcfg"], m["tparams"], m["tmasks"], torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)
