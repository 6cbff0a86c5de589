"""The configs beyond qwen3-1.7b at smoke dims for the ``test_torch_zoo*``
files: the reference's weights and SRigL masks from ``PRNGKey(0)`` and
their port counterparts, bridged, built once per process per (arch,
overrides). Callers must not modify what ``_model`` returns."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from repro import configs as JC
from repro.models import model as JM
from repro.sparse import condensed as JCond
from repro.sparse import registry as JR
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.sparse import condensed as TCond
from repro_torch.sparse import registry as TR

# The suite runs in several processes at once (pytest-xdist), each of which
# would otherwise give torch's CPU kernels a pool of every core: at the
# tests' small shapes the pools then contend, and ops run several times
# slower. One intra-op thread a process; every test module is collected in
# every process, so this holds for the whole run.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# (arch, config overrides): gemma3 at smoke (rem = 0) and at 8 layers (rem = 2)
GEMMA = [("gemma3-1b", ()), ("gemma3-1b", (("n_layers", 8),))]
DENSE = [("internlm2-20b", ()), ("mistral-large-123b", ())]
ALL = GEMMA + [("qwen2-vl-7b", ())] + DENSE


def _ids(cases):
    return ["-".join([a] + [f"{k}{v}" for k, v in kw]) for a, kw in cases]


@functools.lru_cache(maxsize=None)
def _model(arch: str, kw: tuple) -> dict:
    """The reference's smoke model of ``arch`` (``kw`` overrides), and the
    port's config, registry and the same params and masks, bridged."""
    jcfg = JC.get_smoke_config(arch).replace(**dict(kw))
    tcfg = TC.get_smoke_config(arch).replace(**dict(kw))
    key = jax.random.PRNGKey(0)
    jreg = JR.build_registry(jcfg)
    jparams = JM.init_params(jcfg, key, JR.k_fan_map(jcfg, jreg))
    jstate = JR.init_sparsity_state(jcfg, key, jreg)
    return dict(jcfg=jcfg, jreg=jreg, jparams=jparams, jmasks=jstate["masks"],
                jactive=jstate["neuron_active"], tcfg=tcfg, treg=TR.build_registry(tcfg),
                tparams=bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams)),
                tmasks=bridge.from_jax_numpy(jax.tree.map(np.asarray, jstate["masks"])),
                tactive=bridge.from_jax_numpy(jax.tree.map(np.asarray,
                                                           jstate["neuron_active"])))


@functools.lru_cache(maxsize=None)
def condensed_trees(arch: str, kw: tuple) -> tuple:
    """(the reference's, the port's) condensed export of ``_model(arch,
    kw)``'s params and masks, built once per process. Callers must not
    modify them."""
    m = _model(arch, kw)
    return (JCond.export_condensed(m["jcfg"], m["jreg"], m["jparams"], m["jmasks"]),
            TCond.export_condensed(m["tcfg"], m["treg"], m["tparams"], m["tmasks"]))


def _prompts(cfg, b: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _assert_trees_close(jtree, ttree, **tol):
    jflat = bridge.flatten(jax.tree.map(np.asarray, jtree))
    tflat = bridge.flatten(ttree)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(tflat[k].detach().float().numpy(),
                                   np.asarray(v, np.float32), err_msg=k, **tol)


def rewired_generation(m: dict, name: str):
    """A training job's next generation for ``m``: stack ``name``'s mask
    rolled by one input row over all its leading axes (a rewire at an
    unchanged fan-in and column activity), every float param times 1.01,
    the stack's version bumped. Returns (versions, params, masks,
    versions') as reference trees."""
    s = next(s for s in m["jreg"] if s.name == name)
    masks = jax.tree.map(lambda x: x, m["jmasks"])
    JR.set_path(masks, s.path, jnp.roll(JR.get_path(m["jmasks"], s.path), 1, axis=-2))
    params = jax.tree.map(lambda x: x * 1.01, m["jparams"])
    versions = {s.name: 0 for s in m["jreg"]}
    return versions, params, masks, dict(versions, **{name: 1})


def to_port(tree) -> dict:
    """A reference tree as the port's tensors."""
    return bridge.from_jax_numpy(jax.tree.map(np.asarray, tree))
