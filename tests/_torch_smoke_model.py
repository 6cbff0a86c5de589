"""The reference's smoke qwen3-1.7b (weights and SRigL masks from
``PRNGKey(0)``), its weights bridged into the port, and the masks with
half of every stack's output neurons ablated, built once per process and
shared by the quantized-serving test files, which then also share the
reference's compiled exports at these shapes. Callers must not modify
what it returns."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from repro import configs as jconfigs
from repro.models import model as JM
from repro.sparse import registry as JR
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.sparse import registry as TR

# The suite runs in several processes at once (pytest-xdist), each of which
# would otherwise give torch's CPU kernels a pool of every core: at the
# tests' small shapes the pools then contend, and ops run several times
# slower. One intra-op thread a process; every test module is collected in
# every process, so this holds for the whole run.
torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
ABLATION = 0.5


@functools.lru_cache(maxsize=None)
def smoke_model() -> dict:
    jcfg = jconfigs.get_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    jreg = JR.build_registry(jcfg)
    jparams = JM.init_params(jcfg, key, JR.k_fan_map(jcfg, jreg))
    masks = JR.init_sparsity_state(jcfg, key, jreg)["masks"]
    tcfg = tconfigs.get_smoke_config(ARCH)
    return dict(jcfg=jcfg, jreg=jreg, jparams=jparams, jmasks=masks, tcfg=tcfg,
                treg=TR.build_registry(tcfg),
                tparams=bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams)))


def ablate(reg, masks, only: bool) -> dict:
    """The last ABLATION of each stack's output neurons cut: from ``masks``,
    or, with ``only``, from all-True masks (ablation-only masks)."""
    out = {}
    for s in reg:
        m = JR.get_path(masks, s.path)
        cut = s.d_out - max(1, int(s.d_out * ABLATION))
        col = (jnp.arange(s.d_out) < cut)[None, :]
        JR._set_path(out, s.path, jnp.broadcast_to(col, m.shape) if only else m & col)
    return out


@functools.lru_cache(maxsize=None)
def smoke_masks() -> dict:
    """The smoke model's masks: "plain" (SRigL), "ablated" and
    "ablation_only"."""
    m = smoke_model()
    return {"plain": m["jmasks"], "ablated": ablate(m["jreg"], m["jmasks"], False),
            "ablation_only": ablate(m["jreg"], m["jmasks"], True)}
