"""The quickstart's training recipe in the port against the reference, step
by step, on the CPU.

``examples/quickstart.py`` trains the smoke qwen3 for 60 steps with SRigL at
``delta_t=10`` (lr 3e-3, ``SyntheticLM(seq_len=48, batch_size=8, seed=0)``),
so six topology updates. The reference's ``init_train_state`` at
``PRNGKey(0)`` is carried into the port by the bridge and both trainers run
the 60 steps on the same batches, each on its own state: every step's loss
agrees within LOSS_TOL, and after each of the six updates the masks,
``neuron_active`` and ``mask_versions`` are equal exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.core.schedule import DSTSchedule  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

ARCH = "qwen3-1.7b"
STEPS, DELTA_T, LR = 60, 10, 3e-3
# two float32 trainers on the same batches: the gap grows with the steps
# (summation order differs between XLA and torch), so it is held per step
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


def test_sixty_quickstart_steps_match_the_reference():
    cfgs = []
    for C in (JCfg, TCfg):
        c = C.get_smoke_config(ARCH)
        cfgs.append(c.replace(sparsity=dataclasses.replace(c.sparsity, delta_t=DELTA_T)))
    jcfg, tcfg = cfgs
    jreg, treg = JR.build_registry(jcfg), TR.build_registry(tcfg)
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(JT.make_train_step(jcfg, jreg, lambda s: jnp.float32(LR)))
    jdst = jax.jit(JT.make_dst_step(jcfg, jreg))
    tstep = TT.make_train_step(tcfg, treg, lambda s: LR)
    tdst = TT.make_dst_step(tcfg, treg)
    sched = DSTSchedule(delta_t=DELTA_T)
    data = SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=48, batch_size=8, seed=0)

    updates = 0
    for i in range(STEPS):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL,
                                   err_msg=f"step {i}")
        if bool(sched.is_update_step(i + 1)):
            jstate = jdst(jstate, jax.tree.map(jnp.asarray, batch))
            tstate = tdst(tstate, tbatch)
            updates += 1
            jo = jax.tree.map(np.asarray, jstate)._asdict()
            to = bridge.train_state_to_jax_numpy(tstate)
            for key in ("masks", "neuron_active", "mask_versions"):
                jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
                assert jf.keys() == tf.keys()
                for k in jf:
                    np.testing.assert_array_equal(tf[k], jf[k],
                                                  err_msg=f"update {updates} {key}/{k}")
    assert updates == 6
    assert all(int(v) == 6 for v in tstate.mask_versions.values())
