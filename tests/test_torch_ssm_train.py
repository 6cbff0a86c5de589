"""The SSM family (mamba2-130m smoke) trained against the JAX reference on
the CPU, and its CLIs.

Six ``Trainer`` steps with an SRigL update after steps 3 and 6: losses
within 2e-4 (as ``tests/test_torch_train.py`` holds the dense family),
masks, ``neuron_active`` and versions exactly, params and optimizer state
within rtol = atol = 1e-5. The CLIs: ``serve --path condensed`` prints
``--path masked``'s first stream, and ``train`` runs. Serving is in
``tests/test_torch_ssm_engine.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.optim import schedules as TSc  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

ARCH = "mamba2-130m"


def _losses(lines):
    return [float(line.split(" loss ")[1].split()[0]) for line in lines
            if line.startswith("[trainer] step")]


def test_trainer_matches_the_reference_over_six_steps_with_two_srigl_updates():
    jcfg, tcfg = (c.replace(sparsity=dataclasses.replace(c.sparsity, delta_t=3))
                  for c in (JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)))
    jstate = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax_numpy(jax.tree.map(np.asarray, jstate))
    jdata = JP.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0,
                           family="ssm")
    tdata = TP.SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=4, seed=0,
                           family="ssm")
    jlog, tlog = [], []
    jout = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, 6), log_every=1).fit(
        jstate, (jax.tree.map(jnp.asarray, b) for b in jdata.iterate()), 6, log_fn=jlog.append)
    trainer = TT.Trainer(cfg=tcfg, lr_fn=TSc.warmup_cosine(3e-3, 1, 6), log_every=1)
    tout = trainer.fit(tstate, tdata.iterate(), 6, log_fn=tlog.append)
    assert int(tout.step) == 6 and len(_losses(tlog)) == 6
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), atol=2e-4)
    jo = jax.tree.map(np.asarray, jout)._asdict()
    to = bridge.train_state_to_jax_numpy(tout)
    for key in ("masks", "neuron_active", "mask_versions"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{key}/{k}")
    assert {k: int(v) for k, v in tout.mask_versions.items()} == {
        s.name: 2 for s in trainer.registry}
    for key in ("params", "opt_state"):
        jf, tf = bridge.flatten(jo[key]), bridge.flatten(to[key])
        for k in jf:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5, atol=1e-5, err_msg=f"{key}/{k}")
    for s in trainer.registry:  # the topology did move
        assert not torch.equal(tout.masks["blocks"][s.path[-1]],
                               tstate.masks["blocks"][s.path[-1]])


def test_the_clis_serve_and_train_mamba2(capsys):
    from repro_torch.launch import serve as TSv
    from repro_torch.launch import train as TTr
    first = {}
    for path in ("condensed", "masked"):
        TSv.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--path", path,
                  "--batch", "2", "--prompt-len", "16", "--gen", "6"])
        out = capsys.readouterr().out
        first[path] = next(line for line in out.splitlines() if "first stream" in line)
    assert first["condensed"] == first["masked"]
    TTr.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2"])
    assert "[train] done at step 2" in capsys.readouterr().out
