"""The main path closed on a trained checkpoint, on the CPU.

The reference's smoke qwen3 is trained by ``repro.train.trainer.Trainer``
through two SRigL topology updates (``delta_t=2``, 4 steps), saved with
``repro.train.checkpoint`` and restored by ``repro_torch.train.checkpoint``
into a port-initialized template. Served by the port's ``ServingEngine``,
its ``--path condensed`` tokens equal its ``--path masked`` tokens, and
both equal the reference ``ServingEngine``'s on the same checkpoint,
exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.optim import schedules as JSc  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

ARCH = "qwen3-1.7b"
STEPS, DELTA_T = 4, 2
# two requests of one group (bucket 8), of two prompt and generation lengths
REQUESTS = ((2, 8, 8, 5), (3, 6, 6, 6))


def _prompts(b, t, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's trained smoke state, its checkpoint restored into the
    port, and the reference engine's tokens for REQUESTS on the condensed
    path."""
    base = JCfg.get_smoke_config(ARCH)
    jcfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=DELTA_T))
    init = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    init_masks = jax.tree.map(np.array, init.masks)   # the trainer donates the state
    data = JD.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    trainer = JT.Trainer(cfg=jcfg, lr_fn=JSc.warmup_cosine(3e-3, 1, STEPS), log_every=STEPS)
    state = trainer.fit(init, (jax.tree.map(jnp.asarray, b) for b in data.iterate()), STEPS,
                        log_fn=lambda _: None)
    ckpt = str(tmp_path_factory.mktemp("trained"))
    JCK.save(ckpt, state)
    tcfg = TCfg.get_smoke_config(ARCH)
    template = TSt.init_train_state(tcfg, torch.Generator().manual_seed(1))
    restored = TCK.restore(ckpt, TCK.latest_step(ckpt), template)

    jreg = JR.build_registry(jcfg)
    eng = JE.ServingEngine(jcfg, state.params, state.masks, jreg, path="condensed")
    ids = [eng.submit(jnp.asarray(_prompts(b, t, s, jcfg.vocab_size)), g)
           for b, t, g, s in REQUESTS]
    eng.step()
    jax_tokens = [np.asarray(eng.retire(i)[0].tokens) for i in ids]
    return dict(init_masks=init_masks, state=state, restored=restored, tcfg=tcfg,
                treg=TR.build_registry(tcfg), jax_tokens=jax_tokens)


def test_the_checkpoint_holds_moved_topology(trained):
    """Two SRigL updates ran: the step count and mask versions say so, and
    the restored masks are the trained ones, not the initial ones."""
    r = trained
    assert int(r["restored"].step) == STEPS
    assert all(int(v) == STEPS // DELTA_T for v in r["restored"].mask_versions.values())
    moved = 0
    for s in r["treg"]:
        got = r["restored"].masks["blocks"][s.path[-1]].numpy()
        np.testing.assert_array_equal(got, np.asarray(JR.get_path(r["state"].masks, s.path)))
        moved += not np.array_equal(got, JR.get_path(r["init_masks"], s.path))
    assert moved


@pytest.mark.parametrize("path", ["condensed", "masked"])
def test_port_engine_serves_the_reference_engines_tokens(trained, path):
    r = trained
    eng = TE.ServingEngine(r["tcfg"], r["restored"].params, r["restored"].masks, r["treg"],
                           path=path)
    ids = [eng.submit(_prompts(b, t, s, r["tcfg"].vocab_size), g) for b, t, g, s in REQUESTS]
    eng.step()
    for rid, want in zip(ids, r["jax_tokens"]):
        [res] = eng.retire(rid)
        np.testing.assert_array_equal(res.tokens.numpy(), want)
