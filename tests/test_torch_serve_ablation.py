"""The neuron-ablation serving paths as a whole: the reference's smoke qwen3
weights with ablated masks, bridged into the port, give the reference's
greedy tokens on ``condensed_over_active``, ``structured`` and ``auto``,
and matching logits (atol 1e-4, float32).

Each side builds its serving tree with its own ``build_serving_masks`` at
the request's batch bucket; ``structured`` is served on ablation-only masks,
the one regime where it is exact, the other paths on ablated constant
fan-in masks. ``auto`` decides with each side's own hardware profile, so
the two plans may differ; every choice is exact, so the tokens may not.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

ARCH = "qwen3-1.7b"
GEN = 10
LOGIT_ATOL = 1e-4
ABLATION = 0.5
PATH_MASKS = {"condensed_over_active": "ablated", "structured": "ablation_only",
              "auto": "ablated"}


def _ablate(reg, masks, only):
    out = {}
    for s in reg:
        m = JR.get_path(masks, s.path)
        cut = s.d_out - max(1, int(s.d_out * ABLATION))
        col = (jnp.arange(s.d_out) < cut)[None, :]
        JR._set_path(out, s.path, jnp.broadcast_to(col, m.shape) if only else m & col)
    return out


@pytest.fixture(scope="module")
def run():
    """One JAX init, plan and generate per path (and masked per mask set)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    jreg = JR.build_registry(jcfg)
    jparams = JM.init_params(jcfg, key, JR.k_fan_map(jcfg, jreg))
    base = JR.init_sparsity_state(jcfg, key, jreg)["masks"]
    jmasks = {"ablated": _ablate(jreg, base, False), "ablation_only": _ablate(jreg, base, True)}
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    bucket = TP.batch_bucket(prompts.shape[0])
    tcfg = tconfigs.get_smoke_config(ARCH)
    treg = TR.build_registry(tcfg)
    tparams = bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams))
    tmasks = {k: bridge.from_jax_numpy(jax.tree.map(np.asarray, m)) for k, m in jmasks.items()}
    jserve, tserve, jtok, ttok = {}, {}, {}, {}
    for kind in jmasks:
        jserve[f"masked/{kind}"], tserve[f"masked/{kind}"] = jmasks[kind], tmasks[kind]
    for path, kind in PATH_MASKS.items():
        jserve[path] = JS.build_serving_masks(jcfg, jreg, jparams, jmasks[kind], path,
                                              batch_size=bucket)
        tserve[path] = TS.build_serving_masks(tcfg, treg, tparams, tmasks[kind], path,
                                              batch_size=prompts.shape[0])
    for name in jserve:
        jtok[name] = np.asarray(JE.generate(jcfg, jparams, jserve[name], jnp.asarray(prompts),
                                            GEN))
        ttok[name] = TE.generate(tcfg, tparams, tserve[name], torch.from_numpy(prompts),
                                 GEN).numpy()
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams, treg=treg,
                tmasks=tmasks, jserve=jserve, tserve=tserve, prompts=prompts,
                jtok=jtok, ttok=ttok)


@pytest.mark.parametrize("path", sorted(PATH_MASKS))
def test_tokens_equal_the_reference_and_the_masked_path(run, path):
    want = run["jtok"][path]
    assert want.shape == (3, 8 + GEN)
    np.testing.assert_array_equal(run["ttok"][path], want)
    masked = f"masked/{PATH_MASKS[path]}"
    np.testing.assert_array_equal(run["ttok"][masked], run["jtok"][masked])
    np.testing.assert_array_equal(run["ttok"][path], run["ttok"][masked])


@pytest.mark.parametrize("path", sorted(PATH_MASKS))
def test_prefill_and_decode_logits_agree(run, path):
    r = run
    jserve, tserve = r["jserve"][path], r["tserve"][path]
    b, t = r["prompts"].shape
    jcache = JM.init_cache(r["jcfg"], b, t + 2)
    jl, jcache = JM.prefill_step(r["jcfg"], r["jparams"], jserve,
                                 {"tokens": jnp.asarray(r["prompts"])}, jcache)
    tcache = TM.init_cache(r["tcfg"], b, t + 2, device="cpu")
    tl, tcache = TM.prefill_step(r["tcfg"], r["tparams"], tserve,
                                 {"tokens": torch.from_numpy(r["prompts"])}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl2, _ = JM.decode_step(r["jcfg"], r["jparams"], jserve, {"tokens": jnp.asarray(nxt)},
                            jcache)
    tl2, _ = TM.decode_step(r["tcfg"], r["tparams"], tserve,
                            {"tokens": torch.from_numpy(nxt)}, tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_ATOL, rtol=0)


def test_serving_model_takes_a_plan(run):
    r = run
    plan = TS.build_plan(r["tcfg"], r["treg"], r["tparams"], r["tmasks"]["ablated"], "auto",
                         batch_size=3)
    assert plan.batch_size == 8
    model = TE.ServingModel(r["tcfg"], r["tparams"], plan)
    assert model.plan is plan and model.serving is plan.serving_tree
    out = model.generate(torch.from_numpy(r["prompts"]), GEN)
    np.testing.assert_array_equal(out.numpy(), r["jtok"]["auto"])


def _cli(path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TS.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--gen", "6", "--path", path, "--device", "cpu"])
    return out, buf.getvalue().splitlines()


def test_cli_prints_the_masked_stream_on_every_exact_path():
    """condensed_over_active and auto evaluate the masked weights; auto
    prints its plan at the batch's bucket first."""
    _, masked = _cli("masked")
    for path in ("condensed_over_active", "auto"):
        out, text = _cli(path)
        if path == "auto":
            assert text[0].startswith("[plan] path=auto batch=2 (bucket 8) profile=h100-sxm")
            assert len([ln for ln in text if ln.startswith("[plan]   blocks/")]) == 4
        assert text[-2].startswith(f"[serve:{path}] prefill 2x8 in ")
        assert text[-1] == masked[-1] == f"[serve] first stream: {out[0, -6:].tolist()}"


def test_cli_structured_prints_the_masked_stream_of_its_ablation_only_masks():
    """The CLI's SRigL masks are not ablation-only, so structured (surviving
    columns dense) serves their ablation-only projection: its stream is the
    masked path's on masks with every active column filled."""
    out, text = _cli("structured")
    assert text[-2].startswith("[serve:structured] prefill 2x8 in ")
    cfg = tconfigs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)   # the CLI's --seed 0, drawn in its order
    reg = TR.build_registry(cfg)
    params = TM.init_params(cfg, gen, TR.k_fan_map(cfg, reg))
    masks = TR.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    only = {}
    for s in reg:
        m = TR.get_path(masks, s.path)
        TR.set_path(only, s.path, m.any(dim=-2, keepdim=True).expand(m.shape).contiguous())
    want = TE.generate(cfg, params, only, prompts, 6)
    assert text[-1] == f"[serve] first stream: {want[0, -6:].tolist()}"
    assert torch.equal(out, want)
