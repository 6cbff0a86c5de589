"""Quantized serving as a whole: the reference's smoke qwen3 weights bridged
into the port, served with int8 and fp8 values on ``condensed`` (90% masks),
``condensed_over_active`` (ablated masks), ``structured`` (ablation-only
masks, where it is exact) and ``auto`` (ablated masks). Greedy tokens must
equal the reference's and prefill logits agree within atol 1e-4 (float32).

Each side builds its plan with its own ``build_plan(..., values_dtype=)``
at the request's batch bucket; ``auto`` is priced on both sides at the
reference profile's rates, so that the two plans decide alike (a
quantized and a float stack are different functions).
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_smoke_model import ARCH, smoke_masks, smoke_model  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

GEN = 10
LOGIT_ATOL = 1e-4
PATH_MASKS = {"condensed": "plain", "condensed_over_active": "ablated",
              "structured": "ablation_only", "auto": "ablated"}
CASES = [(p, q) for p in PATH_MASKS for q in ("int8", "fp8")]
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})


@pytest.fixture(scope="module")
def run():
    """One JAX init (shared with the other quantized test files), then one
    plan and generate per (path, values dtype)."""
    m = smoke_model()
    jcfg, jreg, jparams = m["jcfg"], m["jreg"], m["jparams"]
    tcfg, treg, tparams = m["tcfg"], m["treg"], m["tparams"]
    jmasks = smoke_masks()
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    bucket = TP.batch_bucket(prompts.shape[0])
    tmasks = {k: bridge.from_jax_numpy(jax.tree.map(np.asarray, m)) for k, m in jmasks.items()}
    jplan, tplan, jtok, ttok = {}, {}, {}, {}
    for path, qdt in CASES:
        kind = PATH_MASKS[path]
        jplan[path, qdt] = JS.build_plan(jcfg, jreg, jparams, jmasks[kind], path,
                                         batch_size=bucket, values_dtype=qdt)
        tplan[path, qdt] = TP.build_plan(tcfg, treg, tparams, tmasks[kind], path=path,
                                         batch_size=bucket, values_dtype=qdt,
                                         profile=PROFILE if path == "auto" else
                                         TP.DEFAULT_PROFILE)
        jtok[path, qdt] = np.asarray(JE.generate(jcfg, jparams, jplan[path, qdt].serving_tree,
                                                 jnp.asarray(prompts), GEN))
        ttok[path, qdt] = TE.ServingModel(tcfg, tparams, tplan[path, qdt]).generate(
            torch.from_numpy(prompts), GEN).numpy()
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams, prompts=prompts,
                jplan=jplan, tplan=tplan, jtok=jtok, ttok=ttok)


@pytest.mark.parametrize("path,qdt", CASES)
def test_tokens_equal_the_reference(run, path, qdt):
    want = run["jtok"][path, qdt]
    assert want.shape == (3, 8 + GEN)
    np.testing.assert_array_equal(run["ttok"][path, qdt], want)
    jplan, tplan = run["jplan"][path, qdt], run["tplan"][path, qdt]
    assert tplan.values_dtype == jplan.values_dtype == qdt
    assert ({n: d.representation for n, d in tplan.decisions.items()}
            == {n: d.representation for n, d in jplan.decisions.items()})
    for leaf in jax.tree.leaves(tplan.serving_tree, is_leaf=lambda v: isinstance(
            v, TF.SparseFormat)):
        if isinstance(leaf, (TF.Condensed, TF.CondensedOverActive, TF.StructuredFanIn)):
            assert leaf.values.dtype == TF.VALUES_DTYPES[qdt] and leaf.scales is not None


@pytest.mark.parametrize("path,qdt", CASES)
def test_prefill_logits_agree(run, path, qdt):
    r = run
    b, t = r["prompts"].shape
    # the reference's jitted prefill at generate's cache length: the program
    # the fixture's generate already compiled
    jl, _ = JE._prefill(r["jcfg"], r["jparams"], r["jplan"][path, qdt].serving_tree,
                        {"tokens": jnp.asarray(r["prompts"])},
                        JM.init_cache(r["jcfg"], b, t + GEN))
    tl, _ = TM.prefill_step(r["tcfg"], r["tparams"], r["tplan"][path, qdt].serving_tree,
                            {"tokens": torch.from_numpy(r["prompts"])},
                            TM.init_cache(r["tcfg"], b, t + GEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)


def test_serving_model_keeps_the_plans_values_dtype(run):
    r = run
    plan = r["tplan"]["condensed", "fp8"]
    model = TE.ServingModel(r["tcfg"], r["tparams"], plan)
    assert model.values_dtype == "fp8" and model.serving is plan.serving_tree
    assert TE.ServingModel(r["tcfg"], r["tparams"], {}).values_dtype is None


def _cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TS.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--gen", "6", "--device", "cpu", *args])
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("qdt", ["int8", "fp8"])
def test_cli_serves_quantized_values_and_prints_their_bytes(qdt):
    out, text = _cli("--path", "condensed", "--values-dtype", qdt)
    cfg = tconfigs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)   # the CLI's --seed 0, drawn in its order
    reg = TR.build_registry(cfg)
    params = TM.init_params(cfg, gen, TR.k_fan_map(cfg, reg))
    masks = TR.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    plan = TS.build_plan(cfg, reg, params, masks, "condensed", batch_size=2, values_dtype=qdt)
    serving, masked = plan.weight_bytes()
    assert serving < masked
    assert text[0] == (f"[serve] values_dtype={qdt}: serving weight bytes {serving} "
                       f"({serving / masked:.3f}x of the masked-dense reference)")
    assert text[-2].startswith("[serve:condensed] prefill 2x8 in ")
    want = TE.generate(cfg, params, plan.serving_tree, prompts, 6)
    assert torch.equal(out, want)
    assert text[-1] == f"[serve] first stream: {want[0, -6:].tolist()}"


def test_cli_masked_notes_that_it_ignores_the_values_dtype():
    out, text = _cli("--path", "masked", "--values-dtype", "int8")
    assert text[0] == ("[serve] note: --path masked serves the live dense params; "
                       "--values-dtype int8 only affects exported value-storing formats "
                       "(condensed/structured paths or auto)")
    _, plain = _cli("--path", "masked")
    assert text[-1] == plain[-1] and torch.equal(out, _cli("--path", "masked")[0])
    assert not any("serving weight bytes" in ln for ln in text)


def test_cli_auto_prints_its_values_dtype_in_the_plan():
    _, text = _cli("--path", "auto", "--values-dtype", "fp8")
    assert text[0].startswith("[plan] path=auto batch=2 (bucket 8) profile=h100-sxm "
                              "values_dtype=fp8")
    assert any(ln.startswith("[serve] values_dtype=fp8: serving weight bytes ") for ln in text)
