"""The serving slice as a whole: the reference's smoke qwen3 weights and
masks, bridged into the port, give identical greedy tokens on the masked
and the condensed path, and matching logits (atol 1e-4, float32)."""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import condensed as JC  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.train import checkpoint as JCKPT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import condensed as TC  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

ARCH = "qwen3-1.7b"
GEN = 10
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_run():
    """One JAX init + export + generate per path, shared by every test."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    jreg = JR.build_registry(jcfg)
    jparams = JM.init_params(jcfg, key, JR.k_fan_map(jcfg, jreg))
    jmasks = JR.init_sparsity_state(jcfg, key, jreg)["masks"]
    jcond = JC.export_condensed(jcfg, jreg, jparams, jmasks)
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    jax_tokens = {
        "masked": np.asarray(JE.generate(jcfg, jparams, jmasks, jnp.asarray(prompts), GEN)),
        "condensed": np.asarray(JE.generate(jcfg, jparams, jcond, jnp.asarray(prompts), GEN)),
    }

    tcfg = tconfigs.get_smoke_config(ARCH)
    treg = TR.build_registry(tcfg)
    tparams = bridge.from_jax_numpy(jax.tree.map(np.asarray, jparams))
    tmasks = bridge.from_jax_numpy(jax.tree.map(np.asarray, jmasks))
    tcond = TC.export_condensed(tcfg, treg, tparams, tmasks)
    tprompts = torch.from_numpy(prompts)
    torch_tokens = {
        "masked": TE.generate(tcfg, tparams, tmasks, tprompts, GEN).numpy(),
        "condensed": TE.generate(tcfg, tparams, tcond, tprompts, GEN).numpy(),
    }
    return dict(jcfg=jcfg, jreg=jreg, jparams=jparams, jmasks=jmasks, jcond=jcond,
                tcfg=tcfg, treg=treg, tparams=tparams, tmasks=tmasks, tcond=tcond,
                prompts=prompts, jax_tokens=jax_tokens, torch_tokens=torch_tokens)


def test_four_token_streams_are_identical(slice_run):
    ref = slice_run["jax_tokens"]["masked"]
    assert ref.shape == (3, 8 + GEN)
    np.testing.assert_array_equal(ref[:, :8], slice_run["prompts"])
    for side in ("jax_tokens", "torch_tokens"):
        for path in ("masked", "condensed"):
            np.testing.assert_array_equal(slice_run[side][path], ref, err_msg=f"{side} {path}")


@pytest.mark.parametrize("path", ["masked", "condensed"])
def test_prefill_and_decode_logits_agree(slice_run, path):
    r = slice_run
    jserve = r["jmasks"] if path == "masked" else r["jcond"]
    tserve = r["tmasks"] if path == "masked" else r["tcond"]
    b, t = r["prompts"].shape
    jcache = JM.init_cache(r["jcfg"], b, t + 2)
    jl, jcache = JM.prefill_step(r["jcfg"], r["jparams"], jserve,
                                 {"tokens": jnp.asarray(r["prompts"])}, jcache)
    tcache = TM.init_cache(r["tcfg"], b, t + 2, device="cpu")
    tl, tcache = TM.prefill_step(r["tcfg"], r["tparams"], tserve,
                                 {"tokens": torch.from_numpy(r["prompts"])}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert tcache["len"] == int(jcache["len"]) == t
    np.testing.assert_allclose(tcache["blocks"]["k"].numpy(),
                               np.asarray(jcache["blocks"]["k"]), atol=1e-5, rtol=0)

    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl2, _ = JM.decode_step(r["jcfg"], r["jparams"], jserve, {"tokens": jnp.asarray(nxt)},
                            jcache)
    tl2, tcache = TM.decode_step(r["tcfg"], r["tparams"], tserve,
                                 {"tokens": torch.from_numpy(nxt)}, tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_ATOL, rtol=0)
    assert tcache["len"] == t + 1


def test_condensed_export_matches_reference(slice_run):
    r = slice_run
    for s in r["jreg"]:
        j = JR.get_path(r["jcond"], s.path)
        t = TR.get_path(r["tcond"], s.path)
        np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
        np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-6)
        assert t.d_in == j.d_in


def test_bridge_round_trips_the_reference_trees(slice_run):
    r = slice_run
    for tree in (r["jparams"], r["jmasks"]):
        want = JCKPT._flatten(jax.tree.map(np.asarray, tree))
        got = bridge.flatten(bridge.to_jax_numpy(bridge.from_jax_numpy(
            jax.tree.map(np.asarray, tree))))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    # a condensed serving tree flattens to the reference's value/index keys
    # (the reference also lists its unset quantization scales, as None)
    assert sorted(bridge.flatten(r["tcond"])) == sorted(
        k for k, v in JCKPT._flatten(r["jcond"]).items() if v is not None)


def test_bridge_accepts_flat_path_keys_and_bfloat16():
    flat = {"blocks/wq": np.ones((2, 3), np.float32),
            "embed": np.asarray(jnp.full((4,), 1.5, jnp.bfloat16))}
    tree = bridge.from_jax_numpy(flat)
    assert tree["blocks"]["wq"].shape == (2, 3)
    assert tree["embed"].dtype == torch.bfloat16
    assert tree["embed"].float().tolist() == [1.5] * 4


def test_init_params_layout_matches_reference(slice_run):
    r = slice_run
    g = torch.Generator().manual_seed(0)
    tparams = TM.init_params(r["tcfg"], g, TR.k_fan_map(r["tcfg"], r["treg"]))
    want = JCKPT._flatten(r["jparams"])
    got = bridge.flatten(tparams)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and str(got[k].dtype) == f"torch.{v.dtype}"
    # sparse layers at 1/sqrt(k), dense at 1/sqrt(d_in), embeddings at 0.02
    k_fan = TR.k_fan_map(r["tcfg"], r["treg"])
    assert got["blocks/w_down"].std().item() == pytest.approx(k_fan["w_down"] ** -0.5, rel=0.1)
    assert got["blocks/wq"].std().item() == pytest.approx(r["tcfg"].d_model ** -0.5, rel=0.1)
    assert got["embed"].std().item() == pytest.approx(0.02, rel=0.1)


def test_port_masks_are_constant_fan_in_at_the_registry_fan_ins(slice_run):
    from repro_torch.core import topology as TT
    r = slice_run
    g = torch.Generator().manual_seed(0)
    state = TR.init_sparsity_state(r["tcfg"], g, r["treg"])
    for s, (name, k) in zip(r["treg"], TR.k_fan_map(r["tcfg"], r["treg"]).items()):
        m = TR.get_path(state["masks"], s.path)
        assert m.shape == (*s.lead, s.d_in, s.d_out)
        assert TT.check_constant_fan_in(m, k)
        assert TR.get_path(state["neuron_active"], s.path).all()


def test_serving_model_keys_params_by_reference_paths(slice_run):
    r = slice_run
    model = TE.ServingModel(r["tcfg"], r["tparams"], r["tcond"])
    assert sorted(model.weights.keys()) == sorted(JCKPT._flatten(r["jparams"]))
    out = model.generate(torch.from_numpy(r["prompts"]), GEN)
    np.testing.assert_array_equal(out.numpy(), r["jax_tokens"]["condensed"])


def test_serving_copy_casts_once_with_identical_numbers(slice_run):
    """A bf16 serving copy gives bitwise the numbers of the per-call cast."""
    r = slice_run
    cfg = r["tcfg"].replace(dtype="bfloat16")
    served = TM.serving_params(cfg, r["tparams"])
    assert served["blocks"]["w_up"].dtype == torch.bfloat16
    assert served["embed"].dtype == torch.bfloat16
    assert served["blocks"]["ln1"].dtype == torch.float32  # norms read in f32
    cache = TM.init_cache(cfg, 3, 10, device="cpu")
    tokens = {"tokens": torch.from_numpy(r["prompts"])}
    once, _ = TM.prefill_step(cfg, served, r["tmasks"], tokens, cache)
    per_call, _ = TM.prefill_step(cfg, r["tparams"], r["tmasks"], tokens,
                                  TM.init_cache(cfg, 3, 10, device="cpu"))
    assert torch.equal(once, per_call)
    cond = TC.export_condensed(cfg, r["treg"], r["tparams"], r["tmasks"])
    assert TR.get_path(cond, ("blocks", "wo")).values.dtype == torch.bfloat16


def test_cli_prints_the_same_first_stream_for_both_paths():
    lines = {}
    for path in ("masked", "condensed"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = TS.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                           "--gen", "6", "--path", path, "--device", "cpu"])
        text = buf.getvalue().splitlines()
        assert text[0].startswith(f"[serve:{path}] prefill 2x8 in ")
        assert " | decode 2x6 in " in text[0]
        assert text[1] == f"[serve] first stream: {out[0, -6:].tolist()}"
        lines[path] = text[1]
    assert lines["masked"] == lines["condensed"]
