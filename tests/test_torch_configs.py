"""The port's configs, distributions and registry equal the reference's."""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import distributions as JD  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import distributions as TD  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_fields_equal_the_reference(getter):
    jc = getattr(jconfigs, getter)(ARCH)
    tc = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("vocab_padded", "n_heads_padded", "n_kv_heads_padded",
                 "head_to_kv", "q_dim", "kv_dim", "is_moe"):
        assert getattr(tc, prop) == getattr(jc, prop), prop


def test_ported_archs_are_reference_archs():
    assert set(tconfigs.ALL_ARCHS) <= set(jconfigs.ALL_ARCHS)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_registry_stacks_densities_and_fan_ins_equal(getter):
    jc = getattr(jconfigs, getter)(ARCH)
    tc = getattr(tconfigs, getter)(ARCH)
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in treg] == [(s.path, s.d_in, s.d_out, s.lead, s.density,
                                s.n_replicas, s.name) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_full_width_fan_ins():
    cfg = tconfigs.get_config(ARCH)
    assert TR.k_fan_map(cfg, TR.build_registry(cfg)) == {
        "wo": 293, "w_gate": 195, "w_up": 195, "w_down": 585}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_erk_and_uniform_densities_equal_on_random_layer_sets(seed, sparsity):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 8))
    dims = rng.integers(1, 4096, size=(n, 3))
    tl = [TD.LayerShape(f"l{i}", int(a), int(b), int(r % 4) + 1)
          for i, (a, b, r) in enumerate(dims)]
    jl = [JD.LayerShape(f"l{i}", int(a), int(b), int(r % 4) + 1)
          for i, (a, b, r) in enumerate(dims)]
    td, jd = TD.erk_densities(tl, sparsity), JD.erk_densities(jl, sparsity)
    assert td == jd
    assert TD.uniform_densities(tl, sparsity) == JD.uniform_densities(jl, sparsity)
    for l in tl:
        assert (TD.fan_in_from_density(l.d_in, td[l.name])
                == JD.fan_in_from_density(l.d_in, jd[l.name]))


def test_invalid_sparsity_raises_as_in_the_reference():
    with pytest.raises(ValueError):
        TD.erk_densities([TD.LayerShape("a", 4, 4)], 1.0)
    with pytest.raises(ValueError):
        JD.erk_densities([JD.LayerShape("a", 4, 4)], 1.0)


def test_unported_families_raise():
    # every family is ported: moe, ssm, hybrid (tests/test_torch_moe_model.py,
    # tests/test_torch_ssm.py, tests/test_torch_hybrid.py), audio and vit
    # (tests/test_torch_audio.py, tests/test_torch_vit.py); an unknown one
    # is refused as the reference refuses it
    cfg = tconfigs.get_smoke_config(ARCH).replace(family="hybrid", ssm_state=16,
                                                  hybrid_attn_every=1)
    assert [(s.name, s.lead) for s in TR.build_registry(cfg)] == [
        ("m_groups/in_z", (2, 1)), ("m_groups/in_x", (2, 1)), ("m_groups/out_proj", (2, 1)),
        ("shared_attn/wo", ()), ("shared_attn/w_gate", ()), ("shared_attn/w_up", ()),
        ("shared_attn/w_down", ())]
    assert [(s.name, s.lead) for s in TR.build_registry(cfg)] == [
        (s.name, s.lead) for s in JR.build_registry(
            jconfigs.get_smoke_config(ARCH).replace(family="hybrid", ssm_state=16,
                                                    hybrid_attn_every=1))]
    audio = tconfigs.get_smoke_config(ARCH).replace(family="audio", n_codebooks=4)
    assert [(s.name, s.lead) for s in TR.build_registry(audio)] == [
        (s.name, s.lead) for s in JR.build_registry(
            jconfigs.get_smoke_config(ARCH).replace(family="audio", n_codebooks=4))] == [
        (f"blocks/{n}", (audio.n_layers,)) for n in ("wo", "w_gate", "w_up", "w_down")]
    for reg in (TR, JR):
        with pytest.raises(ValueError):
            reg.build_registry(tconfigs.get_smoke_config(ARCH).replace(family="speech"))
    ssm = tconfigs.get_smoke_config(ARCH).replace(family="ssm", ssm_state=16)
    assert [s.path[-1] for s in TR.build_registry(ssm)] == ["in_z", "in_x", "out_proj"]


# the configs ported beyond qwen3-1.7b (its own cases are above; the MoE
# configs' fields and registries are held in tests/test_torch_moe_model.py)
NEW_ARCHS = ("internlm2-20b", "mistral-large-123b", "gemma3-1b", "qwen2-vl-7b")
MOE_ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
SSM_ARCHS = ("mamba2-130m",)  # fields and registry: tests/test_torch_ssm.py
HYBRID_ARCHS = ("zamba2-7b",)  # fields and registry: tests/test_torch_hybrid.py
# fields and registries: tests/test_torch_audio.py, tests/test_torch_vit.py
AUDIO_VIT_ARCHS = ("musicgen-medium", "vit-b16")


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_config_fields_equal_the_reference(arch, getter):
    jc = getattr(jconfigs, getter)(arch)
    tc = getattr(tconfigs, getter)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("vocab_padded", "n_heads_padded", "n_kv_heads_padded", "head_to_kv",
                 "q_dim", "kv_dim", "is_moe", "d_inner", "ssm_n_heads"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert [tc.window_for_layer(i) for i in range(tc.n_layers)] == [
        jc.window_for_layer(i) for i in range(jc.n_layers)]


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_registry_stacks_densities_and_fan_ins_equal(arch, getter):
    jc = getattr(jconfigs, getter)(arch)
    tc = getattr(tconfigs, getter)(arch)
    jreg, treg = JR.build_registry(jc), TR.build_registry(tc)
    assert [(s.path, s.d_in, s.d_out, s.lead, s.density, s.n_replicas, s.name)
            for s in treg] == [(s.path, s.d_in, s.d_out, s.lead, s.density,
                                s.n_replicas, s.name) for s in jreg]
    assert TR.k_fan_map(tc, treg) == JR.k_fan_map(jc, jreg)


def test_every_ported_arch_is_registered_with_the_references_shapes():
    assert set(tconfigs.ALL_ARCHS) == {ARCH, *NEW_ARCHS, *MOE_ARCHS, *SSM_ARCHS,
                                       *HYBRID_ARCHS, *AUDIO_VIT_ARCHS}
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS  # all eleven, in the reference's order
    assert [dataclasses.asdict(s) for s in tconfigs.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in jconfigs.ALL_SHAPES]
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in tconfigs.ALL_ARCHS:
        cfg = tconfigs.get_config(arch)
        got = tconfigs.shapes_for(arch, cfg.family, cfg.causal)
        want = jconfigs.shapes_for(arch, cfg.family, cfg.causal)
        assert [(s.name, s.seq_len, s.global_batch, s.kind, s.tokens) for s in got] == [
            (s.name, s.seq_len, s.global_batch, s.kind, s.tokens) for s in want], arch
    # the encoder-only and long-context branches, as the reference takes them
    for arch, family, causal in (("vit-b16", "vit", False), ("mamba2-130m", "ssm", True)):
        assert [s.name for s in tconfigs.shapes_for(arch, family, causal)] == [
            s.name for s in jconfigs.shapes_for(arch, family, causal)]


def test_full_width_fan_ins_of_the_new_configs():
    want = {"gemma3-1b": {"wo": 443, "w_gate": 113, "w_up": 113, "w_down": 680},
            "qwen2-vl-7b": {"wo": 622, "w_gate": 345, "w_up": 345, "w_down": 1824},
            "internlm2-20b": {"wo": 851, "w_gate": 585, "w_up": 585, "w_down": 1560},
            "mistral-large-123b": {"wo": 1638, "w_gate": 1170, "w_up": 1170, "w_down": 2731}}
    for arch, fans in want.items():
        cfg = tconfigs.get_config(arch)
        assert TR.k_fan_map(cfg, TR.build_registry(cfg)) == fans, arch


@pytest.mark.parametrize("family,kw", [("ssm", dict(ssm_state=16)), ("hybrid", dict(ssm_state=16)),
                                       ("audio", dict(n_codebooks=4)),
                                       ("vit", dict(causal=False))])
def test_other_unported_families_raise(family, kw):
    cfg = tconfigs.get_smoke_config(ARCH).replace(family=family, **kw)
    if family == "ssm":  # ported since item 8 step 5 (tests/test_torch_ssm*.py)
        assert [s.lead for s in TR.build_registry(cfg)] == [(cfg.n_layers,)] * 3
        return
    if family == "hybrid":  # ported since item 8 step 6 (tests/test_torch_hybrid*.py)
        # 2 layers at hybrid_attn_every 6: no group, two m_rem layers, and
        # the shared block's stacks with no leading axis, as in the reference
        assert [s.lead for s in TR.build_registry(cfg)] == [(0, 6)] * 3 + [(2,)] * 3 + [()] * 4
        assert [s.lead for s in TR.build_registry(cfg)] == [
            s.lead for s in JR.build_registry(jconfigs.get_smoke_config(ARCH).replace(
                family=family, **kw))]
        return
    # audio and vit: ported since item 8 steps 7-8 (tests/test_torch_audio.py,
    # tests/test_torch_vit.py); the dense family's blocks stacks
    assert [(s.name, s.lead, s.d_in, s.d_out, s.density) for s in TR.build_registry(cfg)] == [
        (s.name, s.lead, s.d_in, s.d_out, s.density) for s in JR.build_registry(
            jconfigs.get_smoke_config(ARCH).replace(family=family, **kw))]
    assert [s.lead for s in TR.build_registry(cfg)] == [(cfg.n_layers,)] * 4
