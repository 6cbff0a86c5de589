"""Planning without allocation (``launch/dryrun.py`` and the functions it
stands on) against the reference's, on the CPU.

The reference's ``repro.launch.dryrun`` forces 512 host devices when it is
imported, so it is never imported here: the port is held to the reference
functions the dry run calls (``plan.plan_for_shape``,
``plan.abstract_serving_tree``, each format's ``abstract``,
``engine.abstract_plan_key``, ``condensed.condensed_bytes``,
``pipeline.make_batch_spec``), exactly, for all eleven configs at their
published widths: these are static and build nothing. Within the port: the
meta-device params, caches, pools and cells hold the bytes the same tensors
hold when built for real on the CPU; every kernel wrapper's meta branch
gives its plain version's shape and dtype and launches nothing; the CLI
sweeps the zoo.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import condensed as JCond  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import condensed_matmul as cm  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels import structured_matmul as sm  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import condensed as TCond  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as TR  # noqa: E402

from _torch_zoo_model import _model  # noqa: E402

ARCHS = list(TC.ALL_ARCHS)
PROFILE = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                for f in dataclasses.fields(TP.HardwareProfile)})
REPS = ("masked", "condensed", "structured", "condensed_over_active")


def _regs(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    return jcfg, JR.build_registry(jcfg), tcfg, TR.build_registry(tcfg)


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# the static planning functions, at full width, exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plans_keys_and_bytes_equal_the_reference_at_full_width(arch):
    """``plan_for_shape`` at batches 1, 8 and 256, ``abstract_plan_key`` (its
    key and ``describe()``) at 1, 4 and 200 on every path, and
    ``condensed_bytes``."""
    jcfg, jreg, tcfg, treg = _regs(arch)
    for b in (1, 8, 256):
        assert TP.plan_for_shape(tcfg, treg, batch_size=b, profile=PROFILE) == \
            JP.plan_for_shape(jcfg, jreg, batch_size=b)
    for b in (1, 4, 200):
        for path in ("auto",) + REPS:
            jkey, jreps = JE.abstract_plan_key(jcfg, jreg, b, path=path)
            tkey, treps = TE.abstract_plan_key(tcfg, treg, b, path=path, profile=PROFILE)
            assert (tkey.batch_bucket, tkey.formats, tkey.tp) == \
                (jkey.batch_bucket, jkey.formats, jkey.tp)
            assert tkey.describe() == jkey.describe() and treps == jreps
    assert TCond.condensed_bytes(tcfg, treg) == JCond.condensed_bytes(jcfg, jreg)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_serving_trees_equal_the_reference_at_full_width(arch):
    """For every representation, each leaf's format and each field's shape
    and dtype are the reference's ``ShapeDtypeStruct``s, the static fields
    too; every tensor lies on the meta device. ``abstract_condensed`` is the
    condensed tree."""
    jcfg, jreg, tcfg, treg = _regs(arch)
    for rep in REPS:
        jtree = JP.abstract_serving_tree(jcfg, jreg, {s.name: rep for s in jreg})
        ttree = TP.abstract_serving_tree(tcfg, treg, {s.name: rep for s in treg})
        for js, ts in zip(jreg, treg):
            jl, tl = JR.get_path(jtree, js.path), TR.get_path(ttree, ts.path)
            assert type(tl).__name__ == type(jl).__name__ and tl.format_name == rep
            fields = {f: getattr(jl, f) for f in type(jl)._array_fields
                      if getattr(jl, f, None) is not None}
            assert set(tl.arrays()) == set(fields)
            for f, a in fields.items():
                t = getattr(tl, f)
                assert t.device.type == "meta"
                assert (tuple(t.shape), _dtype(t)) == (tuple(a.shape), str(a.dtype)), f
            for f in type(tl)._static_fields:
                assert getattr(tl, f) == getattr(jl, f), f
    cond = TCond.abstract_condensed(tcfg, treg)
    jcond = JCond.abstract_condensed(jcfg, jreg)
    for js, ts in zip(jreg, treg):
        assert tuple(TR.get_path(cond, ts.path).values.shape) == \
            tuple(JR.get_path(jcond, js.path).values.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch):
    """``make_batch_spec`` for each of the config's shapes: the same keys,
    shapes and dtypes, as meta tensors."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for shape in TC.shapes_for(arch, tcfg.family, tcfg.causal):
        jb = JD.make_batch_spec(jcfg, JC.SHAPES[shape.name])
        tb = TD.make_batch_spec(tcfg, shape)
        assert sorted(tb) == sorted(jb)
        for k, v in jb.items():
            assert tb[k].device.type == "meta"
            assert (tuple(tb[k].shape), _dtype(tb[k])) == (tuple(v.shape), str(v.dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_caches_and_pools_have_the_reference_shapes(arch):
    """``init_params`` on the meta device (nothing drawn), and the cache
    and pool, give the reference's abstract shapes and dtypes at full
    width."""
    jcfg, jreg, tcfg, treg = _regs(arch)
    jp = jax.eval_shape(lambda k: JM.init_params(jcfg, k, JR.k_fan_map(jcfg, jreg)),
                        jax.random.PRNGKey(0))
    tp = DR.abstract_params(tcfg, treg)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {"/".join(path): t for path, t in _flat(tp)}
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        assert tflat[k].device.type == "meta"
        assert (tuple(tflat[k].shape), _dtype(tflat[k])) == (tuple(v.shape), str(v.dtype)), k
    if tcfg.causal:
        jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 64))
        tc = TM.init_cache(tcfg, 2, 64, DR.META)
        assert DR.tree_bytes(tc) == sum(int(np.prod(v.shape)) * v.dtype.itemsize
                                        for v in jax.tree.leaves(jc))
        if TM.supports_paged(tcfg):
            jpool = jax.eval_shape(lambda: JM.init_paged_pool(jcfg, 9, 16))
            tpool = TM.init_paged_pool(tcfg, 9, 16, DR.META)
            for k in ("pk", "pv"):
                assert (tuple(tpool[k].shape), _dtype(tpool[k])) == \
                    (tuple(jpool[k].shape), str(jpool[k].dtype))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# against the port's own engine and plan on smoke models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "zamba2-7b"])
def test_static_keys_equal_the_engine_and_the_plan_without_ablation(arch):
    """On the SRigL masks of a smoke model (no neuron ablated) the static
    key is the engine's ``plan_key`` and ``plan_for_shape`` is
    ``build_plan(path="auto")``'s decisions, at buckets 1, 8 and 128."""
    m = _model(arch, ())
    eng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"], path="auto",
                           profile=PROFILE)
    for b in (1, 8, 128):
        key, reps = TE.abstract_plan_key(m["tcfg"], m["treg"], b, profile=PROFILE)
        assert key == eng.plan_key(b)
        plan = TP.build_plan(m["tcfg"], m["treg"], m["tparams"], m["tmasks"], batch_size=b,
                             path="auto", profile=PROFILE)
        assert TP.plan_for_shape(m["tcfg"], m["treg"], batch_size=b, profile=PROFILE) == \
            {s.name: plan.representation_of(s.name) for s in m["treg"]} == reps


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------

def _inputs(device, e=None, b=3, d_in=40, n=24, k=5, a=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    lead = () if e is None else (e,)
    x = torch.randn((*lead, b, d_in), generator=g).to(dtype)
    values = torch.randn((*lead, n, k), generator=g).to(dtype)
    idx = torch.randint(0, d_in, (*lead, n, k), generator=g, dtype=torch.int32)
    w = torch.randn((*lead, d_in, n), generator=g).to(dtype)
    ai = torch.sort(torch.randperm(n, generator=g)[:a]).values.to(torch.int32)
    ai = ai.expand(*lead, a).contiguous()
    oi = ai.clone()
    scales = torch.rand((*lead, n), generator=g) + 0.5
    codes = torch.randint(-127, 128, (*lead, n, k), generator=g, dtype=torch.int8)
    dy = torch.randn((*lead, b, n), generator=g).to(dtype)
    return {key: t.to(device) for key, t in dict(
        x=x, values=values, idx=idx, w=w, ai=ai, oi=oi, scales=scales, codes=codes,
        dy=dy, cv=values[..., :a, :].contiguous(), ci=idx[..., :a, :].contiguous(),
        ccodes=codes[..., :a, :].contiguous(), cscales=scales[..., :a].contiguous()).items()}


CALLS = {
    "K1": lambda t: cm.condensed_matmul(t["x"], t["values"], t["idx"]),
    "K1-tiled": lambda t: cm.condensed_matmul(t["x"], t["values"], t["idx"], block_b=8),
    "K2": lambda t: cm.condensed_matmul(t["x"], t["codes"], t["idx"], scales=t["scales"]),
    "K3": lambda t: cm.condensed_matmul_dw(t["dy"], t["x"], t["idx"]),
    "K4": lambda t: sm.condensed_over_active_matmul(t["x"], t["cv"], t["ci"], t["oi"], 24),
    "K2-coa": lambda t: sm.condensed_over_active_matmul(t["x"], t["ccodes"], t["ci"], t["oi"],
                                                        24, scales=t["cscales"]),
    "K5": lambda t: sm.structured_matmul(t["x"], t["w"], t["ai"], prefetch_gather=False),
    "K5-tiled": lambda t: sm.structured_matmul(t["x"], t["w"], t["ai"], block_b=32),
    "K6": lambda t: sm.structured_matmul_prefetch(t["x"], t["w"], t["ai"]),
}
GROUPED = {
    "K1-moe": lambda t: cm.condensed_matmul_grouped(t["x"], t["values"], t["idx"]),
    "K2-moe": lambda t: cm.condensed_matmul_grouped(t["x"], t["codes"], t["idx"],
                                                    scales=t["scales"]),
    "K3-moe": lambda t: cm.condensed_matmul_dw_grouped(t["dy"], t["x"], t["idx"]),
    "K4-moe": lambda t: sm.condensed_over_active_matmul_grouped(t["x"], t["cv"], t["ci"],
                                                                t["oi"], 24),
    "K2-coa-moe": lambda t: sm.condensed_over_active_matmul_grouped(
        t["x"], t["ccodes"], t["ci"], t["oi"], 24, scales=t["cscales"]),
    "K5-moe": lambda t: sm.structured_matmul_grouped(t["x"], t["w"], t["ai"],
                                                     prefetch_gather=False),
    "K6-moe": lambda t: sm.structured_matmul_prefetch_grouped(t["x"], t["w"], t["ai"]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CALLS) + list(GROUPED))
def test_each_wrapper_meta_branch_gives_the_plain_shape_and_launches_nothing(name, dtype):
    """The meta branch returns a meta tensor of the plain version's shape
    and dtype, allocates its workspace on the meta device, and counts no
    launch."""
    fn, e = (CALLS[name], None) if name in CALLS else (GROUPED[name], 2)
    want = fn(_inputs("cpu", e=e, dtype=dtype))
    with counters.recording() as tally, DR.MetaMemory() as mem:
        got = fn(_inputs("meta", e=e, dtype=dtype))
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert tally == {}
    assert mem.peak >= got.numel() * got.element_size()


def test_workspace_sizes_follow_the_cuda_sources():
    """The meta branches' workspaces: K3's int32 groups and K5/K6's float32
    output region, at the sizes the CUDA sources' size functions give."""
    assert cm.dw_workspace_ints(256, 32, 5) == 2 * (16 * 5 + 2 * 16 + 1)
    assert cm.dw_workspace_ints(129, 17, 1) == 2 * (16 + 2 * 16 + 1)
    assert sm._out_bytes(1, 3, 24, 16, torch.bfloat16, 8) == 3 * 24 * 2
    assert sm._out_bytes(2, 3, 24, 40, torch.float32, 2) == (2 * 3 * 24 * 4 + 15) // 16 * 16 \
        + 2 * 2 * 2 * 4


# ---------------------------------------------------------------------------
# cells: bytes equal the same tensors built for real
# ---------------------------------------------------------------------------

def _real_bytes(*trees) -> int:
    return DR.tree_bytes(*trees)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "gemma3-1b"])
def test_zoo_cell_bytes_equal_the_same_tensors_built_on_the_cpu(arch):
    """A smoke ``serve_zoo`` cell's params, serving tree, cache or pool and
    batch bytes are those of the same inputs built on the CPU: the params
    drawn, the tree exported from them (at the target fan-in, the
    reference's abstract param dtype), the pool or cache allocated."""
    cell = DR.run_zoo_cell(arch, smoke=True, quiet=True)
    cfg = TC.get_smoke_config(arch)
    reg = TR.build_registry(cfg)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), TR.k_fan_map(cfg, reg))
    assert cell["params_bytes"] == _real_bytes(params)
    masks = TR.init_sparsity_state(cfg, torch.Generator().manual_seed(1), reg)["masks"]
    tree = {}
    for s in reg:
        rep = cell["formats"][s.name]
        leaf = TP._build_leaf(rep, TR.get_path(params, s.path), TR.get_path(masks, s.path),
                              TCond.export_stats(reg, masks)[s.name],
                              getattr(torch, cfg.param_dtype))
        TR.set_path(tree, s.path, leaf)
    assert cell["tree_bytes"] == _real_bytes(tree)
    b, t = cell["batch"], cell["seq_len"]
    if TM.supports_paged(cfg):
        nb = -(-(t + DR.BLOCK_SIZE) // DR.BLOCK_SIZE)
        pool = TM.init_paged_pool(cfg, b * nb, DR.BLOCK_SIZE, "cpu")
        assert cell["cache_bytes"] == _real_bytes(pool) + 4 * b * nb + 4 * b
    else:
        assert cell["cache_bytes"] == _real_bytes(TM.init_cache(cfg, b, t, "cpu"))
    assert cell["batch_bytes"] == 4 * b
    assert cell["argument_bytes"] == sum(cell[f"{k}_bytes"] for k in
                                         ("params", "tree", "cache", "batch"))
    assert cell["peak_bytes"] >= cell["argument_bytes"]


def test_train_cell_bytes_equal_a_real_train_state():
    """A smoke ``train`` cell (one meta trainer step) holds the bytes of a
    real ``TrainState`` and batch built on the CPU, and its outputs the
    same state again."""
    from repro_torch.train.state import init_train_state
    cfg = TC.get_smoke_config("qwen3-1.7b")
    shape = dataclasses.replace(TC.SHAPES["train_4k"], seq_len=16, global_batch=2)
    cell = {"arch": cfg.name}
    DR.train(cfg, shape, cell)
    st = init_train_state(cfg, torch.Generator().manual_seed(0))
    for part in ("params", "opt_state", "masks", "neuron_active", "grad_accum"):
        assert cell[f"{part}_bytes"] == _real_bytes(getattr(st, part)), part
    assert cell["batch_bytes"] == 2 * 2 * 16 * 4
    assert cell["output_bytes"] >= _real_bytes(st.params, st.opt_state)
    assert cell["peak_bytes"] > cell["argument_bytes"]


def test_the_cli_sweeps_the_zoo_and_refuses_what_is_not_ported(capsys, tmp_path):
    out = tmp_path / "cells.jsonl"
    assert DR.main(["--program", "serve_zoo", "--arch", "all", "--smoke",
                    "--out", str(out)]) == 0
    assert f"{len(ARCHS)} zoo cells OK, 0 failed" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == len(ARCHS)
    for argv, item in ((["--program", "dst"], 12), (["--program", "serve_tp"], 9),
                       (["--multi-pod"], 9), (["--both-meshes"], 9), (["--roofline"], 12)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            DR.main(argv)
    assert DR.main(["--arch", "mamba2-130m", "--program", "serve", "--shapes",
                    "decode_32k"]) == 0
    assert "1 cells OK, 0 failed" in capsys.readouterr().out
