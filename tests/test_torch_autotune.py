"""The launch-configuration search (``repro_torch.sparse.autotune``), the
formats' tuning keys and the kernel wrappers' reads of the cache, on the
CPU at small shapes, held to the reference (``repro.sparse.autotune``).

The keys equal the reference's letter for letter (``shape_tuning_key`` for
every kind, itemsize and values dtype; each format's ``tuning_key`` and
``spec_tuning_key`` on leaves exported from the same masks), but for one
standing divergence: a quantized key names the compute dtype after the
values' (``wint8-xbf16`` where the reference writes ``wint8``), so an entry
tuned in bf16 is never read by an f32 run, which launches its default. So
do ``tune_registry``'s labels and written keys on the reference's three cases
and ``ServingEngine.autotune``'s labels on the smoke config (the
reference's timed searches replaced by stubs that write its keys; the
port's search runs, each candidate the plain version). The winner is its
table's argmin; the cache survives a reload, keeps its profiles and never
touches the reference's file; ``kernels.ops`` passes a cached launch to
the wrapper, a forced one wins and a half-forced pair reads no cache;
every candidate keeps ``gather_geometry``'s reduction order, fits shared
memory and lists the wrapper's default launch first; the serve CLI's
``--autotune`` prints its lines and the same stream.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import types  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.sparse import autotune as JAT  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import condensed_matmul as cm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import structured_matmul as sm  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402
from repro_torch.sparse.plan import batch_bucket  # noqa: E402

from _torch_autotune_stubs import _stub_reference_search, caches  # noqa: E402,F401
from _torch_smoke_model import smoke_masks, smoke_model  # noqa: E402


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

COMPUTE = {2: torch.bfloat16, 4: torch.float32}  # the compute dtype of an itemsize
DENSE = TC.get_smoke_config("qwen3-1.7b")  # tune_registry's cfg: no stack holds experts


def _port_key(ref_key: str, dtype: torch.dtype) -> str:
    """The reference's key as the port writes it: a quantized width names
    the compute dtype too (a float key is the reference's as it is)."""
    return re.sub(r"/w(int8|fp8)/", lambda m: f"/w{m[1]}-x{F.dtype_name(dtype)}/", ref_key)


@pytest.mark.parametrize("values_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kind,scatter", [("condensed", None), ("coa", 96), ("structured", 96)])
def test_shape_tuning_key_equals_the_reference(monkeypatch, kind, scatter, itemsize,
                                               values_dtype):
    dtype = COMPUTE[itemsize]
    for batch in (1, 2, 8, 9, 32, 100, 512, 3000, 9000):
        want = JF.shape_tuning_key(48, 80, 5, batch, backend="cpu", itemsize=itemsize,
                                   kind=kind, scatter_width=scatter, values_dtype=values_dtype)
        got = F.shape_tuning_key(48, 80, 5, batch, backend="cpu", itemsize=itemsize,
                                 kind=kind, scatter_width=scatter, values_dtype=values_dtype,
                                 compute_dtype=dtype)
        assert got == _port_key(want, dtype)
        if values_dtype is None:  # float keys: the reference's, byte for byte
            assert got == want and "-x" not in got
        else:
            assert f"/w{values_dtype}-x{'bf16' if itemsize == 2 else 'f32'}/" in got
    if values_dtype is not None:  # a quantized key without its compute dtype
        with pytest.raises(ValueError, match="compute_dtype"):
            F.shape_tuning_key(48, 80, 5, 1, backend="cpu", values_dtype=values_dtype)
    # backend None names the card, as resolve_device does: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.shape_tuning_key(48, 80, 5, 1, itemsize=itemsize)


def _masks(ablation_only: bool, seed: int = 0) -> np.ndarray:
    """A (2, 24, 40) stacked mask: a random fan-in per column, or all-True
    columns (ablation-only), with the last 13 columns of layer 0 and 7 of
    layer 1 ablated."""
    rng = np.random.default_rng(seed)
    m = np.ones((2, 24, 40), bool) if ablation_only else rng.random((2, 24, 40)) < 0.3
    m[0, :, -13:] = False
    m[1, :, -7:] = False
    return m


@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("ablation_only", [False, True])
def test_format_tuning_keys_equal_the_reference(quantize, ablation_only):
    mask = _masks(ablation_only)
    w = np.random.default_rng(1).standard_normal(mask.shape).astype(np.float32)
    jw, jm = jnp.asarray(w), jnp.asarray(mask)
    tw, tm = torch.from_numpy(w), torch.from_numpy(mask)
    tstats = F.realized_stats(tm)
    jstats = JF.ExportStats(*tstats)
    stack = types.SimpleNamespace(name="s", d_in=24, d_out=40)
    classes = [(JF.Condensed, F.Condensed), (JF.CondensedOverActive, F.CondensedOverActive),
               (JF.MaskedDense, F.MaskedDense)]
    if ablation_only:
        classes.append((JF.StructuredFanIn, F.StructuredFanIn))
    for jcls, tcls in classes:
        q = {} if jcls is JF.MaskedDense else {"quantize_spec": quantize}
        jleaf = jcls.export_from_dense(jw, jm, jstats, **q)
        tleaf = tcls.export_from_dense(tw, tm, tstats, **q)
        for itemsize in (2, 4):
            dtype = COMPUTE[itemsize]
            jspec = JF.spec_for_stack(stack, jstats, itemsize, quantize)
            tspec = F.spec_for_stack(stack, tstats, itemsize, quantize)
            for batch in (1, 4, 30, 200):
                want = jleaf.tuning_key(batch, backend="cpu")
                if want is not None:
                    want = _port_key(want, dtype)
                assert tleaf.tuning_key(batch, backend="cpu", dtype=dtype) == want
                # the leaf's device: the CPU
                assert tleaf.tuning_key(batch, dtype=dtype) == want
                got = tcls.spec_tuning_key(tspec, batch, backend="cpu", dtype=dtype)
                ref = jcls.spec_tuning_key(jspec, batch, backend="cpu")
                assert got == (None if ref is None else _port_key(ref, dtype))
        if jcls is JF.MaskedDense:
            assert tleaf.tuning_key(4) is None and tcls.spec_tuning_key(tspec, 4) is None


# ---------------------------------------------------------------------------
# tune_registry and the engine: labels and keys
# ---------------------------------------------------------------------------

# the reference's tests/test_autotune.py cases: (d_in, d_out, k, max_active,
# active_fraction, min_fan_in) and the labels tuned
REGISTRY_CASES = (
    ((48, 96, 4, 64, 0.66, 4), {"s", "s@a64"}),
    ((48, 96, 48, 64, 0.66, 48), {"s", "s@a64", "s@structured"}),
    ((32, 80, 4, 80, 1.0, 4), {"s"}),
)


@pytest.mark.parametrize("dtype,values_dtype", [(torch.float32, None),
                                                (torch.bfloat16, None),
                                                (torch.float32, "int8")])
@pytest.mark.parametrize("case,labels", REGISTRY_CASES)
def test_tune_registry_labels_and_keys_equal_the_reference(caches, monkeypatch, case, labels,
                                                           dtype, values_dtype):
    _stub_reference_search(monkeypatch)
    d_in, d_out, k, a, frac, min_fan_in = case
    stack = types.SimpleNamespace(name="s", d_in=d_in, d_out=d_out)
    tstats = {"s": F.ExportStats(k, a, frac, min_fan_in)}
    jstats = {"s": JF.ExportStats(k, a, frac, min_fan_in)}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jout = JAT.tune_registry([stack], jstats, batch=1, dtype=jdt, reps=1,
                             values_dtype=values_dtype)
    tout = AT.tune_registry([stack], tstats, cfg=DENSE, batch=1, dtype=dtype, reps=1,
                            device="cpu", values_dtype=values_dtype)
    assert set(jout) == set(tout) == labels
    keys = set(json.loads(caches[0].read_text())["kernels"])
    assert keys == {_port_key(key, dtype)
                    for key in json.loads(caches[1].read_text())["kernels"]}
    assert keys == {r.key for r in tout.values()}
    # the entries sit under the keys the formats derive, as ops reads them
    spec = F.spec_for_stack(stack, tstats["s"], torch.empty((), dtype=dtype).element_size(),
                            values_dtype)
    assert AT.lookup_entry(F.Condensed.spec_tuning_key(spec, 1, backend="cpu",
                                                       dtype=dtype)) is not None
    for r in tout.values():
        assert r.plain and r.us == min(r.table.values()) and r.speedup_vs_default >= 1.0
    # a second pass finds every key cached and times nothing
    assert AT.tune_registry([stack], tstats, cfg=DENSE, batch=1, dtype=dtype, reps=1,
                            device="cpu", values_dtype=values_dtype) == {}
    with pytest.raises(NotImplementedError, match="item 9"):
        AT.tune_registry([stack], tstats, cfg=DENSE, batch=1, tp=2, device="cpu")


@pytest.mark.parametrize("masks", ["plain", "ablation_only"])
def test_engine_autotune_returns_the_reference_engine_labels(caches, monkeypatch, masks):
    _stub_reference_search(monkeypatch)
    m = smoke_model()
    jmasks = smoke_masks()[masks]
    tmasks = bridge.from_jax_numpy({"blocks": {k: np.array(v)
                                               for k, v in jmasks["blocks"].items()}})
    jeng = JE.ServingEngine(m["jcfg"], m["jparams"], jmasks, m["jreg"], path="auto")
    teng = TE.ServingEngine(m["tcfg"], m["tparams"], tmasks, m["treg"], path="auto")
    jout = jeng.autotune(2)
    tout = teng.autotune(2, reps=1)
    assert set(tout) == set(jout)
    assert set(json.loads(caches[0].read_text())["kernels"]) == \
        set(json.loads(caches[1].read_text())["kernels"])
    if masks == "ablation_only":
        assert any(name.endswith("@structured") for name in tout)


@pytest.mark.parametrize("path,masks", [("condensed", "plain"),
                                        ("condensed_over_active", "ablated"),
                                        ("structured", "ablation_only")])
def test_engine_serves_the_launches_autotune_wrote(caches, monkeypatch, path, masks):
    """What ``autotune`` writes under the formats' ``spec_tuning_key`` is
    what the kernel wrappers read at serving shapes: every decode launch of
    a tuned shape takes its winner."""
    m = smoke_model()
    jmasks = smoke_masks()[masks]
    tmasks = bridge.from_jax_numpy({"blocks": {k: np.array(v)
                                               for k, v in jmasks["blocks"].items()}})
    eng = TE.ServingEngine(m["tcfg"], m["tparams"], tmasks, m["treg"], path=path)
    tuned = eng.autotune(2, reps=1)
    assert tuned
    # the tuned launch by (kind, d_in, rows, output width): rows the
    # kernel's values rows (K1, K4) or its padded active columns (K5)
    winners = {}
    for res in tuned.values():
        d_in, rows = map(int, re.search(r"/d(\d+)/n(\d+)/", res.key).groups())
        scatter = re.search(r"/(coa|structured)-o(\d+)$", res.key)
        shape = ("condensed", d_in, rows, None) if scatter is None else \
            (scatter[1], d_in, rows, int(scatter[2]))
        winners[shape] = (res.block_b, res.block_n)
    seen = []

    def spy(module, name, kind, shape_of):
        real = getattr(module, name)

        def call(x, *a, **kw):
            if batch_bucket(x.shape[0]) == batch_bucket(2):  # a decode step at B = 2's bucket
                seen.append(((kind, x.shape[1], *shape_of(a)),
                             (kw.get("block_b"), kw.get("block_n"))))
            return real(x, *a, **kw)
        monkeypatch.setattr(module, name, call)
    spy(cm, "condensed_matmul", "condensed", lambda a: (a[0].shape[0], None))
    spy(sm, "condensed_over_active_matmul", "coa", lambda a: (a[0].shape[0], a[3]))
    spy(sm, "structured_matmul", "structured", lambda a: (a[1].shape[0], a[0].shape[1]))
    spy(sm, "structured_matmul_pregathered", "structured", lambda a: (a[1].shape[0], a[2]))
    prompts = torch.randint(0, m["tcfg"].vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    rid = eng.submit(prompts, 3)
    eng.step()
    eng.retire(rid)
    served = {shape for shape, _ in seen}
    assert served and served <= set(winners)
    for shape, launch in seen:
        assert launch == winners[shape], shape


# ---------------------------------------------------------------------------
# the search and its cache
# ---------------------------------------------------------------------------


def test_searches_without_a_device_need_a_card(caches, monkeypatch):
    """device=None means the card: with none the searches and their keys
    raise, as every entry point does, and nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stack = types.SimpleNamespace(name="s", d_in=48, d_out=96)
    calls = (lambda: AT.device_key(),
             lambda: AT.lookup_blocks(8, 64, 48, 3),
             lambda: AT.gather_operands(8, 64, 48, 3),
             lambda: AT.structured_operands(8, 64, 128, 48),
             lambda: AT.autotune_blocks(8, 64, 48, 3, reps=1),
             lambda: AT.autotune_coa_blocks(8, 64, 24, 3, 48, reps=1),
             lambda: AT.autotune_structured_blocks(8, 64, 128, 48, reps=1),
             lambda: AT.tune_registry([stack], {"s": F.ExportStats(4, 64, 0.66, 4)}, cfg=DENSE,
                                      batch=1, reps=1))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not caches[0].exists()
    assert AT.device_key("cpu") == "cpu"


def test_winner_is_the_argmin_of_its_table(caches, monkeypatch):
    cands = cm.gather_candidates(8, 64, 48, torch.float32, sm_count=cm.DEFAULT_SM_COUNT)
    # the third candidate is fastest, the baseline slowest
    times = iter([9.0, 5.0, 1.0] + [7.0] * (len(cands) - 3))
    with monkeypatch.context() as mp:
        mp.setattr(AT, "_time_us", lambda *a, **k: next(times))
        res = AT.autotune_blocks(5, 64, 48, 3, device="cpu")
    assert (res.block_b, res.block_n) == cands[2]
    assert res.us == 1.0 and res.default_us == 9.0 and res.speedup_vs_default == 9.0
    assert list(res.table) == [AT._label(*c) for c in cands]
    assert res.key == "cpu/w32/d64/n48/k3/b8"
    # timed for real: the argmin, never slower than the baseline
    for res in (AT.autotune_blocks(30, 64, 48, 3, device="cpu", reps=1),
                AT.autotune_coa_blocks(2, 64, 24, 3, 48, device="cpu", reps=1,
                                       values_dtype="fp8"),
                AT.autotune_structured_blocks(100, 64, 128, 48, device="cpu", reps=1)):
        assert res.us == min(res.table.values()) and res.table[res.label] == res.us
        assert res.default_us == next(iter(res.table.values()))
        assert res.speedup_vs_default >= 1.0


def test_cache_survives_a_reload_and_keeps_its_profiles(caches):
    port, ref = caches
    port.write_text(json.dumps({"version": 1, "profiles": {"cpu": {"name": "p"}}}))
    assert AT.lookup_blocks(8, 64, 48, 3, backend="cpu") is None
    res = AT.autotune_blocks(8, 64, 48, 3, device="cpu", reps=1)
    AT.reset_cache_state()
    on_disk = json.loads(port.read_text())
    assert on_disk["profiles"] == {"cpu": {"name": "p"}}
    assert on_disk["kernels"][res.key]["default"] == next(iter(res.table))
    assert AT.lookup_blocks(5, 64, 48, 3, backend="cpu") == {"block_b": res.block_b,
                                                             "block_n": res.block_n}
    assert AT.lookup_entry(None) is None
    assert AT.cached_profile("cpu") == {"name": "p"}
    assert not ref.exists()
    # a structured entry names no block_n
    s = AT.autotune_structured_blocks(8, 64, 128, 48, device="cpu", reps=1)
    assert AT.lookup_entry(s.key)["block_n"] is None


def _recording(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append((kw.get("block_b"), kw.get("block_n")))
        return real(*a, **kw)
    monkeypatch.setattr(module, name, spy)
    return seen


def _store(key, block_b, block_n):
    AT._load()["kernels"][key] = {"block_b": block_b, "block_n": block_n}


def test_ops_pass_the_cached_launch_to_the_wrappers(caches, monkeypatch):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g)           # 15 rows: bucket 32
    v = torch.randn(48, 4, generator=g)
    i = torch.randint(0, 64, (48, 4), generator=g, dtype=torch.int32)
    seen = _recording(monkeypatch, cm, "condensed_matmul")
    want = ops.condensed_linear_nd(x, v, i)
    assert seen == [(None, None)]                     # no entry: the default
    _store(F.shape_tuning_key(64, 48, 4, 15, backend="cpu"), 8, 32)
    assert torch.equal(ops.condensed_linear_nd(x, v, i), want)
    assert seen[-1] == (8, 32)
    x2 = x.reshape(-1, 64)
    ops.condensed_linear(x2, v, i, 2)                 # a forced block_b wins, alone
    ops.condensed_linear(x2, v, i, None, 16)          # a half-forced pair reads no cache
    assert seen[-2:] == [(2, None), (None, 16)]
    # autograd reads it too
    xg = x2.clone().requires_grad_(True)
    ops.condensed_linear(xg, v, i).sum().backward()
    assert seen[-1] == (8, 32)
    # quantized values read the quantized key
    q, s = F.quantize_values(v, "int8")
    ops.condensed_linear_nd(x, q, i, scales=s)
    assert seen[-1] == (None, None)
    _store(F.shape_tuning_key(64, 48, 4, 15, backend="cpu", values_dtype="int8",
                              compute_dtype=torch.float32), 4, 16)
    ops.condensed_linear_nd(x, q, i, scales=s)
    assert seen[-1] == (4, 16)
    # an entry the launch does not take raises, never clamped
    _store(F.shape_tuning_key(64, 48, 4, 15, backend="cpu"), 8, 12)
    with pytest.raises(ValueError, match="block_n must be one of"):
        ops.condensed_linear_nd(x, v, i)

    # condensed over active rows (coa keys) and structured (block_b only)
    coa = _recording(monkeypatch, sm, "condensed_over_active_matmul")
    oi = torch.arange(48, dtype=torch.int32)
    _store(F.shape_tuning_key(64, 48, 4, 15, backend="cpu", kind="coa", scatter_width=96),
           None, 8)
    ops.condensed_over_active_linear_nd(x, v, i, oi, 96)
    assert coa == [(None, 8)]
    st = _recording(monkeypatch, sm, "structured_matmul")
    w = torch.randn(64, 96, generator=g)
    ai = torch.arange(128, dtype=torch.int32).clamp(max=96)
    ops.structured_linear_nd(x, w, ai)
    _store(F.shape_tuning_key(64, 128, 0, 15, backend="cpu", kind="structured",
                              scatter_width=96), 8, None)
    ops.structured_linear_nd(x, w, ai)
    assert st == [(None, None), (8, None)]
    pre = _recording(monkeypatch, sm, "structured_matmul_pregathered")
    ops.structured_gathered_linear_nd(x, w[:, :128].clone(), ai[:96].clone(), 96)
    assert pre == [(None, None)]


def test_a_quantized_entry_tuned_in_bf16_is_not_read_by_an_f32_run(caches, monkeypatch):
    """An int8 entry tuned at bf16 compute names its dtype in its key: an
    f32 run of the same shape finds no entry and launches its default (the
    reference's key would hand it a 16-row tile that f32 has no launch for);
    the bf16 run reads it. Float keys stay the reference's byte for byte."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn(48, 4, generator=g)
    i = torch.randint(0, 64, (48, 4), generator=g, dtype=torch.int32)
    q, s = F.quantize_values(v, "int8")
    x = torch.randn(15, 64, generator=g)                 # 15 rows: bucket 32
    seen = _recording(monkeypatch, cm, "condensed_matmul")
    key = F.shape_tuning_key(64, 48, 4, 15, backend="cpu", values_dtype="int8",
                             compute_dtype=torch.bfloat16)
    assert key == "cpu/wint8-xbf16/d64/n48/k4/b32"
    _store(key, 16, 64)
    y = ops.condensed_linear_nd(x, q, i, scales=s)
    assert seen == [(None, None)]                        # f32: no entry, the default
    assert torch.equal(y, cm.condensed_matmul(x, q, i, scales=s))
    ops.condensed_linear_nd(x.to(torch.bfloat16), q, i, scales=s)
    assert seen[-1] == (16, 64)                          # bf16 reads its own entry
    # the reference keys both runs alike, and f32 has no 16-row launch
    assert (JF.shape_tuning_key(64, 48, 4, 15, backend="cpu", itemsize=2, values_dtype="int8")
            == JF.shape_tuning_key(64, 48, 4, 15, backend="cpu", itemsize=4,
                                   values_dtype="int8"))
    with pytest.raises(ValueError, match="block_b must be one of"):
        cm.condensed_matmul(x, q, i, scales=s, block_b=16)
    # what tune_registry writes at bf16 is the bf16 key; an f32 spec keys apart
    stack = types.SimpleNamespace(name="s", d_in=64, d_out=48)
    st = F.ExportStats(4, 48, 1.0, 4)
    AT.tune_registry([stack], {"s": st}, cfg=DENSE, batch=15, dtype=torch.bfloat16, reps=1,
                     device="cpu", values_dtype="int8")
    spec = F.spec_for_stack(stack, st, 2, "int8")
    assert F.Condensed.spec_tuning_key(spec, 15, backend="cpu", dtype=torch.bfloat16) == key
    assert AT.lookup_entry(F.Condensed.spec_tuning_key(spec, 15, backend="cpu",
                                                       dtype=torch.float32)) is None
    # float keys: byte-identical to the reference's
    for itemsize, width in ((4, "w32"), (2, "w16")):
        want = f"cpu/{width}/d64/n48/k4/b32"
        assert F.shape_tuning_key(64, 48, 4, 15, backend="cpu", itemsize=itemsize,
                                  compute_dtype=COMPUTE[itemsize]) == want
        assert JF.shape_tuning_key(64, 48, 4, 15, backend="cpu", itemsize=itemsize) == want


# ---------------------------------------------------------------------------
# the candidate lists
# ---------------------------------------------------------------------------

D_INS = (1, 64, 1000, 2048, 6144, 40000)
BUCKETS = (1, 4, 8, 32, 128)


def _default_launch(b, d_in, n_rows, dtype, sm_count):
    """The launch ``condensed_matmul`` picks at ``block_b=None``."""
    x = torch.empty((b, d_in), dtype=dtype, device="meta")
    tile = cm.decode_rows(b) if b <= cm.SMALL_BATCH_MAX else cm.TILED_ROWS[dtype]
    args = cm.launch_args(x, n_rows, tile, sm_count)
    n = args[4] if dtype == torch.bfloat16 else args[1] * 8
    return (None if b <= cm.SMALL_BATCH_MAX else tile), n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d_in", D_INS)
def test_gather_candidates_keep_the_geometry_and_fit(d_in, dtype):
    geo = cm.gather_geometry(d_in, dtype)
    for b in BUCKETS:
        for n_rows, sms in ((2048, 132), (96, 132), (6144, 8)):
            cands = cm.gather_candidates(b, d_in, n_rows, dtype, sm_count=sms)
            assert cands[0] == _default_launch(b, d_in, n_rows, dtype, sms)
            assert len(set(cands)) == len(cands) and len(cands) > 1 or d_in > 6656
            top = 1 << (b - 1).bit_length()
            for bb, bn in cands:
                assert bb is not None or b <= cm.SMALL_BATCH_MAX
                tile = cm.decode_rows(b) if bb is None else bb
                if (bb, bn) != cands[0]:
                    assert tile <= top
                x = torch.empty((b, d_in), dtype=dtype, device="meta")
                rows, per_warp, split, pass_rows, neurons, loads = cm.launch_args(
                    x, n_rows, tile, sms, bn)
                if dtype == torch.float32:
                    assert per_warp * 8 == bn and rows * d_in * 4 <= cm.SMEM_BYTES
                    continue
                assert split == geo.split_rows and neurons == bn
                if loads:                                 # the decode kernel
                    assert tile <= 8 and pass_rows == 0 and bn in (8, 16)
                    assert geo.decode_smem_bytes <= cm.SMEM_BYTES
                else:
                    assert pass_rows == geo.pass_rows and bn in cm.NEURON_TILES
                    assert cm.mma_smem_bytes(tile, bn, geo.pass_rows, geo.passes) <= \
                        cm.SMEM_BYTES
                    assert cm._outbox_fits(bn, geo.splits, geo.pass_rows)
                    assert geo.passes == 1 or bn == 16
    with pytest.raises(ValueError, match="block_n must be one of"):
        cm.check_block_n(12, 4, d_in, dtype)


def test_every_candidate_gives_the_defaults_output_on_the_cpu():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(30, 200, generator=g)
    v = torch.randn(40, 7, generator=g)
    i = torch.randint(0, 200, (40, 7), generator=g, dtype=torch.int32)
    want = cm.condensed_matmul(x, v, i)
    for bb, bn in cm.gather_candidates(32, 200, 40, torch.float32, sm_count=132):
        call = AT.candidate_call("condensed", bb, bn)
        assert torch.equal(call(x, v, i, None), want)
    with pytest.raises(ValueError, match="block_n must be one of"):
        cm.condensed_matmul(x, v, i, block_b=4, block_n=72)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_structured_candidates_list_the_default_first(dtype):
    for b in BUCKETS:
        cands = sm.structured_candidates(b, 2048, 1024, dtype)
        small = b <= sm.SMALL_BATCH_MAX
        assert cands[0] == ((None, None) if small else (sm.TILED_ROWS[dtype], None))
        assert all(bn is None for _, bn in cands) and len(set(cands)) == len(cands)
        for bb, _ in cands[1:]:
            assert bb in sm.STRUCTURED_ROWS[dtype] and bb <= 1 << (b - 1).bit_length()
    with pytest.raises(ValueError, match="block_b only"):
        AT.candidate_call("structured", 8, 64)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def _cli(*extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TS.main(["--arch", "qwen3-1.7b", "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--gen", "6", "--device", "cpu", *extra])
    return out, buf.getvalue().splitlines()


def test_serve_cli_autotune_prints_its_lines_and_the_same_stream(caches):
    out, text = _cli("--path", "condensed")
    out_t, text_t = _cli("--path", "condensed", "--autotune")
    tuned = [ln for ln in text_t if ln.startswith("[serve] autotuned ")]
    assert [ln.split(":")[0] for ln in tuned] == [
        "[serve] autotuned blocks/wo", "[serve] autotuned blocks/w_gate",
        "[serve] autotuned blocks/w_down"]
    assert all(" us vs default " in ln and ln.endswith(" us)") for ln in tuned)
    assert len(json.loads(caches[0].read_text())["kernels"]) == 3
    assert torch.equal(out, out_t) and text[-1] == text_t[-1]
    _, masked = _cli("--path", "masked", "--autotune")
    assert masked[0].startswith("[serve] --autotune skipped: --path masked")
    assert not any(ln.startswith("[serve] autotuned") for ln in masked)
