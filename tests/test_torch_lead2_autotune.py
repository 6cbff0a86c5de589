"""The launch search on stacks with two leading axes against the JAX
reference, on the CPU: gemma3's ``g_local`` (g, r) and granite-moe's
expert stacks (L, E) at smoke size (``tests/_torch_zoo_model.py``).

``tune_registry`` and ``ServingEngine.autotune`` write exactly the
reference's keys (the reference's timed searches stubbed to keep one entry
under the key each would write), a quantized key naming the compute dtype
as the port's do (ROADMAP section 3). The expert-grouped launch reads its
launch at the key the reference's wrapper looks up under its ``jax.vmap``
(one expert's shape at its rows, G * C, bucketed), recorded on both sides
over a condensed prefill and decode step; with an entry there the grouped
wrapper launches the entry's blocks for every expert, and on the CPU its
plain version equals E single plain launches exactly. An engine serving
what its ``autotune`` wrote gives the untuned engine's tokens.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sparse import autotune as JAT  # noqa: E402
from repro.sparse import condensed as JCond  # noqa: E402
from repro_torch.kernels import condensed_matmul as cm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import autotune as AT  # noqa: E402
from repro_torch.sparse import condensed as TCond  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402

from _torch_autotune_stubs import _stub_reference_search, caches  # noqa: E402,F401
from _torch_zoo_model import _model, _prompts  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
ARCHS = ["gemma3-1b", GRANITE]


def _port_key(ref_key: str, dtype: torch.dtype) -> str:
    return re.sub(r"/w(int8|fp8)/", lambda m: f"/w{m[1]}-x{F.dtype_name(dtype)}/", ref_key)


def _keys(path) -> set[str]:
    return set(json.loads(path.read_text())["kernels"])


@pytest.mark.parametrize("dtype,values_dtype", [(torch.float32, None), (torch.bfloat16, None),
                                                (torch.bfloat16, "int8")])
@pytest.mark.parametrize("arch", ARCHS)
def test_tune_registry_keys_equal_the_reference(caches, monkeypatch, arch, dtype,
                                                values_dtype):
    _stub_reference_search(monkeypatch)
    m = _model(arch, ())
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jout = JAT.tune_registry(m["jreg"], JCond.export_stats(m["jreg"], m["jmasks"]), batch=8,
                             dtype=jdt, reps=1, values_dtype=values_dtype)
    tout = AT.tune_registry(m["treg"], TCond.export_stats(m["treg"], m["tmasks"]), batch=8,
                            dtype=dtype, reps=1, device="cpu", values_dtype=values_dtype,
                            cfg=m["tcfg"])
    assert set(tout) == set(jout) and tout
    keys = _keys(caches[0])
    assert keys == {_port_key(k, dtype) for k in _keys(caches[1])}
    assert keys == {r.key for r in tout.values()}
    for r in tout.values():
        assert r.plain and r.us == min(r.table.values())
    if arch == GRANITE:
        # the expert stacks' searches ran the grouped launch's candidates
        grouped = [r for name, r in tout.items() if name != "blocks/wo"]
        assert grouped and all(re.search(r"/d64/n32/|/d32/n64/", r.key) for r in grouped)


def test_engine_autotune_labels_equal_the_reference_engine(caches, monkeypatch):
    _stub_reference_search(monkeypatch)
    for arch in ARCHS:
        m = _model(arch, ())
        jeng = JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"],
                                path="condensed")
        teng = TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"],
                                path="condensed")
        assert set(teng.autotune(8, reps=1)) == set(jeng.autotune(8))
    assert _keys(caches[0]) == _keys(caches[1])


def _spy_lookups(monkeypatch, module) -> list:
    seen = []
    real = module.lookup_entry

    def spy(key):
        seen.append(key)
        return real(key)
    monkeypatch.setattr(module, "lookup_entry", spy)
    return seen


def test_grouped_launch_reads_the_reference_key(caches, monkeypatch):
    """A condensed prefill of 2 x 8 tokens (one group of 16, capacity 10:
    10 rows an expert, bucket 32) and a decode step of 2 rows (capacity 2,
    bucket 8): the keys the reference's wrappers look up under ``jax.vmap``
    are the keys the port's grouped launches look up."""
    m = _model(GRANITE, ())
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    AT._load()["kernels"]["unrelated"] = {"block_b": None, "block_n": None}
    jseen, tseen = _spy_lookups(monkeypatch, JAT), _spy_lookups(monkeypatch, AT)
    prompts = _prompts(tcfg, 2, 8, seed=5)
    jtree = JCond.export_condensed(jcfg, m["jreg"], m["jparams"], m["jmasks"])
    jcache = JM.init_cache(jcfg, 2, 12)
    jlogits, jcache = JM.prefill_step(jcfg, m["jparams"], jtree,
                                      {"tokens": jnp.asarray(prompts)}, jcache)
    nxt = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    JM.decode_step(jcfg, m["jparams"], jtree, {"tokens": nxt}, jcache)
    ttree = TCond.export_condensed(tcfg, m["treg"], m["tparams"], m["tmasks"])
    tcache = TM.init_cache(tcfg, 2, 12, "cpu")
    tlogits, _ = TM.prefill_step(tcfg, m["tparams"], ttree, {"tokens": torch.from_numpy(prompts)},
                                 tcache)
    TM.decode_step(tcfg, m["tparams"], ttree, {"tokens": torch.from_numpy(np.array(nxt))},
                   tcache)
    jkeys, tkeys = set(jseen), set(tseen)
    experts = {k for k in jkeys if re.search(r"/d64/n32/|/d32/n64/", k)}
    assert {re.search(r"/b(\d+)$", k)[1] for k in experts} == {"32", "8"}
    assert tkeys == jkeys and experts


def test_grouped_launch_takes_the_cached_blocks(caches, monkeypatch):
    """An entry at one expert's key: the grouped wrapper passes its blocks
    to the launch, which (a launch that fits, on the CPU the plain version)
    equals E single plain launches exactly, f32 and on int8 codes."""
    g = torch.Generator().manual_seed(0)
    e, rows, d_in, n_out, k = 4, 6, 64, 48, 5
    x = torch.randn(e, 2, 3, d_in, generator=g)
    v = torch.randn(e, n_out, k, generator=g)
    i = torch.randint(0, d_in, (e, n_out, k), generator=g, dtype=torch.int32)
    q, s = F.quantize_values(v, "int8")
    seen = []
    real = cm.condensed_matmul_grouped

    def spy(*a, **kw):
        seen.append((kw.get("block_b"), kw.get("block_n")))
        return real(*a, **kw)
    monkeypatch.setattr(cm, "condensed_matmul_grouped", spy)
    for vals, scales, vd in ((v, None, None), (q, s, "int8")):
        key = F.shape_tuning_key(d_in, n_out, k, rows, backend="cpu", itemsize=4,
                                 values_dtype=vd, compute_dtype=torch.float32)
        AT._load()["kernels"][key] = {"block_b": 2, "block_n": 32}
        y = ops.condensed_linear_grouped(x, vals, i, scales=scales)
        assert seen[-1] == (2, 32)
        assert y.shape == (e, 2, 3, n_out)
        for ex in range(e):
            want = cm.condensed_matmul(x[ex].reshape(rows, d_in), vals[ex], i[ex],
                                       scales=None if scales is None else scales[ex])
            assert torch.equal(y[ex].reshape(rows, n_out), want)
    # a launch that does not fit raises, on the CPU too
    with pytest.raises(ValueError, match="block_n"):
        cm.condensed_matmul_grouped(x.reshape(e, rows, d_in), v, i, block_b=2, block_n=3)


@pytest.mark.parametrize("values_dtype", [None, "int8"])
def test_tuned_moe_engine_serves_the_untuned_tokens(caches, monkeypatch, values_dtype):
    """granite: ``autotune`` at the requests' bucket, then an engine whose
    graphs read the entries gives the untuned engine's tokens, and each
    expert stack's decode launch reads the entry its key holds."""
    m = _model(GRANITE, ())
    prompts = _prompts(m["tcfg"], 2, 8, seed=6)
    args = (m["tcfg"], m["tparams"], m["tmasks"], m["treg"])
    plain = TE.ServingEngine(*args, path="condensed", values_dtype=values_dtype, gen_chunk=4)
    rid = plain.submit(prompts, 6)
    plain.step()
    want = plain.retire(rid)[0].tokens
    eng = TE.ServingEngine(*args, path="condensed", values_dtype=values_dtype, gen_chunk=4)
    tuned = eng.autotune(2, reps=1)
    assert {"blocks/w_gate", "blocks/w_down"} <= set(tuned)
    winners = {tuple(map(int, re.search(r"/d(\d+)/n(\d+)/", r.key).groups())):
               (r.block_b, r.block_n) for name, r in tuned.items() if name != "blocks/wo"}
    seen = []
    real = cm.condensed_matmul_grouped

    def spy(x, v, *a, **kw):
        if x.shape[1] <= 8:          # a decode step: 8 rows (the bucket), capacity 5
            seen.append(((x.shape[2], v.shape[1]), (kw["block_b"], kw["block_n"])))
        return real(x, v, *a, **kw)
    monkeypatch.setattr(cm, "condensed_matmul_grouped", spy)
    rid = eng.submit(prompts, 6)
    eng.step()
    assert torch.equal(eng.retire(rid)[0].tokens, want)
    assert seen and all(launch == winners[shape] for shape, launch in seen)
