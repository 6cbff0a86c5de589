"""The port's ServingEngine (paged continuous batching) against the
reference's ``repro.launch.engine.ServingEngine``, on the CPU.

On the reference's smoke qwen3 weights and masks (bridged), for the same
submissions: plan-key groups are equal (the port's plans priced with the
reference's hardware profile), and the port engine's tokens equal the
reference engine's EXACTLY on the masked, condensed and auto paths.
Within the port, as the reference's ``tests/test_engine.py`` holds its
engine: a request's tokens equal a standalone ``generate`` of it however it
is batched (mixed shapes in one group, admitted mid-generation, retired
early, across pool growth); one decode signature per bucket and no cold
result on a second wave (on the CPU the engine counts its decode step
functions where the card counts captured graphs); submit validation,
retire, the plan cache, a failed step keeping its requests pending, and the
slab path splitting at the bucket. The launch counters count a captured
step once per replay. The CLI prints the same stream through the engine on
both paths, paged or not.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import condensed_matmul as cm  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sparse import autotune  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402

ARCH = "qwen3-1.7b"
# the submissions held to the reference engine: two shapes, one group
MIX = ((2, 8, 6, 11), (3, 6, 5, 12))


def _prompts(b, t, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    m = smoke_model()
    profile = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                    for f in dataclasses.fields(TP.HardwareProfile)})
    return dict(m, tmasks=bridge.from_jax_numpy({"blocks": {
        k: np.array(v) for k, v in m["jmasks"]["blocks"].items()}}), profile=profile)


def _engine(smoke, path="condensed", **kw):
    kw.setdefault("profile", smoke["profile"])
    return TE.ServingEngine(smoke["tcfg"], smoke["tparams"], smoke["tmasks"], smoke["treg"],
                            path=path, **kw)


def _generate(smoke, eng, prompts, gen):
    tree = eng.serving_tree_for(eng.plan_key(prompts.shape[0]))
    return TE.generate(smoke["tcfg"], smoke["tparams"], tree, torch.as_tensor(prompts), gen)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def test_counters_count_a_recorded_step_once_per_replay(smoke, monkeypatch):
    """A decode step run eagerly 4 times counts what one recorded step
    replayed 4 times counts. The CPU has no kernel, so the plain version
    stands in for a launch here and counts as one."""
    plain = cm._plain

    def launching(x, values, indices, scales):
        counters.add(cm.condensed_matmul, "launches" if scales is None else "scaled_launches")
        return plain(x, values, indices, scales)

    monkeypatch.setattr(cm, "_plain", launching)
    eng = _engine(smoke)
    cfg, tree = smoke["tcfg"], eng.serving_tree_for(eng.plan_key(2))
    counts = []
    for record in (False, True):
        cache = TM.init_cache(cfg, 2, 12, "cpu")
        st = TE._new_state(2, 4, "cpu", cache=cache)
        step = TE._Decoder(lambda: TE._contiguous_step(cfg, eng.compute, tree, st), st)
        cm.condensed_matmul.launches = 0
        if record:
            with counters.recording() as tally:
                step.step()
            assert cm.condensed_matmul.launches == 0
            counters.replayed(tally, 4)
        else:
            TE._decode_chunk_eager(step, 4)
        counts.append(cm.condensed_matmul.launches)
    assert counts[0] == counts[1] == 4 * 4 * cfg.n_layers


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["auto", "condensed"])
def test_plan_key_groups_equal_the_reference_engines(smoke, path):
    jeng = JE.ServingEngine(smoke["jcfg"], smoke["jparams"], smoke["jmasks"], smoke["jreg"],
                            path=path)
    teng = _engine(smoke, path)
    for b, seed in ((1, 1), (2, 2), (3, 3), (200, 4)):
        p = _prompts(b, 8, seed, smoke["tcfg"].vocab_size)
        assert jeng.submit(jnp.asarray(p), 4) == teng.submit(p, 4)
    jg, tg = jeng.pending_groups(), teng.pending_groups()
    assert [(k.batch_bucket, k.formats, ids) for k, ids in jg.items()] == \
        [(k.batch_bucket, k.formats, ids) for k, ids in tg.items()]
    assert [k.batch_bucket for k in tg] == [1, 8, 512]
    assert teng.plan_key(2) == teng.plan_key(8) != teng.plan_key(1)


@pytest.fixture(scope="module")
def reference_runs(smoke):
    """MIX through the reference engine on each path (one compiled prefill
    and one decode program per path)."""
    out = {}
    for path in ("masked", "condensed", "auto"):
        eng = JE.ServingEngine(smoke["jcfg"], smoke["jparams"], smoke["jmasks"], smoke["jreg"],
                               path=path)
        ids = [eng.submit(jnp.asarray(_prompts(b, t, s, smoke["jcfg"].vocab_size)), g)
               for b, t, g, s in MIX]
        eng.step()
        out[path] = [np.asarray(eng.retire(i)[0].tokens) for i in ids]
    return out


@pytest.mark.parametrize("path", ["masked", "condensed", "auto"])
def test_engine_tokens_equal_the_reference_engines(smoke, reference_runs, path):
    eng = _engine(smoke, path)
    ids = [eng.submit(_prompts(b, t, s, smoke["tcfg"].vocab_size), g) for b, t, g, s in MIX]
    [report] = eng.step()
    assert report.n_slabs == 1 and report.total_batch == 5
    for rid, want, (b, t, g, s) in zip(ids, reference_runs[path], MIX):
        [res] = eng.retire(rid)
        assert res.tokens.shape == (b, t + g)
        np.testing.assert_array_equal(res.tokens.numpy(), want)
        # and a standalone generate of the request on the same serving tree
        ref = _generate(smoke, eng, _prompts(b, t, s, smoke["tcfg"].vocab_size), g)
        assert torch.equal(res.tokens, ref)
        assert res.plan_key == eng.plan_key(b)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def test_mixed_shape_requests_in_one_group_decode_correctly(smoke):
    """Different (prompt_len, gen_len) under one key: one bucket-padded
    prefill admits both, each gets its own shape and its standalone tokens."""
    eng = _engine(smoke)
    vocab = smoke["tcfg"].vocab_size
    pa, pb = _prompts(2, 8, 31, vocab), _prompts(2, 6, 32, vocab)
    ra, rb = eng.submit(pa, 4), eng.submit(pb, 5)
    [report] = eng.step()
    assert report.n_slabs == 1
    [res_a], [res_b] = eng.retire(ra), eng.retire(rb)
    assert res_a.tokens.shape == (2, 12) and res_b.tokens.shape == (2, 11)
    assert torch.equal(res_a.tokens, _generate(smoke, eng, pa, 4))
    assert torch.equal(res_b.tokens, _generate(smoke, eng, pb, 5))


def test_submit_validates_and_retire_pops(smoke):
    eng = _engine(smoke, "auto")
    vocab = smoke["tcfg"].vocab_size
    with pytest.raises(ValueError, match="both dims"):
        eng.submit(np.zeros((4,), np.int32), 4)
    with pytest.raises(ValueError, match="both dims"):
        eng.submit(np.zeros((0, 4), np.int32), 2)
    with pytest.raises(ValueError, match="gen_len"):
        eng.submit(_prompts(1, 4, 0, vocab), 0)
    with pytest.raises(ValueError, match="integer token ids"):
        eng.submit(np.zeros((1, 4), np.float32), 2)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(np.full((1, 4), vocab, np.int32), 2)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(np.full((1, 4), -1, np.int32), 2)
    with pytest.raises(ValueError, match="unknown serving path"):
        _engine(smoke, "csr")
    rid = eng.submit(np.zeros((1, 4), np.int64), 2)     # int64 is cast, not refused
    assert eng._pending[-1].prompts.dtype == torch.int32 and eng._pending[-1].id == rid
    assert eng.retire(rid) == []                        # not stepped yet
    eng.step()
    assert len(eng.retire(rid)) == 1
    assert eng.retire(rid) == []                        # popped exactly once
    assert eng.retire() == []


def test_plan_cache_is_reused_across_steps(smoke, monkeypatch):
    built = []
    real = TP.build_plan
    monkeypatch.setattr(TP, "build_plan", lambda *a, **k: built.append(k) or real(*a, **k))
    eng = _engine(smoke, "auto")
    for seed in (41, 42):
        eng.submit(_prompts(2, 8, seed, smoke["tcfg"].vocab_size), 2)
        eng.step()
    plan = eng.plan_for(eng.plan_key(2))
    assert eng.plan_for(eng.plan_key(3)) is plan
    assert len(built) == 1 and built[0]["batch_size"] == 8


def test_adversarial_mix_runs_one_decode_signature_and_no_cold_second_wave(smoke):
    """Varied (batch, prompt_len) inside one bucket share one prefill shape
    and one decode step signature (a captured graph on the card); a second
    wave adds neither, and nothing in it is cold."""
    eng = _engine(smoke, block_size=4, gen_chunk=8)
    vocab = smoke["tcfg"].vocab_size
    for b, t, seed in ((2, 8, 71), (3, 6, 72), (2, 5, 73)):
        eng.submit(_prompts(b, t, seed, vocab), 6)
    eng.step()
    assert eng.program_count("prefill") == 1 and eng.program_count("decode") == 1
    first = eng.retire()
    for b, t, seed in ((3, 8, 75), (3, 3, 76), (2, 4, 77)):
        eng.submit(_prompts(b, t, seed, vocab), 6)
    eng.step()
    assert eng.program_count("prefill") == 1 and eng.program_count("decode") == 1
    second = eng.retire()
    assert len(first) == len(second) == 3
    assert not any(r.cold for r in first + second)


def test_cold_flag_marks_unwarmed_first_dispatch(smoke):
    eng = _engine(smoke, block_size=5, gen_chunk=3, warm=False)
    vocab = smoke["tcfg"].vocab_size
    r1 = eng.submit(_prompts(2, 8, 91, vocab), 3)
    eng.step()
    [res1] = eng.retire(r1)
    r2 = eng.submit(_prompts(2, 8, 92, vocab), 3)
    eng.step()
    [res2] = eng.retire(r2)
    assert res1.cold and not res2.cold


def test_mid_generation_admission_and_early_retirement_identity(smoke):
    eng = _engine(smoke, gen_chunk=2)
    vocab = smoke["tcfg"].vocab_size
    pa, pb = _prompts(2, 8, 81, vocab), _prompts(2, 6, 82, vocab)
    ra = eng.submit(pa, 8)
    eng.step(max_chunks=1)              # ra admitted, 2 of 8 tokens decoded
    assert eng.retire() == []
    rb = eng.submit(pb, 3)              # joins ra's running generation
    eng.step(max_chunks=1)
    runner = eng._runners[eng.plan_key(2)]
    assert len(runner.active) == 2
    for _ in range(8):
        if not runner.active:
            break
        eng.step(max_chunks=1)          # rb retires early, ra goes on
    assert runner.alloc.available == runner.num_blocks - 1   # every page back
    [res_a], [res_b] = eng.retire(ra), eng.retire(rb)
    assert torch.equal(res_a.tokens, _generate(smoke, eng, pa, 8))
    assert torch.equal(res_b.tokens, _generate(smoke, eng, pb, 3))


def test_pool_growth_mid_flight_drops_the_step_and_keeps_streams(smoke):
    """A request needing wider tables than the pool was sized for arrives
    while another decodes: the pool grows (its pages keep their ids and
    contents), the decode signature is made anew, and both requests still
    emit their standalone tokens."""
    eng = _engine(smoke, block_size=4, gen_chunk=2)
    vocab = smoke["tcfg"].vocab_size
    pa, pb = _prompts(2, 4, 61, vocab), _prompts(3, 16, 62, vocab)
    ra = eng.submit(pa, 6)
    eng.step(max_chunks=1)
    runner = eng._runners[eng.plan_key(2)]
    shape = (runner.nb, runner.num_blocks)
    rb = eng.submit(pb, 9)
    eng.step()
    assert (runner.nb, runner.num_blocks) != shape and eng.program_count("decode") == 2
    [res_a], [res_b] = eng.retire(ra), eng.retire(rb)
    assert torch.equal(res_a.tokens, _generate(smoke, eng, pa, 6))
    assert torch.equal(res_b.tokens, _generate(smoke, eng, pb, 9))


def test_step_failure_keeps_unexecuted_requests_pending(smoke, monkeypatch):
    eng = _engine(smoke)
    vocab = smoke["tcfg"].vocab_size
    ra = eng.submit(_prompts(1, 8, 61, vocab), 3)
    rb = eng.submit(_prompts(2, 8, 62, vocab), 3)
    calls = {"n": 0}
    real = TE._paged_prefill_dispatch

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected slab failure")
        return real(*args, **kw)

    monkeypatch.setattr(TE, "_paged_prefill_dispatch", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    pending = [rid for rids in eng.pending_groups().values() for rid in rids]
    assert sorted(pending) == sorted([ra, rb]) and eng.retire() == []
    eng.step()   # the retry serves both
    assert {r.id for r in eng.retire()} == {ra, rb}


def test_legacy_path_splits_slabs_at_bucket_boundary(smoke, monkeypatch):
    """paged=False: same-(T, gen) requests of more streams than the bucket
    are served in slabs that never exceed it, each with its standalone
    tokens."""
    eng = _engine(smoke, paged=False)
    batches = []
    real = TE._timed_serve

    def spy(cfg, params, tree, prompts, gen_len, **kw):
        batches.append(prompts.shape[0])
        return real(cfg, params, tree, prompts, gen_len, **kw)

    monkeypatch.setattr(TE, "_timed_serve", spy)
    prompts = [_prompts(3, 8, s, smoke["tcfg"].vocab_size) for s in (101, 102, 103)]
    rids = [eng.submit(p, 4) for p in prompts]
    [report] = eng.step()               # 9 streams in a bucket-8 group
    assert report.key.batch_bucket == 8 and report.n_slabs == 2
    assert batches == [6, 3]
    for rid, p in zip(rids, prompts):
        [res] = eng.retire(rid)
        assert torch.equal(res.tokens, _generate(smoke, eng, p, 4))


def test_engine_refuses_what_is_not_ported(smoke):
    with pytest.raises(NotImplementedError, match="item 9"):
        _engine(smoke, mesh=object())
    eng = _engine(smoke)
    # refresh and attach_subscriber are ported (tests/test_torch_refresh.py
    # and tests/test_torch_sync.py), speculative decoding too
    # (tests/test_torch_speculative.py), and autotune on one device
    # (tests/test_torch_autotune.py); its tensor-parallel shapes are not
    with pytest.raises(NotImplementedError, match="item 9"):
        autotune.tune_registry(eng.registry, eng.stats(), cfg=eng.cfg, batch=1, tp=2,
                               device="cpu")
    with pytest.raises(ValueError, match="paged serving requires"):
        TE.ServingEngine(smoke["tcfg"].replace(sliding_window=16), smoke["tparams"],
                         smoke["tmasks"], smoke["treg"], paged=True)


def test_decode_off_the_cpu_never_runs_eagerly():
    """A decoder whose state is not on the CPU and has no captured graph
    raises instead of decoding eagerly (on the card it replays or fails)."""
    st = TE._new_state(1, 1, "meta")
    with pytest.raises(RuntimeError, match="captured graph"):
        TE._Decoder(lambda: None, st).run(1)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TS.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--gen", "6", "--path", path, "--device", "cpu", *extra])
    return out, buf.getvalue().splitlines()


def test_cli_prints_the_same_first_stream_through_the_engine_paged_or_not():
    lines = {}
    for path in ("masked", "condensed"):
        for extra in ((), ("--no-paged",)):
            out, text = _cli(path, *extra)
            assert text[0].startswith(f"[serve:{path}] prefill 2x8 in ")
            assert " | decode 2x6 in " in text[0] and text[0].endswith(" tok/s)")
            assert text[1] == f"[serve] first stream: {out[0, -6:].tolist()}"
            lines[path, extra] = text[1]
    assert len(set(lines.values())) == 1
