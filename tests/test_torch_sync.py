"""Live train-to-serve sync in the port (``repro_torch.sync``) against the
reference's ``repro.sync``, on the CPU.

The port of ``tests/test_sync.py``: every format round-trips the wire
(bf16 values included, without ml_dtypes), corrupt and truncated records are
rejected, a subscriber fed an adversarial stream (the reference's seeds:
shuffled, duplicated, one delta dropped) converges bitwise to the
publisher, f32 and int8; deltas before the bootstrap ask for a resync; an
incoherent delta is rejected all or nothing; values-only deltas are smaller
than topology ones; a pruned ``DirChannel`` gap resyncs; a resync storm
costs one snapshot; ``attach_subscriber`` refuses the paths that read live
weights. On the smoke model an engine drains a topology delta at a chunk
boundary in place (no decode step made again, every leaf tensor kept) and
serves the tokens of the reference engine refreshed at the same boundary,
on condensed, condensed_over_active and int8 condensed, and a fresh replica
restarted from the stream serves the live one's tokens.

Across frameworks, through a ``DirChannel`` in ``tmp_path``: the records a
JAX ``Publisher`` writes decode in the port and re-encode to the same bytes,
and the port subscriber's state equals the JAX subscriber's; the same in
reverse. A tensor-parallel (tp=2) stream is refused with an error naming
ROADMAP item 9.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.sparse import plan as JP  # noqa: E402
from repro.sparse import registry as JR  # noqa: E402
from repro.sync import DirChannel as JDirChannel  # noqa: E402
from repro.sync import Publisher as JPublisher  # noqa: E402
from repro.sync import Subscriber as JSubscriber  # noqa: E402
from repro.sync import delta as JD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402
from repro_torch.sparse import plan as TP  # noqa: E402
from repro_torch.sparse import registry as REG  # noqa: E402
from repro_torch.sync import (DirChannel, Publisher, QueueChannel, Subscriber,  # noqa: E402
                              engine_from_snapshot)
from repro_torch.sync import delta as D  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_smoke_model import smoke_model  # noqa: E402


# ---------------------------------------------------------------------------
# a synthetic two-stack world (no model, just trees)
# ---------------------------------------------------------------------------

class _Cfg:
    param_dtype = "float32"
    dtype = "float32"


class _JCfg:
    param_dtype = jnp.float32


def _tiny_registry(reg_mod=REG):
    return [reg_mod.SparseStack(path=("blk0", "w"), d_in=16, d_out=8, lead=(), density=0.5),
            reg_mod.SparseStack(path=("blk1", "w"), d_in=12, d_out=8, lead=(2,), density=0.5)]


def _random_masks(reg, rng, k=4) -> dict:
    """Constant fan-in k boolean masks, as numpy."""
    masks = {}
    for s in reg:
        m = np.zeros((*s.lead, s.d_in, s.d_out), dtype=bool)
        flat = m.reshape(-1, s.d_in, s.d_out)
        for r in range(flat.shape[0]):
            for c in range(s.d_out):
                flat[r, rng.choice(s.d_in, size=k, replace=False), c] = True
        REG.set_path(masks, s.path, m)
    return masks


def _random_params(reg, rng) -> dict:
    params = {}
    for s in reg:
        REG.set_path(params, s.path,
                     rng.standard_normal((*s.lead, s.d_in, s.d_out)).astype(np.float32))
    params["emb"] = rng.standard_normal((4, 6)).astype(np.float32)
    return params


def _evolve(reg, params, masks, rng, *, rewire: bool = True):
    """One synthetic training step on numpy trees: every weight perturbed,
    and with ``rewire`` one stack rolled along its input axis."""
    params = jax.tree.map(lambda x: x + (rng.standard_normal(x.shape) * 0.1).astype(x.dtype),
                          params)
    changed = []
    if rewire:
        s = reg[rng.integers(len(reg))]
        masks = jax.tree.map(lambda x: x, masks)
        REG.set_path(masks, s.path, np.roll(REG.get_path(masks, s.path),
                                            int(rng.integers(1, 4)), axis=-2))
        changed = [s.name]
    return params, masks, changed


def _torch(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _leaves_bitwise_equal(sub: Subscriber, pub: Publisher, reg) -> bool:
    for s in reg:
        rec, leaf = sub.leaves[s.name], REG.get_path(pub._plan.serving_tree, s.path)
        for f in leaf._array_fields:
            mine, theirs = rec.arrays.get(f), getattr(leaf, f)
            if (mine is None) != (theirs is None):
                return False
            if mine is not None and not torch.equal(mine, theirs):
                return False
    return torch.equal(sub.params["emb"], torch.as_tensor(pub._params["emb"]))


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _every_format() -> dict:
    g = torch.Generator().manual_seed(0)
    return {
        "masked": F.MaskedDense(mask=torch.rand((4, 6), generator=g) > 0.5, weight_itemsize=4),
        "structured": F.StructuredFanIn(
            neuron_active=torch.tensor([True, False, True, True]),
            active_index=torch.tensor([0, 2, 3, 4], dtype=torch.int32), d_in=6,
            weight_itemsize=4),
        "condensed": F.Condensed(values=torch.ones((8, 3), dtype=torch.int8),
                                 indices=torch.zeros((8, 3), dtype=torch.int32), d_in=16,
                                 scales=torch.full((8,), 0.5), values_dtype="int8"),
        "condensed_over_active": F.CondensedOverActive(
            values=torch.randn((2, 5, 3), generator=g),
            indices=torch.zeros((2, 5, 3), dtype=torch.int32),
            out_index=torch.zeros((2, 5), dtype=torch.int32), d_in=16, d_out=8),
        "fp8": F.Condensed(values=torch.randn((4, 2), generator=g).to(torch.float8_e4m3fn),
                           indices=torch.zeros((4, 2), dtype=torch.int32), d_in=8,
                           scales=torch.ones((4,)), values_dtype="fp8"),
    }


def _bits(t):
    """A tensor comparable with ``torch.equal`` (fp8 by its bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def test_wire_roundtrip_every_format():
    """Every formats leaf, quantized and None optional fields included,
    survives encode/decode bitwise."""
    leaves = _every_format()
    recs = [D.leaf_to_wire(name, 7, leaf) for name, leaf in leaves.items()]
    back = D.decode(D.encode(D.Delta(generation=3, stacks=recs,
                                     dense={"emb": torch.arange(6, dtype=torch.float32)})))
    assert back.generation == 3
    assert torch.equal(back.dense["emb"], torch.arange(6, dtype=torch.float32))
    for rec in back.stacks:
        orig, rebuilt = leaves[rec.name], D.wire_to_leaf(rec)
        assert type(rebuilt) is type(orig)
        for f in orig._static_fields:
            assert getattr(rebuilt, f) == getattr(orig, f)
        for f in orig._array_fields:
            a, b = getattr(orig, f), getattr(rebuilt, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_wire_roundtrip_bf16_values():
    leaf = F.Condensed(values=torch.linspace(-2, 2, 8).reshape(4, 2).to(torch.bfloat16),
                       indices=torch.zeros((4, 2), dtype=torch.int32), d_in=8)
    back = D.decode(D.encode(D.Delta(generation=1, stacks=[D.leaf_to_wire("x", 0, leaf)],
                                     dense={})))
    rebuilt = D.wire_to_leaf(back.stacks[0])
    assert rebuilt.values.dtype == torch.bfloat16
    assert torch.equal(rebuilt.values, leaf.values)


def test_corrupt_and_truncated_blobs_rejected():
    leaf = F.Condensed(values=torch.ones((4, 2)), indices=torch.zeros((4, 2), dtype=torch.int32),
                       d_in=8)
    blob = D.encode(D.Delta(generation=1, stacks=[D.leaf_to_wire("x", 0, leaf)], dense={}))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(D.DeltaCorruptError):
        D.decode(bytes(bad))
    with pytest.raises(D.DeltaCorruptError):
        D.decode(blob[:-7])
    with pytest.raises(D.DeltaCorruptError):
        D.decode(b"NOPE" + blob[4:])

    class _Feed:
        def __init__(self, blobs):
            self._b = list(blobs)

        def recv_new(self):
            out, self._b = self._b, []
            return out

        def request_resync(self, reason, needed_generation=None):
            pass

    sub = Subscriber(_Feed([bytes(bad), blob]))
    sub.poll()
    assert sub.counters["corrupt"] == 1


def test_a_record_past_u32_lengths_uses_u64_lengths(monkeypatch):
    """A record of 4 GiB or more (a full-width snapshot) cannot carry the
    reference's u32 lengths: it is written as RSY2 with u64 lengths and
    decodes the same; the reference refuses it as an unknown magic rather
    than reading it wrong. The limit is lowered here to keep the record
    small; below it a record is the reference's RSY1."""
    leaf = F.Condensed(values=torch.arange(8.0).reshape(4, 2),
                       indices=torch.zeros((4, 2), dtype=torch.int32), d_in=8)
    delta = D.Delta(generation=1, stacks=[D.leaf_to_wire("x", 0, leaf)],
                    dense={"emb": torch.ones(3)})
    small = D.encode(delta)
    assert small[:4] == b"RSY1"
    monkeypatch.setattr(D, "_U32_MAX", 16)
    big = D.encode(delta)
    assert big[:4] == b"RSY2" and len(big) == len(small) + 8
    back = D.decode(big)
    assert torch.equal(D.wire_to_leaf(back.stacks[0]).values, leaf.values)
    assert torch.equal(back.dense["emb"], torch.ones(3))
    with pytest.raises(JD.DeltaCorruptError, match="magic"):
        JD.decode(big)
    with pytest.raises(D.DeltaCorruptError):
        D.decode(big[:-5])


# ---------------------------------------------------------------------------
# adversarial streams
# ---------------------------------------------------------------------------

class _ScriptedFeed:
    """A subscription replaying a hand-scrambled blob schedule."""

    def __init__(self):
        self.queue: list[bytes] = []
        self.resyncs: list[str] = []

    def recv_new(self):
        out, self.queue = self.queue, []
        return out

    def request_resync(self, reason: str = "", needed_generation: int | None = None):
        self.resyncs.append(reason)


def _publish_run(rng, *, values_dtype=None, n_gens=4):
    reg = _tiny_registry()
    params, masks = _random_params(reg, rng), _random_masks(reg, rng)
    versions = {s.name: 0 for s in reg}
    ch = QueueChannel()
    pub = Publisher(_Cfg(), reg, ch, path="condensed", values_dtype=values_dtype)
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    for g in range(n_gens):
        params, masks, changed = _evolve(reg, params, masks, rng, rewire=(g % 2 == 0))
        for name in changed:
            versions[name] += 1
        pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    return pub, reg, [blob for _, blob in ch._log]


def _adversarial_converges(seed: int, *, values_dtype=None) -> None:
    rng = np.random.default_rng(seed)
    pub, reg, blobs = _publish_run(rng, values_dtype=values_dtype)
    snapshot, deltas = blobs[0], blobs[1:]
    sched = list(deltas)
    drop = int(rng.integers(len(sched)))
    dup = sched[int(rng.integers(len(sched)))]
    del sched[drop]
    sched.append(dup)
    rng.shuffle(sched)
    observable_gap = drop + 2 < 1 + len(deltas)

    feed = _ScriptedFeed()
    sub = Subscriber(feed, name=f"adv{seed}")
    feed.queue = [snapshot] + sched
    sub.poll()
    if sub.generation != pub.generation:
        if observable_gap:
            assert feed.resyncs, "an observable gap did not request a resync"
        pub.channel._requests.append({"subscriber": sub.name})
        pub.serve_resyncs()
        feed.queue = [pub.channel._log[-1][1]]
        sub.poll()
    assert sub.generation == pub.generation
    assert _leaves_bitwise_equal(sub, pub, reg)
    before = dict(sub.counters)
    feed.queue = list(sched)
    sub.poll()
    assert sub.generation == pub.generation
    assert sub.counters["applied_deltas"] == before["applied_deltas"]
    assert _leaves_bitwise_equal(sub, pub, reg)


@given(st.integers(min_value=0, max_value=10 ** 6))
@settings(max_examples=6, deadline=None)
def test_adversarial_stream_converges_f32(seed):
    _adversarial_converges(seed)


@given(st.integers(min_value=0, max_value=10 ** 6))
@settings(max_examples=6, deadline=None)
def test_adversarial_stream_converges_int8(seed):
    _adversarial_converges(seed, values_dtype="int8")


def test_deltas_before_bootstrap_request_resync():
    pub, reg, blobs = _publish_run(np.random.default_rng(0))
    feed = _ScriptedFeed()
    sub = Subscriber(feed)
    feed.queue = blobs[1:]
    sub.poll()
    assert sub.generation is None and feed.resyncs
    feed.queue = [blobs[0]] + blobs[1:]
    sub.poll()
    assert sub.generation == pub.generation
    assert _leaves_bitwise_equal(sub, pub, reg)


def test_incoherent_delta_rejected_all_or_nothing():
    pub, reg, blobs = _publish_run(np.random.default_rng(1), n_gens=1)
    feed = _ScriptedFeed()
    sub = Subscriber(feed)
    feed.queue = [blobs[0]]
    sub.poll()
    gen0, leaves0 = sub.generation, dict(sub.leaves)
    delta = D.decode(blobs[1])
    delta.stacks = delta.stacks[:1]
    feed.queue = [D.encode(delta)]
    sub.poll()
    assert sub.counters["rejected"] == 1
    assert sub.generation == gen0
    assert all(sub.leaves[k] is leaves0[k] for k in leaves0)
    assert feed.resyncs


def test_values_only_deltas_are_smaller_than_topology():
    rng = np.random.default_rng(2)
    reg = _tiny_registry()
    params, masks = _random_params(reg, rng), _random_masks(reg, rng)
    versions = {s.name: 0 for s in reg}
    pub = Publisher(_Cfg(), reg, QueueChannel(), path="condensed")
    snap = pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    params2, _, _ = _evolve(reg, params, masks, rng, rewire=False)
    vals = pub.publish(params=_torch(params2), masks=_torch(masks), mask_versions=versions)
    params3, masks3, changed = _evolve(reg, params2, masks, rng, rewire=True)
    versions2 = dict(versions, **{n: versions[n] + 1 for n in changed})
    topo = pub.publish(params=_torch(params3), masks=_torch(masks3), mask_versions=versions2)
    assert vals["kind"] == topo["kind"] == "delta"
    assert vals["topology"] == [] and topo["topology"] == changed
    assert vals["topology_bytes"] == 0
    assert vals["bytes"] < topo["bytes"] < snap["bytes"]


def test_publisher_rejects_live_weight_paths_and_tp():
    for path in ("masked", "auto", "structured"):
        with pytest.raises(ValueError):
            Publisher(_Cfg(), _tiny_registry(), QueueChannel(), path=path)
    with pytest.raises(ValueError, match="item 9"):
        Publisher(_Cfg(), _tiny_registry(), QueueChannel(), tp=2)


def test_dir_channel_pubsub_and_pruned_gap_resync(tmp_path):
    rng = np.random.default_rng(3)
    reg = _tiny_registry()
    params, masks = _random_params(reg, rng), _random_masks(reg, rng)
    versions = {s.name: 0 for s in reg}
    ch = DirChannel(str(tmp_path), retain=2)
    pub = Publisher(_Cfg(), reg, ch, path="condensed")
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    sub = Subscriber(ch.subscribe("r0"), name="r0")
    assert sub.wait_for_bootstrap(timeout=5.0) and sub.generation == 1
    for g in range(4):
        params, masks, changed = _evolve(reg, params, masks, rng, rewire=(g % 2 == 0))
        for name in changed:
            versions[name] += 1
        pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    sub.poll()
    assert sub.counters["gaps"] >= 1
    assert pub.serve_resyncs() >= 1
    sub.poll()
    assert sub.generation == pub.generation
    assert _leaves_bitwise_equal(sub, pub, reg)


def test_resync_storm_coalesces_to_one_snapshot():
    rng = np.random.default_rng(7)
    reg = _tiny_registry()
    params, masks = _random_params(reg, rng), _random_masks(reg, rng)
    versions = {s.name: 0 for s in reg}
    ch = QueueChannel()
    pub = Publisher(_Cfg(), reg, ch, path="condensed")
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    params, masks, changed = _evolve(reg, params, masks, rng)
    for name in changed:
        versions[name] += 1
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    sends0 = len(ch._log)
    for i in range(8):
        ch.subscribe(f"r{i}").request_resync("gap at generation 2", needed_generation=2)
    assert pub.serve_resyncs() == 8
    assert pub.counters == {"resync_requests": 8, "resync_snapshots": 1, "resync_coalesced": 7}
    assert len(ch._log) == sends0 + 1
    for i in range(8, 12):
        ch.subscribe(f"r{i}").request_resync("gap at generation 2", needed_generation=2)
    assert pub.serve_resyncs() == 4
    assert pub.counters["resync_snapshots"] == 1 and pub.counters["resync_coalesced"] == 11
    assert len(ch._log) == sends0 + 1
    params, masks, changed = _evolve(reg, params, masks, rng)
    for name in changed:
        versions[name] += 1
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    ch.subscribe("r0").request_resync("gap at generation 3", needed_generation=3)
    assert pub.serve_resyncs() == 1 and pub.counters["resync_snapshots"] == 2
    late = Subscriber(ch.subscribe("late"), name="late")
    late.poll()
    assert late.generation == pub.generation
    assert _leaves_bitwise_equal(late, pub, reg)


# ---------------------------------------------------------------------------
# across frameworks, through a DirChannel
# ---------------------------------------------------------------------------

def _assert_sub_equal(tsub: Subscriber, jsub, reg) -> None:
    """The port subscriber's merged state equals the JAX subscriber's:
    every array bitwise (bf16 compared through float32, exact), the
    statics, versions and generation."""
    assert tsub.generation == jsub.generation
    assert tsub.mask_versions == jsub.mask_versions
    assert tsub.meta == jsub.meta
    for s in reg:
        t, j = tsub.leaves[s.name], jsub.leaves[s.name]
        assert (t.format, t.static, t.mask_version) == (j.format, j.static, j.mask_version)
        assert set(t.arrays) == set(j.arrays)
        for f, arr in t.arrays.items():
            want = np.asarray(j.arrays[f])
            assert D._WIRE_NAMES[arr.dtype] == want.dtype.name
            got = arr.float().numpy() if arr.dtype == torch.bfloat16 else arr.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype))
    for name in ("params", "masks"):
        tflat, jflat = getattr(tsub, name), getattr(jsub, name)
        assert set(tflat) == set(jflat)
        for k in tflat:
            np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]))


def _records(path) -> list[bytes]:
    return [open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path)) if n.endswith(".rsd")]


@pytest.mark.parametrize("values_dtype", [None, "bf16", "int8"])
def test_jax_publisher_to_port_subscriber(tmp_path, values_dtype):
    rng = np.random.default_rng(11)
    jreg = _tiny_registry(JR)
    params, masks = _random_params(jreg, rng), _random_masks(jreg, rng)
    versions = {s.name: 0 for s in jreg}
    pub = JPublisher(_JCfg(), jreg, JDirChannel(str(tmp_path), retain=64), path="condensed",
                     values_dtype=values_dtype)
    tsub = Subscriber(DirChannel(str(tmp_path)).subscribe("port"), name="port")
    jsub = JSubscriber(JDirChannel(str(tmp_path)).subscribe("jax"), name="jax")
    pub.publish(params=jax.tree.map(jnp.asarray, params),
                masks=jax.tree.map(jnp.asarray, masks), mask_versions=versions)
    for g in range(3):
        params, masks, changed = _evolve(jreg, params, masks, rng, rewire=g == 1)
        for name in changed:
            versions[name] += 1
        pub.publish(params=jax.tree.map(jnp.asarray, params),
                    masks=jax.tree.map(jnp.asarray, masks), mask_versions=versions)
        tsub.poll()
        jsub.poll()
        _assert_sub_equal(tsub, jsub, jreg)
    assert tsub.generation == 4 and tsub.counters["applied_deltas"] == 3
    for blob in _records(tmp_path):            # byte for byte the same records
        assert D.encode(D.decode(blob)) == blob
    # the adopted leaves: the port's formats built from the port's records
    for s in jreg:
        leaf = D.wire_to_leaf(tsub.leaves[s.name])
        for f, t in leaf.arrays().items():
            assert torch.equal(t, tsub.leaves[s.name].arrays[f])


@pytest.mark.parametrize("values_dtype", [None, "int8"])
def test_port_publisher_to_jax_subscriber(tmp_path, values_dtype):
    rng = np.random.default_rng(12)
    reg = _tiny_registry()
    params, masks = _random_params(reg, rng), _random_masks(reg, rng)
    versions = {s.name: 0 for s in reg}
    pub = Publisher(_Cfg(), reg, DirChannel(str(tmp_path), retain=64), path="condensed",
                    values_dtype=values_dtype)
    jsub = JSubscriber(JDirChannel(str(tmp_path)).subscribe("jax"), name="jax")
    tsub = Subscriber(DirChannel(str(tmp_path)).subscribe("port"), name="port")
    pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
    for g in range(3):
        params, masks, changed = _evolve(reg, params, masks, rng, rewire=g == 1)
        for name in changed:
            versions[name] += 1
        pub.publish(params=_torch(params), masks=_torch(masks), mask_versions=versions)
        jsub.poll()
        tsub.poll()
        _assert_sub_equal(tsub, jsub, reg)
    assert jsub.generation == 4 and jsub.counters["applied_deltas"] == 3
    assert _leaves_bitwise_equal(tsub, pub, reg)
    for blob in _records(tmp_path):
        assert JD.encode(JD.decode(blob)) == blob


def test_tensor_parallel_stream_is_refused(tmp_path):
    rng = np.random.default_rng(13)
    jreg = [JR.SparseStack(path=("blk0", "w"), d_in=16, d_out=8, lead=(), density=0.5)]
    params, masks = _random_params(jreg, rng), _random_masks(jreg, rng)
    pub = JPublisher(_JCfg(), jreg, JDirChannel(str(tmp_path)), path="condensed", tp=2)
    pub.publish(params=jax.tree.map(jnp.asarray, params),
                masks=jax.tree.map(jnp.asarray, masks), mask_versions={jreg[0].name: 0})
    [blob] = _records(tmp_path)
    with pytest.raises(D.UnsupportedStreamError, match="item 9"):
        D.decode(blob)
    sub = Subscriber(DirChannel(str(tmp_path)).subscribe("port"))
    with pytest.raises(D.UnsupportedStreamError, match="item 9"):
        sub.poll()
    assert sub.generation is None


# ---------------------------------------------------------------------------
# the engine (smoke model)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    m = smoke_model()
    profile = TP.HardwareProfile(**{f.name: getattr(JP.DEFAULT_PROFILE, f.name)
                                    for f in dataclasses.fields(TP.HardwareProfile)})
    prompts = np.random.default_rng(1).integers(0, m["tcfg"].vocab_size, (2, 8)).astype(np.int32)
    return dict(m, profile=profile, prompts=prompts)


def _t(tree):
    return bridge.from_jax_numpy(jax.tree.map(np.asarray, tree))


def _bump(reg, params, masks, versions, *, stack_idx=0):
    """The reference test's generation step: one stack rewired at an
    unchanged fan-in, every float param times 1.01."""
    s = reg[stack_idx]
    masks2 = jax.tree.map(lambda x: x, masks)
    JR.set_path(masks2, s.path, jnp.roll(JR.get_path(masks2, s.path), 1, axis=-2))
    params2 = jax.tree.map(lambda x: x * 1.01, params)
    return params2, masks2, dict(versions, **{s.name: versions[s.name] + 1})


def _ablate(reg, masks, frac=0.25):
    out = {}
    for s in reg:
        m = JR.get_path(masks, s.path)
        cut = s.d_out - max(1, int(s.d_out * frac))
        JR._set_path(out, s.path, m & (jnp.arange(s.d_out) < cut)[None, :])
    return out


def test_attach_subscriber_rejects_live_weight_paths(smoke):
    for path in ("masked", "structured", "auto"):
        eng = TE.ServingEngine(smoke["tcfg"], smoke["tparams"], _t(smoke["jmasks"]),
                               smoke["treg"], path=path)
        with pytest.raises(ValueError):
            eng.attach_subscriber(Subscriber(_ScriptedFeed()))


@pytest.mark.parametrize("path,values_dtype,ablated", [("condensed", None, False),
                                                        ("condensed_over_active", None, True),
                                                        ("condensed", "int8", False)])
def test_engine_mid_generation_sync(smoke, tmp_path, path, values_dtype, ablated):
    """A topology delta lands at a chunk boundary mid-generation: written
    in place (no decode step made again, every leaf tensor kept), one
    topology export and values-only adoptions for the rest, and the tokens
    of the reference engine refreshed with the same weights at the same
    boundary; a replica restarted from the stream serves the live one's
    tokens."""
    jreg, treg, jparams = smoke["jreg"], smoke["treg"], smoke["jparams"]
    jmasks = _ablate(jreg, smoke["jmasks"]) if ablated else smoke["jmasks"]
    versions = {s.name: 0 for s in jreg}
    prompts = smoke["prompts"]
    ch = DirChannel(str(tmp_path))
    pub = Publisher(smoke["tcfg"], treg, ch, path=path, values_dtype=values_dtype,
                    batch_size=2)
    pub.publish(params=_t(jparams), masks=_t(jmasks), mask_versions=versions)

    sub = Subscriber(ch.subscribe("r0"))
    eng = engine_from_snapshot(smoke["tcfg"], sub, registry=treg, device="cpu", gen_chunk=4,
                               profile=smoke["profile"])
    rid = eng.submit(prompts, 16)
    eng.step(max_chunks=2)

    params2, masks2, versions2 = _bump(jreg, jparams, jmasks, versions)
    info = pub.publish(params=_t(params2), masks=_t(masks2), mask_versions=versions2)
    assert info["topology"] == [jreg[0].name]
    plan = eng.plan_for(eng.plan_key(2))
    ptrs = {s.name: {f: t.data_ptr() for f, t in REG.get_path(plan.serving_tree, s.path)
                     .arrays().items()} for s in treg}
    captures, programs = eng.captures, eng.program_count("decode")
    ec, vr = plan.export_calls, plan.value_refreshes
    eng.step()
    [res] = eng.retire(rid)
    assert eng._sync_generation == 2
    assert (eng.captures, eng.program_count("decode")) == (captures, programs)
    assert not res.cold
    assert (plan.export_calls, plan.value_refreshes) == (ec + 1, vr + len(treg) - 1)
    assert {s.name: {f: t.data_ptr() for f, t in REG.get_path(plan.serving_tree, s.path)
                     .arrays().items()} for s in treg} == ptrs

    jeng = JE.ServingEngine(smoke["jcfg"], jparams, jmasks, jreg, path=path,
                            mask_versions=dict(versions), gen_chunk=4, values_dtype=values_dtype)
    jrid = jeng.submit(jnp.asarray(prompts), 16)
    jeng.step(max_chunks=2)
    jeng.refresh(params2, masks2, versions2, donate=False)
    jeng.step()
    [jres] = jeng.retire(jrid)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))

    rid_a = eng.submit(prompts, 8)
    eng.step()
    [res_a] = eng.retire(rid_a)
    eng3 = engine_from_snapshot(smoke["tcfg"], Subscriber(ch.subscribe("r1"), name="r1"),
                                registry=treg, device="cpu", gen_chunk=4,
                                profile=smoke["profile"])
    rid_b = eng3.submit(prompts, 8)
    eng3.step()
    [res_b] = eng3.retire(rid_b)
    assert eng3._sync_generation == 2
    np.testing.assert_array_equal(res_a.tokens.numpy(), res_b.tokens.numpy())


def test_serve_cli_bootstraps_from_a_sync_dir(smoke, tmp_path, capsys):
    """``repro_torch.launch.serve --sync-dir`` serves the published stream
    (its path and values dtype), not its local init: the first stream equals
    an engine built on the published trees."""
    from repro_torch.launch import serve as TS
    pub = Publisher(smoke["tcfg"], smoke["treg"], DirChannel(str(tmp_path)),
                    path="condensed_over_active", batch_size=2)
    pub.publish(params=smoke["tparams"], masks=_t(smoke["jmasks"]),
                mask_versions={s.name: 0 for s in smoke["treg"]})
    toks = TS.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--path", "condensed",
                    "--batch", "2", "--prompt-len", "8", "--gen", "4",
                    "--sync-dir", str(tmp_path), "--sync-wait", "5"])
    out = capsys.readouterr().out
    assert "stream publishes path='condensed_over_active'" in out
    assert "[serve] bootstrapped at generation 1 (path=condensed_over_active" in out
    assert "[serve:sync] generation 1 | applied 0 delta(s) + 1 snapshot(s)" in out
    eng = TE.ServingEngine(smoke["tcfg"], smoke["tparams"], _t(smoke["jmasks"]), smoke["treg"],
                           path="condensed_over_active")
    rid = eng.submit(toks[:, :8], 4)
    eng.step()
    [res] = eng.retire(rid)
    assert torch.equal(res.tokens, toks)
    with pytest.raises(SystemExit, match="no snapshot appeared"):
        TS.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--path", "condensed",
                 "--sync-dir", str(tmp_path / "empty"), "--sync-wait", "0.2"])
