"""The port's paged KV cache against the reference's, on the CPU.

* Host-side accounting (``models/paged.py``): ``pages_for``,
  ``rewind_pages`` and ``BlockAllocator`` give exactly the reference's page
  ids for the same operations; page 0 is never handed out.
* The device primitives (``attention.paged_decode_attention``,
  ``paged_cache_write``) and the model steps (``model.paged_prefill_step``,
  ``paged_decode_step``) on the same inputs as the reference's, float32:
  attention within 1e-6, written pools exactly, logits within 1e-4 and
  pools within 1e-5 (the sums run in other orders).
* Within the port, bitwise: paged write-then-attend == contiguous
  attention; slots past a stream's length contribute exact zeros; an
  overshooting write lands in the garbage page; paged generation (bucket
  padding, scattered rows, a right-padded prompt) == contiguous
  ``generate``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import paged as JPG  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import paged as TPG  # noqa: E402

from _torch_smoke_model import smoke_model  # noqa: E402

HEAD_TO_KV = (0, 0, 1, 1)


# ---------------------------------------------------------------------------
# host-side accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,bs", [(0, 16), (1, 16), (16, 16), (17, 16), (-3, 16),
                                       (37, 4), (120, 5)])
def test_pages_for_matches_reference(tokens, bs):
    assert TPG.pages_for(tokens, bs) == JPG.pages_for(tokens, bs)


def test_allocator_reserves_page_zero():
    al = TPG.BlockAllocator(5)
    assert al.available == 4
    assert sorted(al.alloc(4)) == [1, 2, 3, 4]
    with pytest.raises(ValueError, match="reserved"):
        al.release([0])
    with pytest.raises(ValueError):
        TPG.BlockAllocator(0)


def test_allocator_alloc_release_grow_give_the_reference_page_ids():
    """The same operations on both allocators hand out the same pages (LIFO
    reuse), fail alike and end with the same free list."""
    got = []
    for PG in (TPG, JPG):
        al = PG.BlockAllocator(8)
        a, b = al.alloc(3), al.alloc(2)
        al.release(a)
        with pytest.raises(ValueError, match="double free"):
            al.release(a)
        c = al.alloc(5)
        assert not (set(b) & set(c))
        with pytest.raises(RuntimeError, match="exhausted"):
            al.alloc(1)
        al.grow(11)
        with pytest.raises(ValueError, match="only grow"):
            al.grow(4)
        got.append((a, b, c, al.alloc(3), al.available, al.num_blocks))
    assert got[0] == got[1]


def test_rewind_pages_matches_reference():
    rows, frees = [], []
    for PG in (TPG, JPG):
        al = PG.BlockAllocator(10)
        row = np.zeros(6, np.int32)
        row[:5] = al.alloc(5)
        frees.append((PG.rewind_pages(row, al, 9, 4), PG.rewind_pages(row, al, 9, 4)))
        rows.append((row.tolist(), al.available))
    assert rows[0] == rows[1] and frees[0] == frees[1] == (2, 0)


# ---------------------------------------------------------------------------
# device primitives against the reference
# ---------------------------------------------------------------------------

def _pool_inputs(seed=0, b=2, s=12, hkv=2, h=4, d=8, bs=4, pages=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(q=rng.standard_normal((b, 1, h, d)).astype(f),
                k=rng.standard_normal((b, s, hkv, d)).astype(f),
                v=rng.standard_normal((b, s, hkv, d)).astype(f),
                pk=rng.standard_normal((pages, bs, hkv, d)).astype(f),
                pv=rng.standard_normal((pages, bs, hkv, d)).astype(f),
                table=np.asarray([[7, 3, 11], [2, 9, 5]], np.int32))


@pytest.mark.parametrize("t,start,shift", [(12, 0, 0), (1, 5, 2), (3, 9, 2)])
def test_paged_cache_write_matches_reference(t, start, shift):
    """Rows at their own positions, some past the table's extent (they clamp
    into its last page; no two writes of a call land on one slot): the
    written pools are exactly the reference's."""
    x = _pool_inputs(seed=t)
    pos = (np.asarray([[start], [start + shift]]) + np.arange(t)[None]).astype(np.int32)
    jk, jv = JA.paged_cache_write(jnp.asarray(x["pk"]), jnp.asarray(x["pv"]),
                                  jnp.asarray(x["k"][:, :t]), jnp.asarray(x["v"][:, :t]),
                                  jnp.asarray(x["table"]), jnp.asarray(pos))
    tk, tv = torch.from_numpy(x["pk"].copy()), torch.from_numpy(x["pv"].copy())
    gk, gv = TA.paged_cache_write(tk, tv, torch.from_numpy(x["k"][:, :t]),
                                  torch.from_numpy(x["v"][:, :t]),
                                  torch.from_numpy(x["table"]), torch.from_numpy(pos))
    assert gk is tk and gv is tv  # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("lengths", [(12, 12), (5, 1), (9, 11)])
def test_paged_decode_attention_matches_reference(lengths):
    x = _pool_inputs(seed=sum(lengths))
    lens = np.asarray(lengths, np.int32)
    want = JA.paged_decode_attention(jnp.asarray(x["q"]), jnp.asarray(x["pk"]),
                                     jnp.asarray(x["pv"]), jnp.asarray(x["table"]),
                                     jnp.asarray(lens), head_to_kv=HEAD_TO_KV)
    got = TA.paged_decode_attention(torch.from_numpy(x["q"]), torch.from_numpy(x["pk"]),
                                    torch.from_numpy(x["pv"]), torch.from_numpy(x["table"]),
                                    torch.from_numpy(lens), head_to_kv=HEAD_TO_KV)
    assert got.shape == (2, 1, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# device primitives within the port: paged == contiguous, exact masking
# ---------------------------------------------------------------------------

def test_paged_write_then_attend_matches_contiguous():
    """Tokens scattered through a table of shuffled, non-adjacent pages into
    a pool of garbage, read back by paged attention: bitwise the contiguous
    decode attention over the same content."""
    x = _pool_inputs(seed=3)
    k, v, table = (torch.from_numpy(x[n]) for n in ("k", "v", "table"))
    ref = TA.decode_attention(torch.from_numpy(x["q"]), k, v, 12, head_to_kv=HEAD_TO_KV)
    pk, pv = torch.from_numpy(x["pk"]), torch.from_numpy(x["pv"])
    pos = torch.arange(12)[None].expand(2, 12)
    TA.paged_cache_write(pk, pv, k, v, table, pos)
    out = TA.paged_decode_attention(torch.from_numpy(x["q"]), pk, pv, table,
                                    torch.full((2,), 12, dtype=torch.int32),
                                    head_to_kv=HEAD_TO_KV)
    assert torch.equal(out, ref)


def test_paged_attention_masks_beyond_length_exactly():
    """Slots at or after a stream's length contribute exact zeros: the result
    does not depend on the unread tail of its pages or on page 0."""
    x = _pool_inputs(seed=4, b=1)
    q = torch.from_numpy(x["q"])
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.tensor([5], dtype=torch.int32)
    pk, pv = torch.from_numpy(x["pk"][:3]), torch.from_numpy(x["pv"][:3])
    out1 = TA.paged_decode_attention(q, pk, pv, table, lengths, head_to_kv=HEAD_TO_KV)
    junk_k, junk_v = pk.clone(), pv.clone()
    junk_k[2, 1:], junk_v[2, 1:] = 99.0, -99.0
    junk_k[0], junk_v[0] = -7.0, 7.0
    out2 = TA.paged_decode_attention(q, junk_k, junk_v, table, lengths, head_to_kv=HEAD_TO_KV)
    assert torch.equal(out1, out2)


def test_paged_write_overshoot_lands_in_garbage_page():
    """A position past a table's extent clamps into its last entry; an idle
    row's all-zero table pins the write to page 0."""
    pk, pv = torch.zeros((3, 4, 1, 2)), torch.zeros((3, 4, 1, 2))
    live = pk[1:].clone()
    TA.paged_cache_write(pk, pv, torch.ones((1, 1, 1, 2)), torch.ones((1, 1, 1, 2)),
                         torch.zeros((1, 2), dtype=torch.int32), torch.tensor([[37]]))
    assert torch.equal(pk[1:], live)
    assert float(pk[0].sum()) != 0.0


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def test_supports_paged_matches_reference():
    m = smoke_model()
    for kw in ({}, {"sliding_window": 16}, {"mrope": True}, {"family": "ssm"},
               {"local_global_ratio": 5}, {"causal": False}):
        assert (TM.supports_paged(m["tcfg"].replace(**kw))
                == JM.supports_paged(m["jcfg"].replace(**kw))), kw
    assert TM.supports_paged(m["tcfg"])


def test_init_paged_pool_shapes():
    m = smoke_model()
    cfg = m["tcfg"]
    pool = TM.init_paged_pool(cfg, num_blocks=7, block_size=4, device="cpu")
    want = JM.init_paged_pool(m["jcfg"], num_blocks=7, block_size=4)
    assert pool.keys() == want.keys()
    for k in pool:
        assert tuple(pool[k].shape) == want[k].shape == (
            cfg.n_layers, 7, 4, cfg.n_kv_heads_padded, cfg.head_dim)
        assert not pool[k].any()


def _padded_batch(cfg, rng, bucket=8, t=8, rows=(5, 2), takes=(8, 6), nb=4, bs=4):
    """A bucket-padded admission: two prompts (the second right-padded) in
    scattered rows, their own pages, idle rows at page 0."""
    tokens = np.zeros((bucket, t), np.int32)
    table = np.zeros((bucket, nb), np.int32)
    lens = np.zeros((bucket,), np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (len(rows), t)).astype(np.int32)
    for i, (row, take) in enumerate(zip(rows, takes)):
        tokens[row, :take] = prompts[i, :take]
        table[row] = 1 + i * nb + np.arange(nb)
        lens[row] = take
    return prompts, tokens, table, lens


def test_paged_prefill_and_decode_steps_match_reference():
    """One bucket-padded paged prefill and two paged decode steps, on the
    reference's smoke weights and on the bridged port, float32."""
    m = smoke_model()
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    _, tokens, table, lens = _padded_batch(tcfg, np.random.default_rng(0))
    n_pages = 1 + 2 * 4
    jpool = JM.init_paged_pool(jcfg, n_pages, 4)
    jl, jpool = jax.jit(JM.paged_prefill_step, static_argnums=0)(
        jcfg, m["jparams"], m["jmasks"], {"tokens": jnp.asarray(tokens)}, jpool,
        jnp.asarray(table), jnp.asarray(lens))
    tmasks = {"blocks": {k: torch.from_numpy(np.array(v))
                         for k, v in m["jmasks"]["blocks"].items()}}
    tpool = TM.init_paged_pool(tcfg, n_pages, 4, device="cpu")
    tl, _ = TM.paged_prefill_step(tcfg, m["tparams"], tmasks, {"tokens": torch.from_numpy(tokens)},
                                  tpool, torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    live = [1, 2, 3, 4, 5, 6, 7, 8]
    for k in ("pk", "pv"):
        np.testing.assert_allclose(tpool[k].numpy()[:, live], np.asarray(jpool[k])[:, live],
                                   atol=1e-5, rtol=0)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    assert np.array_equal(TE._greedy(tl).numpy(), cur)
    jstep = jax.jit(JM.paged_decode_step, static_argnums=0)
    lengths = lens.copy()
    for _ in range(2):
        jl, jpool = jstep(jcfg, m["jparams"], m["jmasks"], {"tokens": jnp.asarray(cur)}, jpool,
                          jnp.asarray(table), jnp.asarray(lengths))
        tl, _ = TM.paged_decode_step(tcfg, m["tparams"], tmasks, {"tokens": torch.from_numpy(cur)},
                                     tpool, torch.from_numpy(table), torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        for k in ("pk", "pv"):
            np.testing.assert_allclose(tpool[k].numpy()[:, live],
                                       np.asarray(jpool[k])[:, live], atol=1e-5, rtol=0)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        lengths = lengths + 1


def test_paged_generation_bitwise_matches_contiguous():
    """Bucket padding (2 live streams of an 8-row dispatch), scattered rows,
    a prompt right-padded past its length and a garbage page written by the
    pad rows: every live stream emits exactly its contiguous ``generate``
    tokens, decoded through the engine's own step function."""
    m = smoke_model()
    cfg, params = m["tcfg"], m["tparams"]
    masks = {"blocks": {k: torch.from_numpy(np.array(v))
                        for k, v in m["jmasks"]["blocks"].items()}}
    gen, bs, rows, takes = 5, 4, (5, 2), (8, 6)
    nb = TPG.pages_for(8 + gen, bs)
    prompts, tokens, table, lens = _padded_batch(cfg, np.random.default_rng(7), nb=nb, bs=bs)
    pool = TM.init_paged_pool(cfg, 1 + 8 * nb, bs, device="cpu")
    with torch.no_grad():
        logits, _ = TM.paged_prefill_step(cfg, params, masks, {"tokens": torch.from_numpy(tokens)},
                                          pool, torch.from_numpy(table), torch.from_numpy(lens))
    st = TE._new_state(8, gen, "cpu", pool=pool, table=torch.from_numpy(table),
                       lengths=torch.from_numpy(lens.copy()))
    st.cur.copy_(TE._greedy(logits))
    dec = TE._Decoder(lambda: TE._paged_step(cfg, params, masks, st), st)
    dec.run(gen)
    assert torch.equal(st.lengths, torch.from_numpy(lens) + gen)
    for i, (row, take) in enumerate(zip(rows, takes)):
        ref = TE.generate(cfg, params, masks, torch.from_numpy(prompts[i:i + 1, :take]), gen)
        assert torch.equal(st.toks[row], ref[0, take:])
