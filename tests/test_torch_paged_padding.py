"""The paged engine's padding rows against the JAX reference on the CPU.

Every idle row of a bucket-padded dispatch writes the reserved garbage page
0 at once, and an MoE layer routes those rows into the real rows' expert
capacity. So the real rows' tokens depend on what page 0 holds, and page 0
on which of the colliding writes lands. The reference's scatter on the CPU
keeps the last write in (B, T) order; the port's ``paged_cache_write``
keeps it on any device (``attention.last_writer``). Pools and tokens are
held equal exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.launch import engine as JE  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

from _torch_zoo_model import _model, _prompts  # noqa: E402

GRANITE = "granite-moe-1b-a400m"


def _colliding_writes(seed: int):
    """Five rows, two live (tables [1, 2, 3] and [4, 5, 6]) and three idle
    (all-zero tables), nine positions each: the idle rows' writes and the
    live rows' overshoot past their extent collide."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((7, 4, 2, 3)).astype(np.float32)
    new = rng.standard_normal((5, 9, 2, 3)).astype(np.float32)
    table = np.zeros((5, 2), np.int32)
    table[0], table[3] = [1, 2], [4, 5]
    pos = (np.arange(9)[None] + np.asarray([[0], [2], [0], [1], [5]])).astype(np.int32)
    return pool, new, table, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_colliding_writes_keep_the_last_writer_as_the_reference(seed):
    pool, new, table, pos = _colliding_writes(seed)
    jk, jv = JA.paged_cache_write(jnp.asarray(pool), jnp.asarray(pool) * 2, jnp.asarray(new),
                                  jnp.asarray(new) * 2, jnp.asarray(table), jnp.asarray(pos))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool * 2)
    TA.paged_cache_write(tk, tv, torch.from_numpy(new), torch.from_numpy(new * 2),
                         torch.from_numpy(table), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the last writer of each slot, by brute force, and the pool a device
    # gets in either order of applying the writes
    bs, nb = pool.shape[1], table.shape[1]
    blk = np.take_along_axis(table, np.minimum(pos // bs, nb - 1), 1).reshape(-1)
    off = (pos % bs).reshape(-1)
    slots = blk * bs + off
    want = np.asarray([max(j for j in range(slots.size) if slots[j] == s) for s in slots])
    src = TA.last_writer(torch.from_numpy(slots), pool.shape[0] * bs).numpy()
    np.testing.assert_array_equal(src, want)
    assert len(set(slots)) < slots.size          # the case has collisions
    vals = new.reshape(-1, 2, 3)[src]
    for order in (range(slots.size), reversed(range(slots.size))):
        p = pool.copy()
        for i in order:
            p[blk[i], off[i]] = vals[i]
        np.testing.assert_array_equal(p, tk.numpy())


def _tokens(eng, to, prompts):
    rid = eng.submit(to(prompts), 8)
    eng.step()
    [res] = eng.retire(rid)
    return np.asarray(res.tokens)


def _first_writer(slots, n_slots):
    order = torch.arange(slots.numel(), device=slots.device)
    first = torch.full((n_slots,), slots.numel(), dtype=torch.long, device=slots.device)
    first.scatter_reduce_(0, slots, order, reduce="amin")
    return first[slots]


@pytest.mark.parametrize("b", [3, 5])
def test_padding_rows_reach_the_real_rows_as_in_the_reference(monkeypatch, b):
    """granite smoke on condensed: B rows at bucket 8 (8 - B padding rows),
    decode groups of 8 rows with capacity 5 an expert, so the padding rows
    take capacity from the real ones. The port's tokens equal the reference
    engine's; with the first colliding write kept instead of the last,
    they do not: what page 0 holds reaches the real rows' tokens."""
    m = _model(GRANITE, ())
    prompts = _prompts(m["tcfg"], b, 20, seed=1)

    def port():
        return _tokens(TE.ServingEngine(m["tcfg"], m["tparams"], m["tmasks"], m["treg"],
                                        path="condensed"), torch.from_numpy, prompts)
    want = _tokens(JE.ServingEngine(m["jcfg"], m["jparams"], m["jmasks"], m["jreg"],
                                    path="condensed"), jnp.asarray, prompts)
    np.testing.assert_array_equal(port(), want)
    monkeypatch.setattr(TA, "last_writer", _first_writer)
    assert not np.array_equal(port(), want)
