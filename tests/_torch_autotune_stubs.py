"""The launch search's test scaffolding shared by ``test_torch_autotune.py``
and ``test_torch_lead2_autotune.py``: the port's and the reference's cache
files in a temp dir (``caches``), and the reference's timed searches as
stubs that keep one entry under the key each would write."""
import jax.numpy as jnp
import pytest
from repro.sparse import autotune as JAT
from repro.sparse import formats as JF
from repro_torch.sparse import autotune as AT


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """The port's and the reference's cache files, each in its own place."""
    port, ref = tmp_path / "port.json", tmp_path / "reference.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(port))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(ref))
    AT.reset_cache_state()
    JAT.reset_cache_state()
    yield port, ref
    AT.reset_cache_state()
    JAT.reset_cache_state()


def _stub_reference_search(monkeypatch):
    """The reference's three searches as stubs that keep one entry under
    the key each would write (its interpret-mode timing is not needed to
    hold the keys and labels)."""
    def keep(key):
        return JAT._finish_result(key, [(128, 128)], {"128x128": 1.0}, default_label="128x128",
                                  interpret=True, save=True)

    def blocks(batch, d_in, n_out, k, *, dtype=jnp.float32, backend=None, values_dtype=None,
               **_):
        return keep(JF.shape_tuning_key(d_in, n_out, k, batch, backend=backend,
                                        itemsize=jnp.dtype(dtype).itemsize,
                                        values_dtype=values_dtype))

    def coa(batch, d_in, a, k, d_out, *, dtype=jnp.float32, backend=None, values_dtype=None,
            **_):
        return keep(JF.shape_tuning_key(d_in, a, k, batch, backend=backend,
                                        itemsize=jnp.dtype(dtype).itemsize, kind="coa",
                                        scatter_width=d_out, values_dtype=values_dtype))

    def structured(batch, d_in, a, d_out, *, dtype=jnp.float32, backend=None,
                   values_dtype=None, **_):
        return keep(JF.shape_tuning_key(d_in, a, 0, batch, backend=backend,
                                        itemsize=jnp.dtype(dtype).itemsize, kind="structured",
                                        scatter_width=d_out, values_dtype=values_dtype))

    monkeypatch.setattr(JAT, "autotune_blocks", blocks)
    monkeypatch.setattr(JAT, "autotune_coa_blocks", coa)
    monkeypatch.setattr(JAT, "autotune_structured_blocks", structured)
