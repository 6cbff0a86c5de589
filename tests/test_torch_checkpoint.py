"""Serving checkpoints across frameworks: the reference's
``repro.train.checkpoint`` and the port's ``repro_torch.train.checkpoint``
write the same ``step_<N>/arrays.npz`` + ``manifest.json`` layout.

* A state with int8, fp8, bf16 and float32 serving leaves saved by the
  reference restores into the port with every array bitwise equal. numpy
  stores bf16 and fp8 as raw bytes (``|V2``, ``|V1``), which the reference's
  own ``restore`` cannot read back: that fault stays visible here.
* The port's ``save`` restores through the reference's ``restore`` (int8
  and float32 leaves).
* A float32 archive restores into an int8 template (quantized on restore)
  and an int8 archive into a float32 template (dequantized), as the
  reference's ``tests/test_quantized.py`` checks on its own side, with the
  same arrays as the reference's restore.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import typing  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro import configs as JCfg  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import state as JSt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import state as TSt  # noqa: E402

D_IN, D_OUT, K = 48, 40, 7
# leaf name -> (format, values dtype)
LEAVES = {"cond_int8": ("condensed", "int8"), "coa_fp8": ("condensed_over_active", "fp8"),
          "struct_int8": ("structured", "int8"), "struct_fp8": ("structured", "fp8"),
          "cond_bf16": ("condensed", "bf16"), "cond_f32": ("condensed", None),
          "mask": ("masked", None)}


class JState(typing.NamedTuple):
    step: jnp.int32
    serve: dict


class TState(typing.NamedTuple):
    step: torch.Tensor
    serve: dict


def _wm(seed):
    """(2, D_IN, D_OUT) weights and a constant fan-in mask with the last
    quarter of the neurons ablated."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, D_IN, D_OUT)).astype(np.float32)
    mask = np.zeros(w.shape, bool)
    for layer in range(2):
        for c in range(D_OUT - D_OUT // 4):
            mask[layer, rng.choice(D_IN, size=K, replace=False), c] = True
    return w, mask


def _jtree(seed, leaves=LEAVES):
    w, m = _wm(seed)
    return {name: JF.FORMATS[fmt].export_from_dense(jnp.asarray(w), jnp.asarray(m),
                                                   **({} if fmt == "masked"
                                                      else {"quantize_spec": qdt}))
            for name, (fmt, qdt) in leaves.items()}


def _ttree(seed, leaves=LEAVES):
    w, m = _wm(seed)
    return {name: TF.FORMATS[fmt].export_from_dense(torch.from_numpy(w), torch.from_numpy(m),
                                                   **({} if fmt == "masked"
                                                      else {"quantize_spec": qdt}))
            for name, (fmt, qdt) in leaves.items()}


def _bits(a) -> np.ndarray:
    """A tensor or reference array as numpy; bf16 and fp8 as their raw bits."""
    if isinstance(a, torch.Tensor):
        views = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}
        a = a.detach().contiguous()
        return (a.view(views[a.dtype]) if a.dtype in views else a).numpy()
    a = np.asarray(a)
    views = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}
    return a.view(views[a.dtype.name]) if a.dtype.name in views else a


def _flat_j(tree):
    return {k: v for k, v in JCK._flatten(tree).items() if v is not None}


def _flat_t(tree):
    return bridge.flatten(tree)


def _assert_same_arrays(jtree, ttree):
    jflat, tflat = _flat_j(jtree), _flat_t(ttree)
    assert sorted(tflat) == sorted(jflat)
    for k, j in jflat.items():
        t = tflat[k]
        assert t.dtype.itemsize == np.asarray(j).dtype.itemsize, k
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=k)


def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path):
    jtree = _jtree(seed=1)
    JCK.save(str(tmp_path), JState(step=jnp.int32(5), serve=jtree))
    got = TCK.restore(str(tmp_path), 5, TState(step=torch.tensor(0, dtype=torch.int32),
                                               serve=_ttree(seed=2)))
    assert int(got.step) == 5 and got.step.dtype == torch.int32
    _assert_same_arrays(jtree, got.serve)
    for name, (_, qdt) in LEAVES.items():
        leaf = got.serve[name]
        assert getattr(leaf, "values_dtype", None) == (qdt if qdt in ("int8", "fp8") else None)
    assert got.serve["coa_fp8"].values.dtype == torch.float8_e4m3fn
    assert got.serve["cond_bf16"].values.dtype == torch.bfloat16
    assert got.serve["struct_fp8"].scales.shape == got.serve["struct_fp8"].active_index.shape
    x = torch.randn(3, D_IN)
    for name in ("cond_int8", "coa_fp8", "struct_int8"):
        want = _ttree(seed=1, leaves={name: LEAVES[name]})[name]
        assert torch.equal(got.serve[name].layer(0).apply(x), want.layer(0).apply(x))


@pytest.mark.parametrize("name,stored,error,says", [
    ("coa_fp8", "|V1", TypeError, r"\|V1 is not a valid JAX array type"),
    ("cond_bf16", "|V2", ValueError, "No cast function available")])
def test_the_reference_cannot_restore_its_own_fp8_and_bf16_archives(tmp_path, name, stored,
                                                                    error, says):
    """numpy writes ml_dtypes arrays as raw bytes; the reference's restore
    hands those to JAX as they are and fails (logged in ROADMAP.md)."""
    leaves = {name: LEAVES[name]}
    JCK.save(str(tmp_path), JState(step=jnp.int32(1), serve=_jtree(seed=1, leaves=leaves)))
    with np.load(os.path.join(tmp_path, "step_0000000001", "arrays.npz")) as npz:
        assert npz[f"serve/{name}/values"].dtype.str == stored
    with pytest.raises(error, match=says):
        JCK.restore(str(tmp_path), 1, JState(step=jnp.int32(0),
                                             serve=_jtree(seed=2, leaves=leaves)))
    got = TCK.restore(str(tmp_path), 1, TState(step=torch.tensor(0),
                                               serve=_ttree(seed=2, leaves=leaves)))
    _assert_same_arrays(_jtree(seed=1, leaves=leaves), got.serve)


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    leaves = {k: LEAVES[k] for k in ("cond_int8", "struct_int8", "cond_f32", "mask")}
    ttree = _ttree(seed=3, leaves=leaves)
    path = TCK.save(str(tmp_path), TState(step=torch.tensor(9, dtype=torch.int32),
                                          serve=ttree))
    assert os.path.basename(path) == "step_0000000009"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"step": 9, "keys": sorted(["step", *(f"serve/{k}" for k in
                                                             _flat_t(ttree))])}
    got = JCK.restore(str(tmp_path), 9, JState(step=jnp.int32(0),
                                               serve=_jtree(seed=4, leaves=leaves)))
    assert int(got.step) == 9
    _assert_same_arrays(got.serve, ttree)


def test_port_writes_bf16_and_fp8_in_the_references_raw_byte_layout(tmp_path):
    leaves = {k: LEAVES[k] for k in ("coa_fp8", "cond_bf16")}
    TCK.save(str(tmp_path), TState(step=torch.tensor(2, dtype=torch.int32),
                                   serve=_ttree(seed=5, leaves=leaves)))
    JCK.save(str(tmp_path / "ref"), JState(step=jnp.int32(2),
                                          serve=_jtree(seed=5, leaves=leaves)))
    with np.load(os.path.join(tmp_path, "step_0000000002", "arrays.npz")) as mine, \
            np.load(os.path.join(tmp_path, "ref", "step_0000000002", "arrays.npz")) as ref:
        assert sorted(mine.files) == sorted(ref.files)
        for k in ref.files:
            assert mine[k].dtype == ref[k].dtype, k
            assert mine[k].tobytes() == ref[k].tobytes(), k
    got = TCK.restore(str(tmp_path), 2, TState(step=torch.tensor(0),
                                               serve=_ttree(seed=6, leaves=leaves)))
    _assert_same_arrays(_jtree(seed=5, leaves=leaves), got.serve)


def test_float_archive_requantizes_into_an_int8_template(tmp_path):
    """As the reference: the archive's float values are quantized and the
    missing scales derived from them, not kept from the template."""
    leaves = {"stack": ("condensed", None)}
    JCK.save(str(tmp_path), JState(step=jnp.int32(1), serve=_jtree(seed=7, leaves=leaves)))
    q_leaves = {"stack": ("condensed", "int8")}
    got = TCK.restore(str(tmp_path), 1, TState(step=torch.tensor(0),
                                               serve=_ttree(seed=8, leaves=q_leaves)))
    want = JCK.restore(str(tmp_path), 1, JState(step=jnp.int32(0),
                                                serve=_jtree(seed=8, leaves=q_leaves)))
    leaf = got.serve["stack"]
    assert leaf.values_dtype == "int8" and leaf.values.dtype == torch.int8
    _assert_same_arrays(want.serve, got.serve)
    f32 = _ttree(seed=7, leaves=leaves)["stack"]
    q, s = TF.quantize_values(f32.values, "int8")
    assert torch.equal(leaf.values, q) and torch.equal(leaf.scales, s)


@pytest.mark.parametrize("fmt", ["condensed", "condensed_over_active", "structured"])
def test_int8_archive_dequantizes_into_a_float_template(tmp_path, fmt):
    q_leaves = {"stack": (fmt, "int8")}
    JCK.save(str(tmp_path), JState(step=jnp.int32(3), serve=_jtree(seed=9, leaves=q_leaves)))
    template = {"stack": (fmt, None)}
    got = TCK.restore(str(tmp_path), 3, TState(step=torch.tensor(0),
                                               serve=_ttree(seed=10, leaves=template)))
    leaf = got.serve["stack"]
    qfmt = _ttree(seed=9, leaves=q_leaves)["stack"]
    axis = -2 if fmt == "structured" else -1
    assert leaf.values_dtype is None and leaf.scales is None
    assert leaf.values.dtype == torch.float32
    assert torch.equal(leaf.values, TF.dequantize_values(qfmt.values, qfmt.scales, axis=axis))
    if fmt != "structured":  # the reference's float structured leaf has no panel to read
        want = JCK.restore(str(tmp_path), 3, JState(step=jnp.int32(0),
                                                    serve=_jtree(seed=10, leaves=template)))
        _assert_same_arrays(want.serve, got.serve)
    x = torch.randn(2, 3, D_IN)
    w = torch.from_numpy(_wm(9)[0][0])
    assert torch.allclose(leaf.layer(0).apply(x, w), qfmt.layer(0).apply(x, w), atol=1e-5)


def test_steps_keep_and_atomic_rename(tmp_path):
    tree = _ttree(seed=11, leaves={"stack": ("condensed", "int8")})
    for step in (3, 1, 4, 2):
        TCK.save(str(tmp_path), TState(step=torch.tensor(step), serve=tree), keep=2)
    assert TCK.all_steps(str(tmp_path)) == [3, 4] and TCK.latest_step(str(tmp_path)) == 4
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert TCK.all_steps(str(tmp_path / "none")) == [] and TCK.latest_step(str(tmp_path)) == 4
    # a dict template and a key the archive lacks (kept from the template)
    extra = torch.arange(3)
    got = TCK.restore(str(tmp_path), 4, {"step": torch.tensor(0), "serve": tree,
                                         "new": extra})
    assert int(got["step"]) == 4 and got["new"] is extra
    assert torch.equal(got["serve"]["stack"].values, tree["stack"].values)


def _jstate_numpy(state) -> dict:
    """The reference's TrainState as {"a/b": numpy}."""
    return bridge.flatten(jax.tree.map(np.asarray, state)._asdict())


def test_train_state_round_trips_across_frameworks(tmp_path):
    """A whole smoke TrainState (params, AdamW mu/nu/count, masks,
    neuron_active, mask_versions, the uint32 rng key): the reference's save
    restores into a port-initialized template bitwise, and the port's save
    of it restores through the reference's restore bitwise."""
    jcfg = JCfg.get_smoke_config("qwen3-1.7b")
    js = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    js = js._replace(
        step=jnp.int32(3),
        opt_state={"mu": jax.tree.map(lambda t: t + 0.5, js.opt_state["mu"]),
                   "nu": js.opt_state["nu"], "count": jnp.int32(3)},
        mask_versions={k: jnp.int32(i + 1) for i, k in enumerate(sorted(js.mask_versions))})
    want = _jstate_numpy(js)
    template = TSt.init_train_state(TCfg.get_smoke_config("qwen3-1.7b"),
                                    torch.Generator().manual_seed(1))
    assert sorted(bridge.flatten(bridge.train_state_to_jax_numpy(template))) == sorted(want)
    JCK.save(str(tmp_path / "jax"), js)
    got = TCK.restore(str(tmp_path / "jax"), 3, template)
    assert isinstance(got.rng, np.ndarray) and got.rng.dtype == np.uint32
    assert got.step.dtype == torch.int32 and got.opt_state["count"].dtype == torch.int32
    have = bridge.flatten(bridge.train_state_to_jax_numpy(got))
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    TCK.save(str(tmp_path / "torch"), got)
    back = JCK.restore(str(tmp_path / "torch"), 3, JSt.init_train_state(jcfg,
                                                                      jax.random.PRNGKey(1)))
    again = _jstate_numpy(back)
    assert sorted(again) == sorted(want)
    for k in want:
        assert again[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)
