"""Live sync on stacks with two leading axes against the JAX reference, on
the CPU: gemma3's ``g_local`` (g, r) and granite-moe's expert stacks (L, E)
at smoke size, the reference's weights and masks bridged from
``PRNGKey(0)`` (``tests/_torch_zoo_model.py``).

The wire: the reference's ``Publisher`` over the model's registry to the
port's ``Subscriber`` (and the port's to the reference's) through a
``DirChannel``, a snapshot and then a generation with one two-axis stack
rewired: the two subscribers' merged state is equal array for array
(bitwise), and every record the reference wrote re-encodes byte for byte
(RSY1). The engine's drain of such a stream is in
``tests/test_torch_lead2_drain.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402

import numpy as np  # noqa: E402
from repro.sync import DirChannel as JDirChannel  # noqa: E402
from repro.sync import Publisher as JPublisher  # noqa: E402
from repro.sync import Subscriber as JSubscriber  # noqa: E402
from repro_torch.sync import DirChannel, Publisher, Subscriber  # noqa: E402
from repro_torch.sync import delta as D  # noqa: E402

from _torch_zoo_model import _model, rewired_generation, to_port  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
CASES = [("gemma3-1b", "g_local/w_down"), (GRANITE, "blocks/w_gate")]
IDS = ["gemma3", "granite"]


def _assert_sub_equal(tsub, jsub, reg) -> None:
    """Both subscribers' merged state: every array bitwise, the statics,
    versions, generation and meta."""
    assert tsub.generation == jsub.generation
    assert tsub.mask_versions == jsub.mask_versions
    assert tsub.meta == jsub.meta
    for s in reg:
        t, j = tsub.leaves[s.name], jsub.leaves[s.name]
        assert (t.format, t.static, t.mask_version) == (j.format, j.static, j.mask_version)
        assert set(t.arrays) == set(j.arrays)
        for f, arr in t.arrays.items():
            want = np.asarray(j.arrays[f])
            assert tuple(arr.shape[:len(s.lead)]) == s.lead
            np.testing.assert_array_equal(arr.numpy(), want.astype(arr.numpy().dtype))
    for name in ("params", "masks"):
        tflat, jflat = getattr(tsub, name), getattr(jsub, name)
        assert set(tflat) == set(jflat)
        for k in tflat:
            np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]))


def _records(path) -> list[bytes]:
    return [open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path)) if n.endswith(".rsd")]


@pytest.mark.parametrize("values_dtype", [None, "int8"])
@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_jax_publisher_to_port_subscriber(tmp_path, arch, name, values_dtype):
    m = _model(arch, ())
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    pub = JPublisher(m["jcfg"], m["jreg"], JDirChannel(str(tmp_path), retain=64),
                     path="condensed", values_dtype=values_dtype)
    tsub = Subscriber(DirChannel(str(tmp_path)).subscribe("port"), name="port")
    jsub = JSubscriber(JDirChannel(str(tmp_path)).subscribe("jax"), name="jax")
    for params, masks, v in ((m["jparams"], m["jmasks"], versions),
                             (params2, masks2, versions2)):
        pub.publish(params=params, masks=masks, mask_versions=dict(v))
        tsub.poll()
        jsub.poll()
        _assert_sub_equal(tsub, jsub, m["jreg"])
    assert tsub.generation == 2 and tsub.counters["applied_deltas"] == 1
    blobs = _records(tmp_path)
    assert len(blobs) == 2 and all(b[:4] == b"RSY1" for b in blobs)
    for blob in blobs:
        assert D.encode(D.decode(blob)) == blob
    for s in m["treg"]:
        leaf = D.wire_to_leaf(tsub.leaves[s.name])
        for f, t in leaf.arrays().items():
            assert torch.equal(t, tsub.leaves[s.name].arrays[f])


@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_port_publisher_to_jax_subscriber(tmp_path, arch, name):
    m = _model(arch, ())
    versions, params2, masks2, versions2 = rewired_generation(m, name)
    pub = Publisher(m["tcfg"], m["treg"], DirChannel(str(tmp_path), retain=64),
                    path="condensed")
    jsub = JSubscriber(JDirChannel(str(tmp_path)).subscribe("jax"), name="jax")
    tsub = Subscriber(DirChannel(str(tmp_path)).subscribe("port"), name="port")
    for params, masks, v in ((m["jparams"], m["jmasks"], versions),
                             (params2, masks2, versions2)):
        info = pub.publish(params=to_port(params), masks=to_port(masks), mask_versions=dict(v))
        jsub.poll()
        tsub.poll()
        _assert_sub_equal(tsub, jsub, m["jreg"])
    assert info["topology"] == [name]
