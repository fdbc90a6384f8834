"""repro_torch.checkpoint.manager against repro.checkpoint.manager.

The reference's own checkpoint tests (tests/test_substrates.py: round trip
and gc, corruption, invisible tmp directories) run on the port's manager,
and a train state crosses packages both ways: the reference's manager
writes, the port's restores (``train_state_like`` / ``train_state_from_
numpy``), and the other way round, leaf for leaf equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import get_config as jax_get_config
from repro.runtime.trainer import init_train_state as jax_init_train_state

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import get_config
from repro_torch.models.convert import (ShapeDtype, train_state_from_numpy,
                                        train_state_like,
                                        train_state_to_numpy)
from repro_torch.runtime.trainer import init_train_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"w": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    for step in (10, 20, 30):
        mgr.save(step, {k: v + step for k, v in state.items()},
                 blocking=True)
    assert mgr.steps() == [20, 30]            # keep=2 garbage-collected 10
    like = {"w": ShapeDtype((2, 3), torch.float32),
            "n": ShapeDtype((), torch.int64)}
    restored = mgr.restore(30, like)
    assert np.allclose(restored["w"], np.arange(6.0).reshape(2, 3) + 30)
    assert restored["n"] == 33 and restored["n"].dtype == np.int64


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"w": torch.ones(4)}, blocking=True)
    blob = tmp_path / "step_00000001" / "data.npz"
    data = bytearray(blob.read_bytes())
    data[-1] ^= 0xFF
    blob.write_bytes(bytes(data))
    with pytest.raises(IOError):
        mgr.restore(1, {"w": ShapeDtype((4,), torch.float32)})


def test_checkpoint_tmp_dirs_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000099.tmp").mkdir()
    assert mgr.latest_step() is None          # partial save never published


def test_async_save_copies_now_and_bf16_raises(tmp_path):
    """The host copy is taken at ``save``: an in-place update right after
    does not reach the checkpoint.  A bf16 leaf raises (numpy has none)."""
    mgr = CheckpointManager(tmp_path)
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert not mgr.restore(1, {"w": w})["w"].any()
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(2, {"w": w.to(torch.bfloat16)})


def _configs(arch):
    return (jax_get_config(arch).reduced(), get_config(arch).reduced())


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "whisper-base",
                                  "internvl2-26b"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    cj, ct = _configs(arch)
    state = jax.jit(lambda: jax_init_train_state(jax.random.PRNGKey(0),
                                                 cj))()
    state["opt"]["m"] = jax.tree_util.tree_map(lambda a: a + 0.5,
                                               state["opt"]["m"])
    state["step"] = jnp.asarray(7, jnp.int32)
    JManager(tmp_path).save(7, state, blocking=True)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 7
    like = train_state_like(init_train_state(1, ct, device="cpu"), ct)
    ported = train_state_from_numpy(mgr.restore(7, like), ct, device="cpu")
    assert int(ported["step"]) == 7
    back = train_state_to_numpy(ported, ct)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "whisper-base",
                                  "internvl2-26b"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch):
    cj, ct = _configs(arch)
    state = init_train_state(3, ct, device="cpu")
    state["opt"]["v"]["layers"][1]["ln2"]["scale"].fill_(2.5)
    CheckpointManager(tmp_path).save(5, train_state_to_numpy(state, ct),
                                     blocking=True)
    like = jax.eval_shape(lambda: jax_init_train_state(
        jax.random.PRNGKey(0), cj))
    restored = JManager(tmp_path).restore(5, like)
    want = train_state_to_numpy(state, ct)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)
    assert np.all(restored["opt"]["v"]["stack"][0]["ln2"]["scale"][1] == 2.5)


def test_manifest_names_are_the_references(tmp_path):
    """Both managers write the same array names, in the same order."""
    _, ct = _configs("lacin-demo")
    cj = jax_get_config("lacin-demo").reduced()
    CheckpointManager(tmp_path / "port").save(
        1, train_state_to_numpy(init_train_state(0, ct, device="cpu"), ct),
        blocking=True)
    JManager(tmp_path / "ref").save(1, jax.jit(lambda: jax_init_train_state(
        jax.random.PRNGKey(0), cj))(), blocking=True)
    names = [
        [(k, v["name"], v["shape"], v["dtype"]) for k, v in json.loads(
            (tmp_path / d / "step_00000001" / "MANIFEST.json").read_text())
         ["arrays"].items()] for d in ("port", "ref")]
    assert names[0] == names[1]
    assert ("a0", "opt/m/embed/table", [256, 64], "float32") in names[0]
