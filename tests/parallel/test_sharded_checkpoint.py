"""Sharded checkpointing on the virtual 8-device mesh: each device's
shard is its own file (no gather -- the analog of orbax's
per-host checkpoint layout), manifest-last crash consistency, async
write handles, bf16 payloads, and re-sharded restore."""

import os

import ml_dtypes
import numpy as np
import pytest

from gt4py_tpu.parallel import CartesianMesh
from gt4py_tpu.utils.checkpoint import (
    CheckpointHandle,
    load_checkpoint_sharded,
    save_checkpoint_sharded,
)


@pytest.fixture(scope="module")
def cmesh():
    import jax

    assert len(jax.devices()) == 8
    return CartesianMesh((2, 4))


def _sharded_state(cmesh, dtype=np.float32):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(cmesh.mesh, P("x", "y", None))
    rng = np.random.default_rng(0)
    u = rng.random((8, 8, 4)).astype(dtype)
    q = rng.random((8, 8, 4)).astype(dtype)
    return {
        "u": jax.device_put(u, sh),
        "q": jax.device_put(q, sh),
        "scalar_step": np.float64(0.25),
    }, {"u": u, "q": q}, sh


def test_sharded_roundtrip(tmp_path, cmesh):
    state, raw, sh = _sharded_state(cmesh)
    d = str(tmp_path / "ckpt")
    out = save_checkpoint_sharded(d, state, step=7, metadata={"note": "x"})
    assert out == d
    # one file per device shard + the full scalar + manifest
    files = sorted(os.listdir(d))
    assert sum(f.startswith("u.d") for f in files) == 8
    assert "scalar_step.full.npy" in files
    assert any(f.startswith("manifest.p") for f in files)

    loaded, meta = load_checkpoint_sharded(d)
    assert meta["step"] == 7 and meta["note"] == "x"
    np.testing.assert_array_equal(loaded["u"], raw["u"])
    np.testing.assert_array_equal(loaded["q"], raw["q"])
    assert float(loaded["scalar_step"]) == 0.25


def test_sharded_restore_resharded(tmp_path, cmesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    state, raw, _ = _sharded_state(cmesh)
    d = str(tmp_path / "ckpt")
    save_checkpoint_sharded(d, state)
    new_sh = NamedSharding(cmesh.mesh, P("y", "x", None))  # different layout
    loaded, _ = load_checkpoint_sharded(d, shardings={"u": new_sh})
    assert isinstance(loaded["u"], jax.Array)
    assert loaded["u"].sharding == new_sh
    np.testing.assert_array_equal(np.asarray(loaded["u"]), raw["u"])
    assert isinstance(loaded["q"], np.ndarray)  # no sharding requested


def test_sharded_async_handle(tmp_path, cmesh):
    state, raw, _ = _sharded_state(cmesh)
    d = str(tmp_path / "ckpt")
    h = save_checkpoint_sharded(d, state, wait=False)
    assert isinstance(h, CheckpointHandle)
    assert h.wait() == d
    # manifest written last: after wait() the checkpoint is loadable
    loaded, _ = load_checkpoint_sharded(d)
    np.testing.assert_array_equal(loaded["u"], raw["u"])


def test_sharded_bf16_payload(tmp_path, cmesh):
    state, raw, _ = _sharded_state(cmesh, dtype=ml_dtypes.bfloat16)
    d = str(tmp_path / "ckpt")
    save_checkpoint_sharded(d, state)
    loaded, _ = load_checkpoint_sharded(d)
    assert loaded["u"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        loaded["u"].view(np.uint16), raw["u"].view(np.uint16)
    )


def test_incomplete_checkpoint_rejected(tmp_path, cmesh):
    state, _, _ = _sharded_state(cmesh)
    d = str(tmp_path / "partial")
    os.makedirs(d)
    # shard files without a manifest = crashed mid-save
    np.save(os.path.join(d, "u.d0.npy"), np.zeros((4, 2, 4), np.float32))
    with pytest.raises(FileNotFoundError, match="manifest"):
        load_checkpoint_sharded(d)


def test_replicated_array_stores_one_file(tmp_path, cmesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(cmesh.mesh, P())  # fully replicated on all 8
    raw = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    d = str(tmp_path / "ckpt")
    save_checkpoint_sharded(d, {"r": jax.device_put(raw, rep)})
    files = sorted(os.listdir(d))
    assert sum(f.startswith("r.d") for f in files) == 1  # replica 0 only
    loaded, _ = load_checkpoint_sharded(d)
    np.testing.assert_array_equal(loaded["r"], raw)


def test_incomplete_multiprocess_checkpoint_rejected(tmp_path, cmesh):
    import glob
    import json

    from gt4py_tpu.utils.checkpoint import is_checkpoint_complete

    state, _, _ = _sharded_state(cmesh)
    d = str(tmp_path / "ckpt")
    save_checkpoint_sharded(d, state)
    assert is_checkpoint_complete(d)
    # simulate a 2-process save of which only this manifest landed
    (mpath,) = glob.glob(os.path.join(d, "manifest.p*.json"))
    with open(mpath) as f:
        m = json.load(f)
    m["process_count"] = 2
    with open(mpath, "w") as f:
        json.dump(m, f)
    assert not is_checkpoint_complete(d)
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_checkpoint_sharded(d)


def test_partial_shard_coverage_rejected(tmp_path, cmesh):
    import glob
    import json

    state, _, _ = _sharded_state(cmesh)
    d = str(tmp_path / "ckpt")
    save_checkpoint_sharded(d, state)
    (mpath,) = glob.glob(os.path.join(d, "manifest.p*.json"))
    with open(mpath) as f:
        m = json.load(f)
    # drop one recorded shard of 'u': its region would stay zero-filled
    m["arrays"]["u"]["shards"].popitem()
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="covered"):
        load_checkpoint_sharded(d)


def test_path_separator_key_rejected(tmp_path, cmesh):
    with pytest.raises(ValueError, match="path separators"):
        save_checkpoint_sharded(
            str(tmp_path / "c"), {"a/b": np.zeros(2)}
        )
