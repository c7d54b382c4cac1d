"""The port's ``CheckpointManager`` (``repro_torch.ckpt``) on the CPU: a
tree of tensors (float32, bfloat16, a 0-d int32 step, nested dicts, lists
and tuples) round-trips exactly, a corrupted leaf fails its CRC32 with
``IOError``, only the last ``keep`` steps survive (the same steps as the
reference's ``repro.ckpt`` keeps), and a ``.tmp`` directory left by an
interrupted save is never listed or restored."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.common.tree import leaves  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"embed": torch.randn(7, 5, generator=g),
             "layers": [{"w": torch.randn(5, 3, generator=g),
                         "b": torch.randn(3, generator=g).to(torch.bfloat16)},
                        {"w": torch.randn(5, 3, generator=g),
                         "b": torch.zeros(3, dtype=torch.bfloat16)}]},
            {"m": (torch.arange(6, dtype=torch.float32),),
             "step": torch.tensor(3, dtype=torch.int32)})


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_round_trip_is_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, extra={"step": 5, "note": "x"})
    like = _tree(seed=1)
    got, extra = mgr.restore(5, like, device="cpu")
    assert extra == {"step": 5, "note": "x"}
    _same(got, tree)
    assert isinstance(got[1]["m"], tuple) and isinstance(got[0]["layers"], list)


def test_corruption_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    d = tmp_path / "step_00000001"
    f = d / "leaf_00000.npy"
    arr = np.load(f)
    arr[0, 0] += 1.0
    np.save(f, arr)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(1, _tree(), device="cpu")


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    got, _ = mgr.restore(3, _tree(), device="cpu")
    _same(got, _tree(3))


def test_tmp_directories_are_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _tree(2))
    # an interrupted save of step 9: files written, never renamed
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000009.tmp" / "leaf_00000.npy").write_bytes(b"")
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
    got, _ = mgr.restore(mgr.latest_step(), _tree(), device="cpu")
    _same(got, _tree(2))
    # saving that step again replaces the leftover
    mgr.save(9, _tree(9))
    assert mgr.latest_step() == 9
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_keeps_what_the_reference_keeps(tmp_path):
    import jax.numpy as jnp

    from repro.ckpt.checkpoint import CheckpointManager as RefManager

    ref = RefManager(str(tmp_path / "ref"), keep=3)
    port = CheckpointManager(str(tmp_path / "port"), keep=3)
    for s in (2, 4, 6, 8, 10):
        ref.save(s, {"w": jnp.zeros(3)})
        port.save(s, {"w": torch.zeros(3)})
    assert port.all_steps() == ref.all_steps() == [6, 8, 10]
    assert port.latest_step() == ref.latest_step()
