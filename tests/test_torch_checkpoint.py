"""Port vs reference: the checkpoint manager (checkpoint.manager).

Mirrors tests/test_checkpoint.py on the port's CheckpointManager (trees of
torch tensors and numpy leaves, restore onto a device in place of
shardings), and holds the on-disk format to the reference's: a step
written by either package restores bit for bit in the other, arrays and
CRCs equal.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager


def tree(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.as_tensor(rng.normal(size=(8, 16)), dtype=torch.float32).to(dtype),
        "nested": {"b": torch.as_tensor(rng.normal(size=(4,)), dtype=torch.float32),
                   "c": torch.tensor(3, dtype=torch.int32)},
    }


def leaves(t):
    return [t["a"], t["nested"]["b"], t["nested"]["c"]]


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep_last_k=2)
        t = tree(0)
        mgr.save(7, t)
        out = mgr.restore(t)
        for a, b in zip(leaves(t), leaves(out)):
            assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
            assert torch.equal(a, b)

    def test_bfloat16_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t = tree(1, torch.bfloat16)
        mgr.save(1, t)
        out = mgr.restore(t)
        assert out["a"].dtype == torch.bfloat16
        assert torch.equal(t["a"].view(torch.int16), out["a"].view(torch.int16))
        meta = json.loads((Path(tmp_path) / "step_0000000001" / "manifest.json").read_text())
        assert meta["arrays"]["a"]["dtype"] == "bfloat16"

    def test_keep_last_k(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep_last_k=2)
        t = tree(0)
        for s in (1, 2, 3, 4):
            mgr.save(s, t)
        assert mgr.all_steps() == [3, 4]

    def test_corruption_detected(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t = tree(0)
        mgr.save(1, t)
        d = Path(tmp_path) / "step_0000000001"
        manifest = json.loads((d / "manifest.json").read_text())
        manifest["arrays"]["a"]["crc32"] ^= 0xDEADBEEF
        (d / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(IOError):
            mgr.restore(t)

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t = tree(0)
        mgr.save(5, t, async_=True)
        t["a"].zero_()  # the host copy was taken in save(): mutation is safe
        mgr.wait()
        assert mgr.latest_step() == 5
        assert not torch.equal(mgr.restore(t)["a"], t["a"])

    def test_no_tmp_dir_left(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, tree(0))
        assert not list(Path(tmp_path).glob("*.tmp"))

    def test_orphan_tmp_swept_on_startup(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, tree(0))
        orphan = Path(tmp_path) / "step_0000000002.tmp"
        orphan.mkdir()
        (orphan / "arrays.npz").write_bytes(b"partial write")
        mgr2 = CheckpointManager(tmp_path)
        assert not orphan.exists()
        assert mgr2.all_steps() == [1]

    def test_corrupt_error_names_the_array(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t = tree(0)
        mgr.save(1, t)
        d = Path(tmp_path) / "step_0000000001"
        manifest = json.loads((d / "manifest.json").read_text())
        manifest["arrays"]["nested//b"]["crc32"] ^= 0xDEADBEEF
        (d / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(CheckpointCorruptError, match="nested//b"):
            mgr.restore(t)
        # unverified restore still reads (operator escape hatch)
        mgr.restore(t, verify=False)

    def test_truncated_manifest_is_corrupt_not_cryptic(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, tree(0))
        d = Path(tmp_path) / "step_0000000001"
        full = (d / "manifest.json").read_text()
        (d / "manifest.json").write_text(full[: len(full) // 2])
        with pytest.raises(CheckpointCorruptError, match="manifest"):
            mgr.restore_flat()

    def test_restore_flat_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t = tree(2)
        mgr.save(3, t)
        flat = mgr.restore_flat()
        assert set(flat) == {"a", "nested//b", "nested//c"}
        np.testing.assert_array_equal(flat["a"], t["a"].numpy())
        with pytest.raises(FileNotFoundError):
            CheckpointManager(tmp_path / "empty").restore_flat()

    def test_restore_onto_a_device(self, tmp_path):
        """device= takes the place of the reference's shardings=: every
        leaf lands there, numpy leaves become tensors; without it a numpy
        leaf stays numpy and a tensor leaf keeps its device."""
        mgr = CheckpointManager(tmp_path)
        t = {**tree(0), "host": np.arange(5.0), "seq": [np.int64(4), (np.ones(2),)]}
        mgr.save(1, t)
        out = mgr.restore(t, device="cpu")
        assert out["host"].device.type == "cpu" and isinstance(out["seq"][1], tuple)
        assert torch.equal(out["a"], t["a"])
        np.testing.assert_array_equal(out["host"].numpy(), t["host"])
        plain = mgr.restore(t)
        assert isinstance(plain["host"], np.ndarray) and int(plain["seq"][0]) == 4
        assert isinstance(plain["a"], torch.Tensor)


def _ref_tree(t):
    """The same tree as jax arrays, for the reference's manager."""
    def conv(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return {"a": conv(t["a"]), "nested": {"b": conv(t["nested"]["b"]),
                                           "c": conv(t["nested"]["c"])},
            "host": np.arange(6.0), "flag": np.bool_(True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_step_reads_bit_for_bit_across_packages(tmp_path, writer, dtype):
    """A step written by either manager restores in the other: the same
    keys, arrays bit for bit, the same dtypes and CRCs in the manifest."""
    t = tree(4, dtype)
    full = {**t, "host": np.arange(6.0), "flag": np.bool_(True)}
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefManager(ref_dir).save(2, _ref_tree(t))
    CheckpointManager(port_dir).save(2, full)
    src = ref_dir if writer == "reference" else port_dir
    m_ref = json.loads((ref_dir / "step_0000000002" / "manifest.json").read_text())
    m_port = json.loads((port_dir / "step_0000000002" / "manifest.json").read_text())
    assert m_ref["arrays"] == m_port["arrays"]
    got = CheckpointManager(src).restore_flat()
    want = RefManager(src).restore_flat()
    assert set(got) == set(want) == set(m_ref["arrays"])
    for k in want:
        g = got[k]
        w = np.asarray(want[k])
        if isinstance(g, torch.Tensor):  # bfloat16
            g = g.view(torch.int16).numpy().view(np.uint16)
            w = w.view(np.uint16)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    back = CheckpointManager(src).restore(full)
    assert back["a"].dtype == dtype and torch.equal(
        back["a"].view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
        t["a"].view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
