"""The port's token stream and checkpoint store against ``repro``'s.

* ``SyntheticTokenStream``: the batches equal the reference's for several
  (seed, step, host), codebooks too, and the global batch does not depend
  on the number of hosts; a restore resumes the stream.
* ``CheckpointStore``: a corrupt and a partial checkpoint are skipped;
  ``keep``; an async save and its wait; a checkpoint written by ``repro``
  (f32) restores in the port leaf for leaf, and one written by the port in
  ``repro``; bf16 leaves round-trip bit for bit (numpy stores them as raw
  2-byte words, ``|V2``, and the manifest records their dtype).

JAX is imported through ``pytest.importorskip`` inside the tests that
compare with ``repro``.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_thread  # noqa: F401
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import DataConfig, SyntheticTokenStream


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one torch thread (``_torch_parity.one_thread``)."""


# ---------------------------------------------------------------------------
# (e) the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_codebooks", [(0, 1), (7, 1), (3, 4)])
def test_stream_matches_repro(seed, n_codebooks):
    pytest.importorskip("jax")
    from repro.data import DataConfig as JCfg, SyntheticTokenStream as JStream

    kw = dict(vocab=1000, seq_len=48, global_batch=8, seed=seed, n_codebooks=n_codebooks)
    for n_hosts in (1, 2, 4):
        for host in range(n_hosts):
            ours = SyntheticTokenStream(DataConfig(**kw), host_id=host, n_hosts=n_hosts)
            ref = JStream(JCfg(**kw), host_id=host, n_hosts=n_hosts)
            for step in range(3):
                got, want = ours.next_batch(), ref.next_batch()
                assert sorted(got) == sorted(want)
                for k in got:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} step {step}")
            assert ours.state_dict() == ref.state_dict()


def test_global_batch_does_not_depend_on_the_hosts():
    kw = dict(vocab=500, seq_len=32, global_batch=8, seed=5)
    whole = SyntheticTokenStream(DataConfig(**kw)).next_batch()
    for n_hosts in (2, 4, 8):
        parts = [SyntheticTokenStream(DataConfig(**kw), host_id=h, n_hosts=n_hosts).next_batch()
                 for h in range(n_hosts)]
        for k in whole:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
    assert np.array_equal(whole["targets"][:, :-1], whole["tokens"][:, 1:])
    assert whole["tokens"].min() >= 0 and whole["tokens"].max() < 500


def test_stream_restores_its_step():
    cfg = DataConfig(vocab=500, seq_len=16, global_batch=2, seed=9)
    a = SyntheticTokenStream(cfg)
    batches = [a.next_batch() for _ in range(4)]
    b = SyntheticTokenStream(cfg)
    b.load_state_dict({"step": 2, "seed": 9})
    np.testing.assert_array_equal(b.next_batch()["tokens"], batches[2]["tokens"])
    with pytest.raises(ValueError, match="seed"):
        b.load_state_dict({"step": 2, "seed": 1})
    with pytest.raises(ValueError, match="hosts"):
        SyntheticTokenStream(cfg, n_hosts=3)


# ---------------------------------------------------------------------------
# (f) the checkpoint store
# ---------------------------------------------------------------------------

def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=gen),
                       "blocks": {"a": torch.randn(2, 5, generator=gen)}},
            "opt": {"count": torch.tensor(3, dtype=torch.int32),
                    "m": {"w": torch.randn(4, 3, generator=gen)}}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def test_save_restore_keep_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    assert store.latest_step() is None
    for step in (1, 2, 3):
        store.save(step, _tree(step), extra={"data": {"step": step, "seed": 0}})
    assert store.steps() == [2, 3] and store.latest_step() == 3
    got = store.restore(3, _tree(), device="cpu")
    for k, v in _leaves(_tree(3)).items():
        assert torch.equal(_leaves(got)[k], v) and _leaves(got)[k].dtype == v.dtype, k
    assert store.extra(3) == {"data": {"step": 3, "seed": 0}}
    with np.load(tmp_path / "step_0000000003" / "arrays.npz") as data:
        assert sorted(data.files) == ["opt/count", "opt/m/w", "params/blocks/a", "params/w"]


def test_corrupt_and_partial_checkpoints_are_skipped(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=5)
    for step in (1, 2, 3):
        store.save(step, _tree(step))
    # step 3's payload is corrupted; step 2 lost its manifest mid-write
    payload = tmp_path / "step_0000000003" / "arrays.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    os.remove(tmp_path / "step_0000000002" / "manifest.json")
    # and a temporary directory of a write that never ended
    (tmp_path / ".tmp_ckpt_dead").mkdir()
    assert store.steps() == [1] and store.latest_step() == 1


def test_async_save_snapshots_at_once(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _tree(4)
    want = {k: v.clone() for k, v in _leaves(tree).items()}
    store.save_async(7, tree, extra={"step": 7})
    tree["params"]["w"].add_(1.0)  # the loop goes on and changes its tensors
    store.wait()
    got = _leaves(store.restore(7, _tree(), device="cpu"))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)  # every bf16 word
    tree = {"p": bits.view(torch.bfloat16).reshape(256, 256), "q": torch.ones(3)}
    store = CheckpointStore(str(tmp_path))
    store.save(1, tree)
    manifest = json.loads((tmp_path / "step_0000000001" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"p": "bfloat16"}
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as data:
        assert data["p"].dtype == np.dtype("V2")
    like = {"p": torch.empty(256, 256, dtype=torch.bfloat16, device="meta"),
            "q": torch.empty(3, device="meta")}
    got = store.restore(1, like, device="cpu")
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), tree["p"].view(torch.int16))
    with pytest.raises(ValueError, match="shape"):
        store.restore(1, {"p": torch.empty(2, dtype=torch.bfloat16), "q": like["q"]},
                      device="cpu")


def test_checkpoints_move_between_the_packages(tmp_path):
    """An f32 checkpoint written by ``repro`` restores in the port equal
    leaf for leaf, and one written by the port restores in ``repro``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointStore as JStore

    tree = _tree(5)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    # a bf16 leaf too: np.savez writes the reference's as raw 2-byte words
    words = torch.randint(-32768, 32768, (6,), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32).to(torch.int16)
    bf16 = {"b": words.view(torch.bfloat16)}
    jbf16 = {"b": jnp.asarray(words.numpy()).view(jnp.bfloat16)}
    JStore(str(tmp_path / "ref")).save(2, {**jtree, "bf16": jbf16},
                                        extra={"data": {"step": 2, "seed": 0}})
    ours = CheckpointStore(str(tmp_path / "ref"))
    assert ours.latest_step() == 2 and ours.extra(2) == {"data": {"step": 2, "seed": 0}}
    got = _leaves(ours.restore(2, {**_tree(), "bf16": bf16}, device="cpu"))
    for k, v in _leaves({**tree, "bf16": bf16}).items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].view(-1).view(torch.uint8),
                                                       v.view(-1).view(torch.uint8)), k

    CheckpointStore(str(tmp_path / "port")).save(3, tree, extra={"step": 3})
    ref = JStore(str(tmp_path / "port"))
    assert ref.latest_step() == 3 and ref.extra(3) == {"step": 3}
    back = ref.restore(3, jtree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path
