"""The port's checkpoint layer against the JAX package's.

- The optimizer-state packing: for SGD, SGD with Nesterov momentum,
  Adam, AdamW (masked and unmasked decay), RMSprop with momentum and
  Adam with ``clipvalue`` and ``clipnorm``, three steps of both packages
  on the same seeded gradients; the port's ``opt_state_leaves`` equal
  ``jax.tree_util.tree_leaves`` of the optax state in count, order,
  shape and dtype (the count int32), with values within 1e-6, and
  ``opt_state_from_leaves`` takes the JAX leaves back.
- ``CheckpointManager``: the cases of ``tests/utils/test_checkpoint.py``
  (round trip, gc, resume latest, async parity, async ordering with gc,
  an async failure re-raised by ``check_error`` and by
  ``wait_until_finished``, a straggler write that cannot move
  ``latest_step`` back, rollback, the preemption handler), on tensors
  where the JAX tests use arrays.
- The format: a step the JAX package wrote with Orbax raises
  ``FileNotFoundError`` naming Orbax; a bfloat16 leaf round-trips
  bit-exact (and a JAX-written one reads back to the same bits), and
  restoring one into a float32 leaf raises.
"""
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.utils import checkpoint as jckpt
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                install_preemption_checkpoint,
                                                tensor_from_host)
from elephas_tpu_torch.weights import tree_map

_OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.05),
    "sgd_nesterov": lambda m: m.SGD(0.05, momentum=0.9, nesterov=True),
    "adam": lambda m: m.Adam(1e-2),
    "adamw": lambda m: m.AdamW(1e-2, weight_decay=0.05),
    "adamw_decay_1d": lambda m: m.AdamW(1e-2, weight_decay=0.05,
                                        decay_1d=True),
    "rmsprop_momentum": lambda m: m.RMSprop(1e-2, momentum=0.9),
    "adam_clipped": lambda m: m.Adam(1e-2, clipvalue=0.05, clipnorm=0.5),
    # the schedule's own count is the last leaf
    "adam_scheduled": lambda m: m.Adam(m.schedules.WarmupCosine(
        1e-2, warmup_steps=2, decay_steps=10)),
    "adagrad": lambda m: m.Adagrad(1e-2),
    "adadelta": lambda m: m.Adadelta(1.0),
    "nadam": lambda m: m.Nadam(1e-2),
    # FactoredState: the count, then row, column and full moments, each
    # a (1,) placeholder where a leaf does not use it
    "adafactor": lambda m: m.Adafactor(),
    "adafactor_factored": lambda m: m.Adafactor(
        1e-2, min_dim_size_to_factor=2),
    "lion": lambda m: m.Lion(1e-3, weight_decay=0.1),
    "lamb": lambda m: m.LAMB(1e-2, weight_decay=0.1),
}


def _params(rng):
    # layer names that sort differently as strings and as numbers
    return {name: {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                   "bias": rng.normal(size=(3,)).astype(np.float32)}
            for name in ("dense_10", "dense_9")}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_packed_leaves_match_optax(name):
    rng = np.random.default_rng(0)
    params = _params(rng)
    jtx = _OPTIMIZERS[name](jopt).to_optax()
    ttx = _OPTIMIZERS[name](topt).to_transform()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        updates, tstate = ttx.update(tree_map(torch.from_numpy, grads),
                                     tstate, tp)
        tp = {ln: {pn: tp[ln][pn] + updates[ln][pn] for pn in tp[ln]}
              for ln in tp}
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = [t.numpy() for t in topt.opt_state_leaves(tstate)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    if name.startswith("adam"):
        assert want[0].dtype == np.int32 and int(want[0]) == 3
    back = topt.opt_state_from_leaves(ttx.init(tp), want)
    for g, w in zip(topt.opt_state_leaves(back), want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_leaf_count_mismatch_raises():
    tp = tree_map(torch.from_numpy, _params(np.random.default_rng(0)))
    template = topt.Adam().to_transform().init(tp)
    with pytest.raises(ValueError, match="optimizers differ"):
        topt.opt_state_from_leaves(template, [np.int32(0)])


# ------------------------------------------------------ CheckpointManager
def _state(value):
    return {"params": {"dense": {"kernel": torch.full((4, 4), value),
                                 "bias": torch.zeros(4)}},
            "step_scalar": np.array(value)}


def test_save_restore_round_trip(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(1, _state(1.0), model_json='{"class_name": "Sequential"}',
                 distributed_config={"mode": "synchronous"})
    restored = manager.restore()
    np.testing.assert_array_equal(restored["params"]["dense"]["kernel"],
                                  np.full((4, 4), 1.0, np.float32))
    manifest = manager.manifest()
    assert manifest["latest_step"] == 1
    assert manifest["distributed_config"]["mode"] == "synchronous"
    assert manifest["model"] == '{"class_name": "Sequential"}'
    step_dir = tmp_path / "ckpt" / "step_1"
    assert sorted(os.listdir(step_dir)) == ["state.npz", "treedef.json"]
    assert json.loads((step_dir / "treedef.json").read_text()) == {
        "params": {"dense": {"kernel": "params/dense/kernel",
                             "bias": "params/dense/bias"}},
        "step_scalar": "step_scalar"}


def test_multiple_steps_and_gc(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3):
        manager.save(step, _state(float(step)))
    assert manager.steps() == [2, 3]
    assert manager.latest_step() == 3
    assert not (tmp_path / "ckpt" / "step_1").exists()
    np.testing.assert_allclose(manager.restore(2)["step_scalar"], 2.0)


def test_resume_latest(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(5, _state(5.0))
    manager.save(9, _state(9.0))
    fresh = CheckpointManager(str(tmp_path / "ckpt"))
    np.testing.assert_allclose(fresh.restore()["step_scalar"], 9.0)


def test_async_save_restore_parity(tmp_path):
    """block=False writes what a blocking save writes, from a snapshot
    taken at save(): the caller may overwrite its tensors in place at
    once (as the LM's train step does)."""
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    state = _state(3.0)
    manager.save(1, state, block=False)
    state["params"]["dense"]["kernel"].fill_(-999.0)
    manager.wait_until_finished()
    np.testing.assert_array_equal(
        manager.restore(1)["params"]["dense"]["kernel"],
        np.full((4, 4), 3.0, np.float32))


def test_async_saves_queue_in_order_with_gc(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        manager.save(step, _state(float(step)), block=False)
    assert manager.steps() == [3, 4]
    assert manager.latest_step() == 4
    np.testing.assert_allclose(manager.restore(3)["step_scalar"], 3.0)


def test_async_then_blocking_save_ordering(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    manager.save(1, _state(1.0), block=False)
    manager.save(2, _state(2.0), block=False)
    manager.save(3, _state(3.0))
    assert manager.steps() == [1, 2, 3]
    assert manager.latest_step() == 3


def test_check_error_reraises_background_writer_failure(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    orig_write = manager._write

    def failing_write(*args, **kwargs):
        raise RuntimeError("disk full (injected)")

    manager._write = failing_write
    manager.save(1, _state(1.0), block=False)
    deadline = time.time() + 30
    while time.time() < deadline:
        with manager._pending_lock:
            if manager._pending and all(f.done() for f in manager._pending):
                break
        time.sleep(0.01)
    manager._write = orig_write
    with pytest.raises(RuntimeError, match="disk full"):
        manager.save(2, _state(2.0), block=False)   # check_error path
    manager.save(3, _state(3.0), block=False)
    manager.wait_until_finished()
    assert manager.latest_step() == 3
    np.testing.assert_allclose(manager.restore()["step_scalar"], 3.0)


def test_wait_until_finished_reraises_background_writer_failure(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    orig_write = manager._write

    def failing_write(*args, **kwargs):
        raise RuntimeError("writer exploded (injected)")

    manager._write = failing_write
    manager.save(1, _state(1.0), block=False)
    manager._write = orig_write
    with pytest.raises(RuntimeError, match="writer exploded"):
        manager.wait_until_finished()
    manager.save(2, _state(2.0))
    assert manager.latest_step() == 2


def test_out_of_order_write_cannot_regress_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=5)
    state5 = {"w": np.arange(3.0)}
    mgr.save(5, state5)
    mgr._write(3, {"w": np.zeros(3)}, None, None, seq=-5)
    assert mgr.latest_step() == 5
    assert mgr.steps() == [3, 5]
    np.testing.assert_array_equal(mgr.restore()["w"], state5["w"])


def test_rollback_save_moves_latest_backwards(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=5)
    mgr.save(10, {"w": np.full(3, 10.0)})
    mgr.restore(step=10)
    mgr.save(6, {"w": np.full(3, 6.0)})
    assert mgr.latest_step() == 6
    np.testing.assert_array_equal(mgr.restore()["w"], np.full(3, 6.0))


def test_preemption_handler_checkpoints_and_exits(tmp_path):
    manager = CheckpointManager(str(tmp_path / "pre_ck"))
    current = {"step": 3}
    uninstall = install_preemption_checkpoint(
        manager, lambda: (current["step"], _state(float(current["step"]))))
    try:
        current["step"] = 7
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 143
    finally:
        uninstall()
    fresh = CheckpointManager(str(tmp_path / "pre_ck"))
    assert fresh.latest_step() == 7
    np.testing.assert_allclose(fresh.restore()["step_scalar"], 7.0)
    m = fresh.manifest()
    assert m["preempted"] is True and m["preempted_step"] == 7
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_preemption_uninstall_restores_handler(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    manager = CheckpointManager(str(tmp_path / "pre_ck2"))
    uninstall = install_preemption_checkpoint(manager,
                                              lambda: (0, _state(0.0)))
    assert signal.getsignal(signal.SIGTERM) != before
    uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    assert manager.latest_step() is None


def test_port_and_jax_managers_read_each_other(tmp_path, monkeypatch):
    """The same layout both ways: the JAX manager (npz writer) reads what
    the port wrote and the port reads what the JAX manager wrote."""
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(port_dir).save(4, _state(4.0), model_json="{}")
    got = jckpt.CheckpointManager(port_dir).restore()
    np.testing.assert_array_equal(got["params"]["dense"]["kernel"],
                                  np.full((4, 4), 4.0, np.float32))
    jckpt.CheckpointManager(jax_dir).save(
        2, {"params": {"d": {"k": np.arange(6.0).reshape(2, 3)}},
            "opt_state_leaves": {"leaf_0": np.array(2, np.int32)}})
    back = CheckpointManager(jax_dir).restore()
    np.testing.assert_array_equal(back["params"]["d"]["k"],
                                  np.arange(6.0).reshape(2, 3))
    assert back["opt_state_leaves"]["leaf_0"].dtype == np.int32
    assert CheckpointManager(jax_dir).latest_step() == 2


def test_orbax_step_raises(tmp_path):
    """A step the JAX package wrote with Orbax (its default writer) has
    no state.npz: the port names Orbax instead of loading garbage."""
    if not jckpt._HAS_ORBAX:
        pytest.skip("orbax is not installed, so the JAX package writes npz")
    directory = str(tmp_path / "orbax")
    jckpt.CheckpointManager(directory).save(
        1, {"params": {"d": {"k": jnp.ones((2, 2))}}})
    assert not (tmp_path / "orbax" / "step_1" / "state.npz").exists()
    with pytest.raises(FileNotFoundError, match="Orbax"):
        CheckpointManager(directory).restore()


def test_bf16_leaf_round_trips_bit_exact(tmp_path, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=gen).to(torch.bfloat16)
    manager = CheckpointManager(str(tmp_path / "bf16"))
    manager.save(0, {"w": w}, block=False)
    saved = manager.restore()["w"]
    assert saved.dtype == np.dtype("V2")      # the JAX package's form
    back = tensor_from_host(saved, torch.empty((5, 7), dtype=torch.bfloat16))
    assert back.dtype == torch.bfloat16 and torch.equal(back, w)
    with pytest.raises(ValueError, match="cannot restore into"):
        tensor_from_host(saved, torch.empty((5, 7)))
    with pytest.raises(ValueError, match="Shape mismatch"):
        tensor_from_host(saved, torch.empty((7, 5), dtype=torch.bfloat16))
    # a bf16 leaf the JAX package wrote reads back to the same bits
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    jw = jnp.asarray(np.asarray(w.float()), dtype=jnp.bfloat16)
    jckpt.CheckpointManager(str(tmp_path / "jbf16")).save(0, {"w": jw})
    jsaved = CheckpointManager(str(tmp_path / "jbf16")).restore()["w"]
    assert jsaved.dtype == np.dtype("V2")
    assert torch.equal(tensor_from_host(jsaved, w), w)
