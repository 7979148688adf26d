"""Mid-training checkpoint/resume with a distributed-config manifest.

The counterpart of ``elephas_tpu/utils/checkpoint.py``, on numpy: step
checkpoints of the full training state (params + optimizer state) plus
a JSON manifest carrying the model architecture and the distributed
configuration, so a training run can resume with identical semantics.

The on-disk layout is the JAX package's npz layout, so a checkpoint
crosses between the packages both ways::

    <directory>/manifest.json        # latest_step, steps, model, ...
    <directory>/step_<N>/state.npz   # one entry per leaf, keyed by path
    <directory>/step_<N>/treedef.json

Leaves may be tensors (on any device), numpy arrays or scalars. A
bfloat16 tensor is written as the JAX package writes one (numpy's
2-byte void dtype ``|V2``, the raw bits), since numpy has no bfloat16;
:func:`tensor_from_host` reads it back into the dtype of the leaf it
restores into.

Left out: the Orbax writer (only npz is written; a step written by Orbax
raises ``FileNotFoundError`` naming Orbax) and the multi-process
coordination (``_spans_processes``/``_is_coordinator``): the port runs
one process, which owns every write and the remote mirror.
"""
import json
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..weights import tree_map


class CheckpointManager:
    """Step-indexed training checkpoints under one directory.

    ``directory`` may be an object-store URL (``gs://...``): checkpoints
    are staged in a local directory and mirrored through the scheme's
    :mod:`~elephas_tpu_torch.utils.storage` adapter; a fresh process
    restores by downloading the manifest and the requested step on
    demand.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        from .storage import get_store, is_remote

        self._remote_url: str = ""
        self._store = None
        if is_remote(str(directory)):
            import tempfile

            self._remote_url = str(directory).rstrip("/")
            self._store = get_store(self._remote_url)
            directory = tempfile.mkdtemp(prefix="etpu_ckpt_staging_")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        # async-save machinery: ONE worker thread so queued writes keep
        # manifest ordering; errors surface at the next save()/wait()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        # RLock, not Lock: the preemption SIGTERM handler runs on this
        # same (main) thread and may interrupt a holder mid-section —
        # a non-reentrant lock would deadlock the final checkpoint
        self._pending_lock = threading.RLock()
        # serializes _write bodies: the SIGTERM handler's blocking save
        # can interrupt the main thread BETWEEN executor.submit and the
        # _pending append, so its wait_until_finished may miss that
        # in-flight future — this lock keeps the handler's write and the
        # background write from interleaving on manifest.json anyway
        self._write_lock = threading.RLock()
        # save-order sequence: each save() takes the next number; only
        # the highest-sequence write that has landed may set
        # latest_step, so a straggler older write cannot regress the
        # resume point — while a NEW save after restore(older_step)
        # (a deliberate rollback) still moves latest_step wherever it
        # points, because its sequence is the newest
        self._save_seq = 0
        self._committed_seq = -1
        if self._store is not None:
            # adopt an existing remote run's manifest (resume-from-URL)
            manifest_url = f"{self._remote_url}/manifest.json"
            if self._store.exists(manifest_url):
                (self.directory / "manifest.json").write_text(
                    self._store.read_text(manifest_url))

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             model_json: Optional[str] = None,
             distributed_config: Optional[Dict] = None,
             block: bool = True):
        """Save a nested dict ``state`` (e.g. ``{'params': ...,
        'opt_state_leaves': ...}``) at ``step`` and update the manifest.

        ``block=False`` returns as soon as every leaf has been copied to
        host memory; the disk write, remote mirror, and GC run on a
        background thread, so the training loop may overwrite its
        tensors in place at once. Writes queue on one worker, preserving
        step order; a failed background write re-raises at the next
        ``save``/``wait_until_finished``."""
        with self._pending_lock:
            seq = self._save_seq
            self._save_seq += 1
        if block:
            # earlier async writes must land first: the manifest is a
            # running log and a blocking save must observe/extend it
            self.wait_until_finished()
            self._write(int(step), state, model_json, distributed_config,
                        seq=seq)
            return
        self.check_error()
        host_state = tree_map(_to_host, state)
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="etpu-ckpt")
        with self._pending_lock:
            self._pending.append(self._executor.submit(
                self._write, int(step), host_state, model_json,
                distributed_config, seq))

    def wait_until_finished(self):
        """Block until every queued async save has been written (the
        flush always completes — a failure does not strand later
        writes), then re-raise the first failure, if any."""
        first: Optional[BaseException] = None
        while True:
            with self._pending_lock:
                if not self._pending:
                    break
                fut = self._pending.pop(0)
            try:
                fut.result()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                if first is None:
                    first = exc
        if first is not None:
            raise first

    def check_error(self):
        """Re-raise ONE completed-and-failed background save without
        waiting on the ones still in flight; later failures stay queued
        and surface on subsequent calls (none are swallowed)."""
        with self._pending_lock:
            failed = None
            keep = []
            for fut in self._pending:
                if not fut.done():
                    keep.append(fut)
                elif fut.exception() is None:
                    continue  # landed cleanly — drop
                elif failed is None:
                    failed = fut
                else:
                    keep.append(fut)  # surfaces on a later call
            self._pending = keep
        if failed is not None:
            failed.result()

    def _write(self, step: int, state: Dict[str, Any],
               model_json: Optional[str],
               distributed_config: Optional[Dict],
               seq: Optional[int] = None):
        with self._write_lock:
            self._write_locked(int(step), state, model_json,
                               distributed_config, seq)

    def _write_locked(self, step: int, state: Dict[str, Any],
                      model_json: Optional[str],
                      distributed_config: Optional[Dict],
                      seq: Optional[int]):
        # Start from the existing manifest and overwrite known keys —
        # a straggler write must carry forward everything it does not
        # own (model/distributed_config AND annotate() markers like the
        # preemption flag), and one read keeps the locked section short.
        manifest = self._read_manifest()
        # Only the newest save (by request order) may move latest_step:
        # if the preemption handler's final write beat a still-queued
        # older write to the lock, the straggler keeps its checkpoint
        # but cannot regress the resume point. A direct _write (no seq)
        # always takes the newest slot.
        if seq is None:
            with self._pending_lock:
                seq = self._save_seq
                self._save_seq += 1
        if seq > self._committed_seq or "latest_step" not in manifest:
            manifest["latest_step"] = int(step)
            self._committed_seq = max(self._committed_seq, seq)
        manifest["steps"] = list(manifest.get("steps", [])) + [int(step)]
        if model_json is not None:
            manifest["model"] = model_json
        if distributed_config is not None:
            manifest["distributed_config"] = distributed_config
        step_dir = self.directory / f"step_{int(step)}"
        if step_dir.exists():
            shutil.rmtree(step_dir)
        step_dir.mkdir(parents=True)
        flat, treedef = _flatten(state)
        np.savez(step_dir / "state.npz", **flat)
        (step_dir / "treedef.json").write_text(json.dumps(treedef))
        manifest["steps"] = sorted(set(manifest["steps"]))
        (self.directory / "manifest.json").write_text(json.dumps(manifest))
        if self._store is not None:
            self._store.put_dir(str(step_dir),
                                f"{self._remote_url}/step_{int(step)}")
            self._store.write_text(f"{self._remote_url}/manifest.json",
                                   json.dumps(manifest))
        self._gc()

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The state at ``step`` (default: latest) as a nested dict of
        numpy arrays (bfloat16 leaves as ``|V2`` bits)."""
        self.wait_until_finished()
        manifest = self._read_manifest()
        if step is None:
            step = manifest.get("latest_step")
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints in {self._remote_url or self.directory}")
        step_dir = self.directory / f"step_{int(step)}"
        if self._store is not None and not step_dir.exists():
            self._store.get_dir(f"{self._remote_url}/step_{int(step)}",
                                str(step_dir))
        if (step_dir / "state.npz").exists():
            treedef = json.loads((step_dir / "treedef.json").read_text())
            with np.load(step_dir / "state.npz") as data:
                return _unflatten({k: data[k] for k in data.files},
                                  treedef)
        raise FileNotFoundError(
            f"{step_dir} has no state.npz — if it was written by Orbax "
            "(the JAX package's default writer), restore it there: this "
            "package reads npz checkpoints only; otherwise the write was "
            "interrupted")

    # ------------------------------------------------------------- metadata
    def annotate(self, **fields):
        """Merge extra fields into the manifest (and its remote mirror) —
        e.g. preemption markers. Flushes async saves first so the merge
        applies to the final manifest."""
        self.wait_until_finished()
        with self._write_lock:
            manifest = self._read_manifest()
            manifest.update(fields)
            (self.directory / "manifest.json").write_text(
                json.dumps(manifest))
            if self._store is not None:
                self._store.write_text(f"{self._remote_url}/manifest.json",
                                       json.dumps(manifest))

    def manifest(self) -> Dict[str, Any]:
        self.wait_until_finished()
        return self._read_manifest()

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        return self._read_manifest().get("latest_step")

    def steps(self) -> List[int]:
        self.wait_until_finished()
        return self._steps_nowait()

    def _steps_nowait(self) -> List[int]:
        return list(self._read_manifest().get("steps", []))

    def _read_manifest(self) -> Dict[str, Any]:
        path = self.directory / "manifest.json"
        if not path.exists():
            return {}
        return json.loads(path.read_text())

    def _gc(self):
        steps = self._steps_nowait()
        evicted = False
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            evicted = True
            victim_dir = self.directory / f"step_{victim}"
            if victim_dir.exists():
                shutil.rmtree(victim_dir)
            if self._store is not None:
                self._store.delete(f"{self._remote_url}/step_{victim}",
                                   recursive=True)
        if not evicted:
            return  # manifest already written by save(); nothing changed
        manifest = self._read_manifest()
        manifest["steps"] = steps
        (self.directory / "manifest.json").write_text(json.dumps(manifest))
        if self._store is not None:
            self._store.write_text(f"{self._remote_url}/manifest.json",
                                   json.dumps(manifest))


def install_preemption_checkpoint(manager: CheckpointManager, state_fn,
                                  signals=None, model_json: Optional[str] = None,
                                  exit_code: int = 143):
    """Checkpoint on preemption: install a handler that writes one final
    blocking checkpoint when the process gets SIGTERM (the eviction
    notice of a preemptible VM) and marks the manifest (``preempted:
    true``, ``preempted_step``), then exits.

    :param state_fn: zero-arg callable returning ``(step, state)`` —
        called AT SIGNAL TIME so the checkpoint holds current weights.
    :param signals: signal numbers to trap (default: ``SIGTERM``).
    :returns: ``uninstall()`` restoring the previous handlers.

    Signal handlers require the main thread — install from the training
    process's main thread (where ``fit`` runs)."""
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGTERM,)
    prev = {}

    def _handler(signum, frame):
        try:
            step, state = state_fn()
            manager.save(int(step), state, model_json=model_json,
                         block=True)
            manager.annotate(preempted=True, preempted_step=int(step),
                             preempted_signal=int(signum))
        except BaseException:   # noqa: BLE001 — the process exits next;
            import traceback    # surface the failed final write instead
            traceback.print_exc()  # of dying silently
        finally:
            # ALWAYS restore + exit: a failing save must not leave this
            # handler installed, or the orchestrator's follow-up SIGTERM
            # re-enters it and the process outlives its grace window
            for sig, old in prev.items():
                _signal.signal(sig, old)
        raise SystemExit(exit_code)

    for sig in signals:
        prev[sig] = _signal.signal(sig, _handler)

    def uninstall():
        for sig, old in prev.items():
            _signal.signal(sig, old)

    return uninstall


def host_array(leaf) -> np.ndarray:
    """One leaf as the numpy array the npz file holds: a bfloat16
    tensor as its raw bits in numpy's 2-byte void dtype (``|V2``, what
    the JAX package's ``np.savez`` writes for one)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def tensor_from_host(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`host_array`: ``array`` as a tensor of
    ``like``'s dtype, shape and device. A ``|V2`` array holds bfloat16
    bits and restores only into a bfloat16 leaf; any other mismatch of
    shape raises instead of loading garbage."""
    array = np.asarray(array)
    if tuple(array.shape) != tuple(like.shape):
        raise ValueError(f"Shape mismatch: {tuple(array.shape)} vs "
                         f"{tuple(like.shape)}")
    if array.dtype.kind == "V":
        if array.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"a {array.dtype} leaf (bfloat16 bits) "
                             f"cannot restore into {like.dtype}")
        t = torch.from_numpy(array.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(array)).to(like.dtype)
    return t.to(like.device)


def _to_host(leaf):
    """Snapshot one leaf to host memory so the async writer sees a
    stable copy even if the caller overwrites the tensor in place on
    the very next step."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _flatten(tree, prefix=""):
    """Flatten a nested dict of leaves to {path: array} + structure spec
    (the JAX package's ``treedef.json``)."""
    flat, spec = {}, {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            sub_flat, sub_spec = _flatten(value, path + "/")
            flat.update(sub_flat)
            spec[key] = sub_spec
        else:
            flat[path] = host_array(value)
            spec[key] = path
    return flat, spec


def _unflatten(flat, spec):
    out = {}
    for key, value in spec.items():
        if isinstance(value, dict):
            out[key] = _unflatten(flat, value)
        else:
            out[key] = flat[value]
    return out
