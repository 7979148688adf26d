"""Model persistence: the model file and the training-state encoding.

The counterpart of ``elephas_tpu/models/saving.py``. The JAX package
writes its model file as HDF5 through ``h5py``; this package writes the
same entries into a zip written by ``np.savez`` (uncompressed), at
exactly the caller's path (``.h5`` and ``.keras`` names included):

- ``model_config``, ``training_config`` and ``distributed_config``:
  uint8 arrays of the UTF-8 JSON the JAX package stores as HDF5
  attributes (``training_config`` only for a compiled model saved with
  its optimizer, ``distributed_config`` only from ``TPUModel.save``);
- ``model_weights/weight_<i>``: the flat weights in ``get_weights``
  order.

:func:`load_model` reads both containers, told apart by their first
bytes: the zip signature is this package's, the HDF5 signature the JAX
package's (read through ``h5py``, imported only then; it raises
``ImportError`` where h5py is missing). The JAX package cannot read
this package's model files.

The training state of a checkpoint (:func:`pack_training_state`) is the
JAX package's: ``params`` plus the optimizer state's leaves in optax's
flatten order (``opt_state_leaves/leaf_<i>``), so checkpoints cross
between the packages both ways.
"""
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.checkpoint import tensor_from_host
from ..weights import tree_flatten, tree_unflatten
from . import losses as losses_mod
from . import metrics as metrics_mod
from . import optimizers as optimizers_mod
from .core import model_from_json

_ZIP_MAGIC = b"PK\x03\x04"
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_WEIGHT_PREFIX = "model_weights/weight_"
_ATTRS = ("model_config", "training_config", "distributed_config")


def json_entry(text: str) -> np.ndarray:
    """A JSON entry of the model file: the UTF-8 bytes as uint8."""
    return np.frombuffer(text.encode("utf8"), dtype=np.uint8)


def model_entries(model, include_optimizer: bool = True
                  ) -> Dict[str, np.ndarray]:
    """The model file's entries for ``model`` (architecture, weights and,
    when compiled and asked for, the training config)."""
    entries = {"model_config": json_entry(model.to_json())}
    if model.built:
        for i, w in enumerate(model.get_weights()):
            entries[f"{_WEIGHT_PREFIX}{i}"] = np.asarray(w)
    if include_optimizer and model.compiled:
        training_config = {
            "optimizer": optimizers_mod.serialize(model.optimizer),
            "loss": losses_mod.serialize(model.loss),
            "metrics": [metrics_mod.serialize(m) for m in model.metrics],
        }
        if getattr(model, "_compute_dtype", None) is not None:
            # the JAX package's name for it (str of its dtype)
            training_config["compute_dtype"] = _dtype_name(
                model._compute_dtype)
        entries["training_config"] = json_entry(
            json.dumps(training_config))
    return entries


def write_model_file(filepath: str, entries: Dict[str, np.ndarray]):
    """Write ``entries`` as one uncompressed zip at exactly ``filepath``
    (``np.savez`` given a path would append ``.npz``)."""
    with open(filepath, "wb") as f:
        np.savez(f, **entries)


def save_model(model, filepath: str, overwrite: bool = True,
               include_optimizer: bool = True):
    """Save ``model`` (a Keras-style model or a ``TransformerModel``) to
    ``filepath``."""
    if Path(filepath).exists() and not overwrite:
        raise FileExistsError(f"{filepath} exists and overwrite=False")
    write_model_file(filepath, model_entries(model, include_optimizer))


def read_model_file(filepath: str) -> Dict:
    """The model file's entries: ``model_config``, ``training_config``
    and ``distributed_config`` (JSON text or None) and ``weights`` (a
    list of numpy arrays), from this package's zip or the JAX package's
    HDF5 file."""
    with open(filepath, "rb") as f:
        magic = f.read(8)
    if magic.startswith(_ZIP_MAGIC):
        with np.load(filepath, allow_pickle=False) as data:
            out = {k: bytes(data[k]).decode("utf8") if k in data.files
                   else None for k in _ATTRS}
            count = sum(k.startswith(_WEIGHT_PREFIX) for k in data.files)
            out["weights"] = [data[f"{_WEIGHT_PREFIX}{i}"]
                              for i in range(count)]
        return out
    if magic == _HDF5_MAGIC:
        try:
            import h5py
        except ImportError as err:
            raise ImportError(
                f"{filepath} is an HDF5 model file (written by the JAX "
                "package); reading it needs h5py, which is not "
                "installed") from err
        with h5py.File(filepath, "r") as f:
            out = {}
            for key in _ATTRS:
                value = f.attrs.get(key)
                out[key] = (value.decode("utf8")
                            if isinstance(value, bytes) else value)
            group = f.get("model_weights")
            out["weights"] = ([np.asarray(group[f"weight_{i}"])
                               for i in range(len(group))]
                              if group is not None else [])
        return out
    raise ValueError(f"{filepath} is neither a zip model file nor an HDF5 "
                     "one")


def load_model(filepath: str, custom_objects: Optional[Dict] = None,
               device=None):
    """Rebuild, fill and (when the file has a training config) compile
    the model saved at ``filepath``, on ``device`` (None means the CUDA
    device; pass ``device="cpu"`` for the CPU)."""
    return model_from_file(read_model_file(filepath), custom_objects,
                           device)


def model_from_file(entries: Dict, custom_objects: Optional[Dict] = None,
                    device=None):
    """:func:`load_model` from entries :func:`read_model_file` read."""
    model = model_from_json(entries["model_config"], custom_objects,
                            device=device)
    if entries["weights"]:
        if not model.built:
            model.build()
        model.set_weights(entries["weights"])
    if entries["training_config"] is not None:
        cfg = json.loads(entries["training_config"])
        compile_kwargs = {}
        if cfg.get("compute_dtype"):
            compile_kwargs["compute_dtype"] = cfg["compute_dtype"]
        model.compile(optimizer=optimizers_mod.deserialize(cfg["optimizer"]),
                      loss=cfg["loss"], metrics=cfg.get("metrics", []),
                      custom_objects=custom_objects, **compile_kwargs)
    return model


# ------------------------------------------------------ training state
def pack_training_state(params, opt_state) -> Dict:
    """THE checkpoint payload (params + the optimizer state's leaves in
    optax's flatten order), one encoding for every model class."""
    leaves = (optimizers_mod.opt_state_leaves(opt_state)
              if opt_state is not None else [])
    return {"params": params,
            "opt_state_leaves": {f"leaf_{i}": leaf
                                 for i, leaf in enumerate(leaves)}}


def restore_params(saved, template):
    """The saved ``params`` tree as tensors shaped, typed and placed as
    ``template``'s leaves (same nesting; dict keys matched by name)."""
    ref, treedef = tree_flatten(template)
    leaves, saved_def = tree_flatten(saved)
    if saved_def != treedef:
        raise ValueError("the checkpoint's parameter tree differs from the "
                         "model's: architectures differ")
    return tree_unflatten(treedef, [tensor_from_host(a, like)
                                    for a, like in zip(leaves, ref)])


def unpack_opt_state(state: Dict, tx, trainable):
    """The optimizer state of a packed ``state`` for parameters
    ``trainable`` (as ``tx.init`` takes them), or None when the
    checkpoint carried no optimizer leaves."""
    leaves_dict = state.get("opt_state_leaves") or {}
    if not leaves_dict:
        return None
    if tx is None:
        raise RuntimeError(
            "checkpoint contains optimizer state but the model is not "
            "compiled — compile() first (compiling after the restore "
            "would silently reset the optimizer moments)")
    leaves = [leaves_dict[f"leaf_{i}"] for i in range(len(leaves_dict))]
    return optimizers_mod.opt_state_from_leaves(tx.init(trainable), leaves)


def unpack_training_state(state: Dict, tx, params_template):
    """Inverse of :func:`pack_training_state`: returns ``(params,
    opt_state)`` on ``params_template``'s devices and dtypes;
    ``opt_state`` is None when the checkpoint carried no optimizer
    leaves. ``tx`` may be None only in that case."""
    params = restore_params(state["params"], params_template)
    return params, unpack_opt_state(state, tx, params)


# ------------------------------------------------ functional-family configs
def _dtype_name(dtype) -> str:
    """numpy's name of a dtype (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def transformer_config_to_dict(config) -> Dict:
    """A ``TransformerConfig`` as the JAX package's JSON-able dict, with
    ``dtype``/``param_dtype`` by numpy name."""
    out = dataclasses.asdict(config)
    for f in ("dtype", "param_dtype"):
        out[f] = _dtype_name(out[f])
    return out


def transformer_config_from_dict(d: Dict):
    """Inverse of :func:`transformer_config_to_dict`."""
    from .transformer import TransformerConfig

    d = dict(d)
    for f in ("dtype", "param_dtype"):
        if isinstance(d.get(f), str):
            d[f] = getattr(torch, d[f])
    return TransformerConfig(**d)


#: the functional families' config classes the JAX package records in
#: checkpoint manifests; only the transformer's is ported
_NOT_PORTED_CONFIGS = {"ViTConfig", "BertConfig", "EncDecConfig", "SSMConfig"}


def config_to_dict(config) -> Dict:
    """Serialize a ``TransformerConfig`` to the JAX package's manifest
    dict (dtypes by numpy name, class recorded)."""
    return {**transformer_config_to_dict(config),
            "__class__": type(config).__name__}


def config_from_dict(d: Dict):
    """Inverse of :func:`config_to_dict`."""
    d = dict(d)
    name = d.pop("__class__")
    if name in _NOT_PORTED_CONFIGS:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                  "Queue 1 item 6)")
    if name != "TransformerConfig":
        raise ValueError(f"unknown config class {name!r}")
    return transformer_config_from_dict(d)


__all__ = ["save_model", "load_model", "read_model_file", "model_entries",
           "write_model_file", "pack_training_state",
           "unpack_training_state", "config_to_dict", "config_from_dict"]
