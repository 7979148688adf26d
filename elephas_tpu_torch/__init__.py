"""elephas_tpu_torch — the PyTorch and CUDA port of elephas_tpu.

A package beside ``elephas_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU becomes a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; there the kernel wrappers take their plain
PyTorch versions.

Ported so far: the transformer's inference path (``forward`` with the
flash-attention forward kernel, ``prefill_cache``), paged decode with
the fused paged-attention kernel, the paged ``DecodeEngine``,
single-device LM training (``lm_loss``, ``make_train_step``, the SGD /
Adam / AdamW / RMSprop optimizers and ``TransformerModel``) with the
flash-attention backward kernels, and the Keras-style models
(``Sequential``, functional ``Model``, Dense / Activation / Dropout /
Flatten / Reshape) with synchronous data-parallel training through
``TPUModel`` (``sync_mode`` "average" and "step") on one device.
"""
from .data.dataset import Dataset
from .models.core import Model, Sequential, model_from_json
from .models.layers import (Activation, Dense, Dropout, Flatten, Input,
                            Reshape)
from .models.optimizers import SGD, Adam, AdamW, RMSprop
from .models.paged_decode import decode_step_paged, init_paged_pool
from .models.transformer import (TransformerConfig, forward, init_params,
                                 lm_loss, make_train_step, prefill_cache)
from .models.transformer_model import TransformerModel
from .serving_engine import DecodeEngine
from .tpu_model import TPUModel
from .utils.dataset_utils import to_dataset
from .weights import from_numpy_tree, to_numpy_tree

__all__ = ["TransformerConfig", "init_params", "forward", "prefill_cache",
           "lm_loss", "make_train_step", "TransformerModel", "SGD", "Adam",
           "AdamW", "RMSprop", "init_paged_pool", "decode_step_paged",
           "DecodeEngine", "from_numpy_tree", "to_numpy_tree", "Sequential",
           "Model", "model_from_json", "Input", "Dense", "Activation",
           "Dropout", "Flatten", "Reshape", "Dataset", "to_dataset",
           "TPUModel"]
