"""elephas_tpu_torch — the PyTorch and CUDA port of elephas_tpu.

A package beside ``elephas_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU becomes a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; there the kernel wrappers take their plain
PyTorch versions.

Ported so far: the transformer's inference path (``forward`` with the
flash-attention forward kernel, the cached decode family:
``prefill_cache``, ``decode_step``, ``generate``, ``beam_search``),
paged decode with the fused paged-attention kernel, the serving engine
``DecodeEngine`` (contiguous or paged cache, ``steps_per_sync``,
chunked prefill, registered prefixes and the automatic prefix cache)
with its HTTP front ``ServingServer`` and ``TextGenerator``,
single-device LM training (``lm_loss``, ``make_train_step``,
``TransformerModel``) with the flash-attention backward kernels, every
optimizer of the JAX package (SGD, Adam, AdamW, RMSprop, Adagrad,
Adadelta, Nadam, Adafactor, Lion, LAMB) and its learning-rate
schedules, and the Keras-style models (``Sequential``, functional
``Model``, and every layer of the JAX package: Dense, Activation,
Dropout, Flatten, Reshape, Conv2D and the pools, Embedding, LSTM, GRU,
LayerNormalization, BatchNormalization with its moving statistics, and
the merges) with synchronous data-parallel training through
``TPUModel`` (``sync_mode`` "average" and "step") on one device, its
asynchronous and hogwild modes with one parameter server, and
persistence: model files (``save_model``/``load_model``,
``TPUModel.save``/``load_tpu_model``), step checkpoints with bit-exact
resume (``ModelCheckpoint``, ``restore_training_state``) and
``TPUMatrixModel`` over the ``mllib`` types.
"""
from .data.dataset import Dataset
from .models.core import Model, Sequential, model_from_json
from .models.layers import (GRU, LSTM, Activation, Add, AveragePooling2D,
                            BatchNormalization, Concatenate, Conv2D, Dense,
                            Dropout, Embedding, Flatten,
                            GlobalAveragePooling2D, Input,
                            LayerNormalization, MaxPooling2D, Multiply,
                            Reshape)
from .models.optimizers import (LAMB, SGD, Adadelta, Adafactor, Adagrad,
                                Adam, AdamW, Lion, Nadam, RMSprop)
from .models.paged_decode import decode_step_paged, init_paged_pool
from .models.transformer import (TransformerConfig, beam_search, forward,
                                 generate, init_params, lm_loss,
                                 make_train_step, prefill_cache)
from .models.transformer_model import TransformerModel
from .serving import TextGenerator
from .serving_engine import DecodeEngine, QueueFullError
from .serving_http import ServingServer
from .tpu_model import TPUMatrixModel, TPUModel, load_tpu_model
from .utils.dataset_utils import to_dataset, to_labeled_points
from .weights import from_numpy_tree, to_numpy_tree

__all__ = ["TransformerConfig", "init_params", "forward", "prefill_cache",
           "generate", "beam_search", "lm_loss", "make_train_step",
           "TransformerModel", "SGD", "Adam", "AdamW", "RMSprop",
           "Adagrad", "Adadelta", "Nadam", "Adafactor", "Lion", "LAMB",
           "init_paged_pool", "decode_step_paged", "DecodeEngine",
           "QueueFullError", "ServingServer", "TextGenerator",
           "from_numpy_tree", "to_numpy_tree", "Sequential",
           "Model", "model_from_json", "Input", "Dense", "Activation",
           "Dropout", "Flatten", "Reshape", "Conv2D", "MaxPooling2D",
           "AveragePooling2D", "GlobalAveragePooling2D", "Embedding",
           "LSTM", "GRU", "LayerNormalization", "BatchNormalization",
           "Add", "Multiply", "Concatenate", "Dataset", "to_dataset",
           "to_labeled_points", "TPUModel", "TPUMatrixModel",
           "load_tpu_model"]
