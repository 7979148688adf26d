"""The model stack of the port: the Keras-style layers and models, the
transformer LM, their optimizers, callbacks and persistence."""
from . import (activations, initializers, losses, metrics, optimizers,
               schedules)
from .callbacks import (Callback, CallbackList, EarlyStopping,
                        LambdaCallback, ModelCheckpoint)
from .core import BaseModel, History, Model, Sequential, model_from_json
from .layers import (GRU, LSTM, Activation, Add, AveragePooling2D,
                     BatchNormalization, Concatenate, Conv2D, Dense, Dropout,
                     Embedding, Flatten, GlobalAveragePooling2D, Input,
                     InputLayer, KTensor, Layer, LayerNormalization,
                     MaxPooling2D, Multiply, Reshape, deserialize_layer,
                     register_layer, reset_layer_uids, serialize_layer)
from .optimizers import (LAMB, SGD, Adadelta, Adafactor, Adagrad, Adam,
                         AdamW, Lion, Nadam, Optimizer, RMSprop)
from .optimizers import deserialize as deserialize_optimizer
from .optimizers import get as get_optimizer
from .optimizers import serialize as serialize_optimizer
from .saving import load_model, save_model
from .schedules import (CosineDecay, ExponentialDecay,
                        PiecewiseConstantDecay, WarmupCosine)
from .transformer_model import TransformerModel

__all__ = ["activations", "initializers", "losses", "metrics", "optimizers",
           "schedules", "Callback", "CallbackList", "EarlyStopping", "LambdaCallback",
           "ModelCheckpoint", "load_model", "save_model",
           "BaseModel", "History", "Model", "Sequential", "model_from_json",
           "Activation", "Add", "AveragePooling2D", "BatchNormalization",
           "Concatenate", "Conv2D", "Dense", "Dropout", "Embedding",
           "Flatten", "GRU", "GlobalAveragePooling2D", "Input",
           "InputLayer", "KTensor", "LSTM", "Layer", "LayerNormalization",
           "MaxPooling2D", "Multiply", "Reshape", "deserialize_layer",
           "register_layer", "reset_layer_uids", "serialize_layer", "SGD",
           "Adam", "AdamW", "Adagrad", "Adadelta", "Nadam", "Adafactor",
           "Lion", "LAMB", "Optimizer", "RMSprop", "CosineDecay",
           "ExponentialDecay", "PiecewiseConstantDecay", "WarmupCosine",
           "deserialize_optimizer", "get_optimizer", "serialize_optimizer",
           "TransformerModel"]
