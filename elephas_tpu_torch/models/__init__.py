"""The model stack of the port: the Keras-style layers and models, the
transformer LM, their optimizers and callbacks."""
from . import activations, initializers, losses, metrics, optimizers
from .callbacks import Callback, CallbackList, EarlyStopping, LambdaCallback
from .core import BaseModel, History, Model, Sequential, model_from_json
from .layers import (Activation, Dense, Dropout, Flatten, Input, InputLayer,
                     KTensor, Layer, Reshape, deserialize_layer,
                     register_layer, reset_layer_uids, serialize_layer)
from .optimizers import SGD, Adam, AdamW, Optimizer, RMSprop
from .optimizers import deserialize as deserialize_optimizer
from .optimizers import get as get_optimizer
from .optimizers import serialize as serialize_optimizer
from .transformer_model import TransformerModel

__all__ = ["activations", "initializers", "losses", "metrics", "optimizers",
           "Callback", "CallbackList", "EarlyStopping", "LambdaCallback",
           "BaseModel", "History", "Model", "Sequential", "model_from_json",
           "Activation", "Dense", "Dropout", "Flatten", "Input",
           "InputLayer", "KTensor", "Layer", "Reshape", "deserialize_layer",
           "register_layer", "reset_layer_uids", "serialize_layer", "SGD",
           "Adam", "AdamW", "Optimizer", "RMSprop", "deserialize_optimizer",
           "get_optimizer", "serialize_optimizer", "TransformerModel"]
