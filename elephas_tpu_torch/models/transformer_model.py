"""TransformerModel: the flagship transformer LM behind a Keras-style
training surface, on one device.

The counterpart of ``elephas_tpu/models/transformer_model.py``:
``build``/``compile``/``fit``/``fit_tokens``/``evaluate``/``predict``,
flat weights in JAX leaf order (so ``set_weights(jax_model.get_weights())``
carries a JAX model's weights across), an EMA of the parameters, and
``engine()`` to serve the trained weights through the port's paged
``DecodeEngine``. Training runs :func:`~elephas_tpu_torch.models.
transformer.make_train_step` on the model's device, which updates the
parameters in place.

Not ported yet: the mesh arguments (``tensor_parallel``,
``sequence_parallel``, ``fsdp``, ``zero_optimizer``, ``mesh``) raise
unless left at their defaults; saving, checkpoints,
``generate``/``beam_search`` and speculative decoding are not here.
"""
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..utils.tracing import StepTimer
from ..weights import tree_flatten, tree_map, tree_unflatten
from .optimizers import Optimizer
from .optimizers import get as get_optimizer
from .transformer import (TransformerConfig, forward, init_params, lm_loss,
                          make_train_step)

__all__ = ["TransformerModel"]


class TransformerModel:
    """Decoder-only transformer LM with the framework's model surface.

    Data convention: "x" is a ``(rows, seq_len)`` int array of token
    ids; next-token targets are the shifted input.

    :param config: :class:`~elephas_tpu_torch.models.transformer.
        TransformerConfig`
    :param grad_accum: accumulate gradients over this many microbatches
        per optimizer step
    :param ema_decay: keep an exponential moving average of the
        parameters, updated after each step; ``apply_ema()`` swaps it in
    :param device: where the parameters live and training runs; None
        means the CUDA device (``device="cpu"`` asks for the CPU)
    """

    def __init__(self, config: TransformerConfig, tensor_parallel: int = 1,
                 name: Optional[str] = None, zero_optimizer: bool = False,
                 grad_accum: int = 1, fsdp: bool = False,
                 sequence_parallel: int = 1,
                 ema_decay: Optional[float] = None, mesh=None,
                 device: DeviceLike = None):
        if (tensor_parallel != 1 or sequence_parallel != 1 or fsdp
                or zero_optimizer or mesh is not None):
            raise NotImplementedError("mesh training (tensor/sequence "
                                      "parallel, fsdp, zero_optimizer, "
                                      "mesh) is not ported yet")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError("ema_decay must be in (0, 1)")
        self.config = config
        self.device = resolve_device(device)
        self.ema_decay = ema_decay
        self.ema_params: Optional[Dict] = None
        self.grad_accum = max(1, int(grad_accum))
        self.name = name or "transformer_model"
        self.params: Optional[Dict] = None
        self.built = False
        self.optimizer: Optional[Optimizer] = None
        self.loss: Optional[str] = None
        self.metrics: List = []
        self._tx = None
        self._opt_state = None
        self._seed = 0

    # ------------------------------------------------------------ lifecycle
    def build(self, input_shape=None, seed: Optional[int] = None):
        if seed is not None:
            self._seed = seed
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self.params = init_params(self.config, gen, self.device)
        self.built = True
        self._opt_state = None
        return self

    def compile(self, optimizer="adam", loss: Optional[str] = None,
                metrics: Optional[Sequence] = None,
                seed: Optional[int] = None, **kwargs):
        """``loss``/``metrics`` exist for API parity and are not read: the
        training loss is always the next-token cross-entropy of
        ``lm_loss``."""
        self.optimizer = get_optimizer(optimizer)
        self.loss = loss or "lm_cross_entropy"
        self.metrics = list(metrics or [])
        self._tx = self.optimizer.to_transform()
        if not self.built or (seed is not None and seed != self._seed):
            self.build(seed=seed)
        self._opt_state = None
        return self

    @property
    def compiled(self) -> bool:
        return self._tx is not None

    # -------------------------------------------------------------- weights
    def get_weights(self) -> List[np.ndarray]:
        """Flat leaf list in JAX pytree order (sorted dict keys)."""
        if self.params is None:
            raise ValueError("Model must be built before get_weights()")
        return [leaf.detach().cpu().numpy()
                for leaf in tree_flatten(self.params)[0]]

    def set_weights(self, weights: Sequence[np.ndarray]):
        if self.params is None:
            raise ValueError("Model must be built before set_weights()")
        leaves, treedef = tree_flatten(self.params)
        if len(leaves) != len(weights):
            raise ValueError(
                f"Expected {len(leaves)} weight arrays, got {len(weights)}")
        new_leaves = []
        for ref, w in zip(leaves, weights):
            w = torch.from_numpy(np.array(w)).to(ref.dtype)
            if w.shape != ref.shape:
                raise ValueError(
                    f"Shape mismatch: {tuple(w.shape)} vs {tuple(ref.shape)}")
            new_leaves.append(w.to(self.device))
        self.params = tree_unflatten(treedef, new_leaves)

    # ------------------------------------------------------------- training
    def fit_tokens(self, tokens: np.ndarray, epochs: int = 1,
                   batch_size: int = 32, validation_split: float = 0.0,
                   seed: int = 0, verbose: int = 0,
                   epoch_callback: Optional[Callable] = None) -> Dict:
        """LM training on the model's device; returns a Keras-style
        history dict (``loss``, ``val_loss`` with a validation split,
        ``epoch_time``).

        Each epoch walks the rows in the order of
        ``np.random.default_rng(seed).permutation``, as the JAX package
        does, so both see the same batches. ``epoch_callback(epoch_idx,
        logs) -> stop?`` fires after each epoch."""
        if not self.compiled:
            raise RuntimeError("compile() the model before fit")
        tokens = np.asarray(tokens)
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be (rows, seq), got {tokens.shape}")
        n_val = int(round(tokens.shape[0] * validation_split))
        if n_val:
            tokens, val_tokens = tokens[:-n_val], tokens[-n_val:]
        if batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size={batch_size} does not split into "
                f"{self.grad_accum} gradient-accumulation microbatches")
        step = make_train_step(self.config, self._tx,
                               accum_steps=self.grad_accum)
        params = self.params
        if self._opt_state is None:
            self._opt_state = self._tx.init(params)
        opt_state = self._opt_state
        if self.ema_decay is not None and self.ema_params is None:
            # a real copy: the step updates the parameters in place
            self.ema_params = tree_map(torch.clone, params)

        rng = np.random.default_rng(seed)
        dropout_gen = None
        if self.config.dropout_rate > 0:
            dropout_gen = torch.Generator(device=self.device)
            dropout_gen.manual_seed(seed)
        n = tokens.shape[0]
        nb = n // batch_size
        if nb == 0:
            raise ValueError(
                f"fewer token rows ({n}) than batch_size ({batch_size})")
        history: Dict[str, List[float]] = {"loss": []}
        if n_val:
            history["val_loss"] = []
        history["epoch_time"] = []
        self.timer = timer = StepTimer()

        for epoch in range(epochs):
            timer.start()
            shuffled = tokens[rng.permutation(n)]
            losses = []
            for i in range(nb):
                xb = torch.as_tensor(
                    shuffled[i * batch_size:(i + 1) * batch_size],
                    device=self.device)
                params, opt_state, loss = step(params, opt_state, xb,
                                               dropout_gen)
                losses.append(loss)
                if self.ema_params is not None:
                    self._ema_update(params)
            # the float() fetches wait for the epoch's steps, so the
            # recorded wall time is real
            logs = {"loss": float(np.mean([float(l) for l in losses]))}
            timer.stop()
            history["epoch_time"].append(timer.durations[-1])
            if n_val:
                with torch.no_grad():
                    logs["val_loss"] = float(lm_loss(
                        params, torch.as_tensor(val_tokens,
                                                device=self.device),
                        self.config))
            for k, v in logs.items():
                history[k].append(v)
            if verbose:
                print(f"epoch {epoch + 1}/{epochs} - " +
                      " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()))
            self.params, self._opt_state = params, opt_state
            if epoch_callback is not None and epoch_callback(epoch, logs):
                break
        return history

    def _ema_update(self, params: Dict) -> None:
        decay = float(self.ema_decay)
        with torch.no_grad():
            for e, p in zip(tree_flatten(self.ema_params)[0],
                            tree_flatten(params)[0]):
                e.copy_(decay * e + (1.0 - decay) * p)

    def fit(self, x, y=None, epochs: int = 1, batch_size: int = 32,
            verbose: int = 0, validation_split: float = 0.0,
            callbacks=None, seed: int = 0, **kwargs) -> Dict:
        """``fit_tokens`` behind the ``(x, y)`` surface (``y`` is
        ignored: LM targets are the shifted input), with Keras-style
        ``callbacks``: each epoch's logs go to ``epoch_end``, and a
        callback that sets ``stop_training`` ends training after that
        epoch."""
        from .callbacks import CallbackList

        cbs = CallbackList(callbacks, self)
        self.stop_training = False
        cbs.train_begin()

        def epoch_cb(epoch, logs):
            cbs.epoch_end(epoch, logs)
            return bool(self.stop_training)

        try:
            return self.fit_tokens(
                x, epochs=epochs, batch_size=batch_size,
                validation_split=validation_split, seed=seed,
                verbose=verbose, epoch_callback=epoch_cb if cbs else None)
        finally:
            cbs.train_end()

    def apply_ema(self):
        """Swap the EMA average in as the live parameters (returns the
        raw training params so callers can swap back)."""
        if self.ema_params is None:
            raise RuntimeError("no EMA state — set ema_decay and fit first")
        raw = self.params
        self.params = tree_map(torch.clone, self.ema_params)
        return raw

    # ------------------------------------------------------ inference/eval
    @torch.no_grad()
    def predict(self, tokens: np.ndarray, batch_size: int = 8,
                verbose: int = 0,
                out: Optional[np.ndarray] = None) -> np.ndarray:
        """f32 logits ``(rows, seq, vocab)`` in input order. ``out``: an
        optional preallocated ``(rows, seq, vocab)`` array (e.g. a
        writable memmap) receiving each batch's logits in place."""
        tokens = np.asarray(tokens)
        outs = []
        for i in range(0, tokens.shape[0], batch_size):
            chunk = forward(self.params,
                            torch.as_tensor(tokens[i:i + batch_size],
                                            device=self.device),
                            self.config).cpu().numpy()
            if out is not None:
                out[i:i + chunk.shape[0]] = chunk
            else:
                outs.append(chunk)
        return out if out is not None else np.concatenate(outs, axis=0)

    @torch.no_grad()
    def evaluate(self, tokens: np.ndarray, y=None, batch_size: int = 8,
                 verbose: int = 0) -> float:
        """Mean next-token loss over the rows (batch-weighted)."""
        tokens = np.asarray(tokens)
        total, count = 0.0, 0
        for i in range(0, tokens.shape[0], batch_size):
            chunk = tokens[i:i + batch_size]
            total += float(lm_loss(
                self.params, torch.as_tensor(chunk, device=self.device),
                self.config)) * len(chunk)
            count += len(chunk)
        return total / max(count, 1)

    def engine(self, draft: Optional["TransformerModel"] = None,
               **engine_kwargs):
        """The port's paged :class:`~elephas_tpu_torch.serving_engine.
        DecodeEngine` over this model's parameters, on its device (pass
        ``paged=(blocks, block_size)``). Speculative drafts are not
        ported yet."""
        from ..serving_engine import DecodeEngine

        if self.params is None:
            raise RuntimeError("build() or load weights before serving")
        if draft is not None:
            raise NotImplementedError("speculative decoding is not ported "
                                      "yet")
        engine_kwargs.setdefault("device", self.device)
        return DecodeEngine(self.params, self.config, **engine_kwargs)
