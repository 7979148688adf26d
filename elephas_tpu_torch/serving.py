"""Serving conveniences: strings in -> strings out.

The counterpart of ``elephas_tpu/serving.py`` (which imports JAX),
rewritten on the port's :func:`~elephas_tpu_torch.models.transformer.
generate`. ``TextGenerator`` ties a tokenizer to the LM's batched
ragged-prompt decode loop: prompts of different lengths batch into one
call (right-padded, with per-row lengths), with temperature, top-k,
nucleus and repetition-penalty sampling, and with a draft model,
speculative decoding for the batches it takes.

Overload safety for this blocking path: ``max_batch_prompts`` /
``max_batch_tokens`` bound what one call may dispatch (an oversized
batch raises :class:`~elephas_tpu_torch.serving_engine.QueueFullError`
with a suggested split), and ``deadline_ms`` refuses to dispatch work
whose deadline already passed during tokenization. The decode loop
itself runs to completion once dispatched; mid-decode control belongs
to :class:`~elephas_tpu_torch.serving_engine.DecodeEngine`.
"""
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.speculative import speculative_generate
from .models.transformer import TransformerConfig, generate
from .serving_engine import DeadlineExceededError, QueueFullError
from .utils.text import ByteTokenizer
from .weights import tree_map

__all__ = ["TextGenerator"]


class TextGenerator:
    """Batched text generation over a parameter dict + config.

    :param params: transformer parameters; moved to ``device``
    :param config: the model's :class:`TransformerConfig`
    :param tokenizer: object with ``encode(str) -> List[int]`` and
        ``decode(ids) -> str`` (default: :class:`ByteTokenizer`)
    :param max_batch_prompts: admission bound on prompts per call; an
        oversized batch raises :class:`QueueFullError` (``None`` =
        unbounded)
    :param max_batch_tokens: admission bound on the total encoded prompt
        tokens per call
    :param draft_params: optional draft-model parameters: uniform-length
        batches with plain sampling (no top-k, top-p or repetition
        penalty) that fit ``max_seq_len`` with ``gamma`` positions to
        spare decode through :func:`~elephas_tpu_torch.models.
        speculative.speculative_generate`; every other call stays on
        :func:`generate`
    :param draft_config: the draft's config (same vocabulary)
    :param gamma: draft tokens proposed per verify round
    :param device: where generation runs; ``None`` means the CUDA device
        and raises without one
    """

    def __init__(self, params, config: TransformerConfig, tokenizer=None,
                 draft_params=None, draft_config=None, gamma: int = 4,
                 max_batch_prompts: Optional[int] = None,
                 max_batch_tokens: Optional[int] = None,
                 device: DeviceLike = None):
        if (draft_params is None) != (draft_config is None):
            raise ValueError("draft_params and draft_config go together")
        if draft_config is not None:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_config.vocab_size} != target "
                    f"vocab {config.vocab_size}")
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
        self.device = resolve_device(device)
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device), params)
        self.config = config
        self.draft_params = (None if draft_params is None else tree_map(
            lambda t: torch.as_tensor(t).to(self.device), draft_params))
        self.draft_config = draft_config
        self.gamma = int(gamma)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_batch_prompts = (None if max_batch_prompts is None
                                  else int(max_batch_prompts))
        if (self.max_batch_prompts is not None
                and self.max_batch_prompts < 1):
            raise ValueError("max_batch_prompts must be None or >= 1")
        self.max_batch_tokens = (None if max_batch_tokens is None
                                 else int(max_batch_tokens))
        if (self.max_batch_tokens is not None
                and self.max_batch_tokens < 1):
            raise ValueError("max_batch_tokens must be None or >= 1")

    def __call__(self, prompts: Sequence[str], max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 repetition_penalty: float = 1.0, seed: int = 0,
                 stop_id: Optional[int] = None,
                 stop_sequences: Optional[Sequence[str]] = None,
                 deadline_ms: Optional[float] = None) -> List[str]:
        """Generate continuations for ``prompts``. Sampling draws from a
        ``torch.Generator`` seeded with ``seed``. ``stop_id`` (default:
        the tokenizer's ``eos_id``) cuts each output at that id;
        ``stop_sequences`` truncates each text at the earliest of the
        given strings (the stop text itself is dropped).

        ``deadline_ms`` bounds admission: if tokenizing the batch alone
        eats the deadline, :class:`DeadlineExceededError` is raised
        before any device work is dispatched."""
        t0 = time.monotonic()
        if deadline_ms is not None and not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        tok = self.tokenizer
        if (self.max_batch_prompts is not None
                and len(prompts) > self.max_batch_prompts):
            raise QueueFullError(
                f"batch of {len(prompts)} prompts exceeds "
                f"max_batch_prompts={self.max_batch_prompts}; split into "
                f"{-(-len(prompts) // self.max_batch_prompts)} calls")
        encoded = [tok.encode(p) for p in prompts]
        lens = np.asarray([len(e) for e in encoded], np.int64)
        if lens.min() < 1:
            raise ValueError("prompts must encode to at least one token")
        if (self.max_batch_tokens is not None
                and int(lens.max()) > self.max_batch_tokens):
            # permanent: no split gets a single over-bound prompt under
            # the cap, so a retryable QueueFullError would loop forever
            raise ValueError(
                f"a single prompt of {int(lens.max())} tokens exceeds "
                f"max_batch_tokens={self.max_batch_tokens} — it could "
                "never be dispatched")
        if (self.max_batch_tokens is not None
                and int(lens.sum()) > self.max_batch_tokens):
            raise QueueFullError(
                f"batch of {int(lens.sum())} prompt tokens exceeds "
                f"max_batch_tokens={self.max_batch_tokens}; split the "
                "batch or trim the prompts")
        if (deadline_ms is not None
                and (time.monotonic() - t0) * 1000.0 >= deadline_ms):
            raise DeadlineExceededError(
                f"deadline of {deadline_ms}ms expired during admission "
                "(before any device work was dispatched)")
        batch = np.full((len(encoded), int(lens.max())),
                        getattr(tok, "pad_id", 0), np.int64)
        for i, e in enumerate(encoded):
            batch[i, :len(e)] = e
        uniform = int(lens.min()) == batch.shape[1]
        key = torch.Generator(device=self.device).manual_seed(int(seed))
        plain_sampling = (top_k is None and top_p is None
                          and repetition_penalty == 1.0)
        # the speculative cache needs gamma positions past the last
        # token: calls near max_seq_len stay on generate()
        fits = self.draft_config is not None and all(
            batch.shape[1] + int(max_new_tokens) + self.gamma
            <= c.max_seq_len for c in (self.config, self.draft_config))
        if uniform and plain_sampling and fits:
            out = speculative_generate(
                self.params, self.draft_params, batch, int(max_new_tokens),
                self.config, self.draft_config, gamma=self.gamma,
                temperature=temperature, key=key)
        else:
            out = generate(self.params, batch, int(max_new_tokens),
                           self.config, temperature=temperature, key=key,
                           top_k=top_k, top_p=top_p,
                           repetition_penalty=repetition_penalty,
                           prompt_lengths=None if uniform else lens)
        stop = stop_id if stop_id is not None else getattr(tok, "eos_id",
                                                           None)
        texts = []
        for row in out.cpu().tolist():
            if stop is not None and stop in row:
                row = row[:row.index(stop)]
            text = tok.decode(row)
            if stop_sequences:
                # empty stops are skipped: find("") is 0 for every string
                cut = min((idx for idx in (text.find(s)
                                           for s in stop_sequences if s)
                           if idx >= 0), default=-1)
                if cut >= 0:
                    text = text[:cut]
            texts.append(text)
        return texts
