"""Continuous-batching decode engine (slot-based online serving).

The counterpart of ``elephas_tpu/serving_engine.py`` ``DecodeEngine``:
a fixed device batch of ``max_slots`` decode slots, each at its own
sequence position. Requests queue FIFO and join the running batch the
moment a slot (and, in paged mode, enough blocks) frees up; each
:meth:`DecodeEngine.step` advances every active slot and retires the
requests that hit eos or their budget. Per-request greedy output equals
:func:`~elephas_tpu_torch.models.transformer.generate` on that request
alone (f32; under bf16 an argmax near-tie may resolve differently
between the two programs).

Two cache layouts, as in the JAX package:

- the contiguous cache (the default, ``paged=None``): one
  :func:`~elephas_tpu_torch.models.transformer.init_kv_cache` row per
  slot; admission installs the prefilled row and each step is a
  :func:`~elephas_tpu_torch.models.transformer.decode_step` over every
  slot at its own position;
- the paged pool (``paged=(num_blocks, block_size)``): one shared block
  pool with per-slot block tables, stepped by
  :func:`~elephas_tpu_torch.models.paged_decode.decode_step_paged`.
  ``kernel="fused"`` runs its attention as the hand-written CUDA kernel
  (``csrc/paged_decode.cu``): on a CUDA device the kernel launches on
  every paged step or the step raises, never falling back to gather.

On top of either: ``steps_per_sync`` (K decode steps issued back to
back with one device-to-host read of their tokens), ``prefill_chunk``
(admission prefill in fixed-size :func:`~elephas_tpu_torch.models.
transformer.decode_block` passes), ``interleave_prefill`` (those chunks
fed between decode steps, one a step, instead of at admission),
explicit prefixes (:meth:`DecodeEngine.register_prefix`), the automatic
content-addressed prefix cache (:meth:`DecodeEngine.enable_prefix_cache`;
on by default in paged mode, where hits are block-table pointers, host
block copies on a contiguous engine), :meth:`DecodeEngine.warmup`,
cancellation and a bounded queue (:class:`QueueFullError`).

Speculative mode (``draft_params``/``draft_config``): each step is one
draft-propose / target-verify round
(:func:`~elephas_tpu_torch.models.speculative.speculative_round`, or
:func:`~elephas_tpu_torch.models.speculative.speculative_round_paged`
over the pool), so a slot advances by ``1 + accepted`` tokens a step.
Every capacity rule reserves ``gamma`` positions of verify slack per
slot; ``adaptive_gamma`` steers the operating depth from an EWMA of the
measured acceptance. The draft's cache stays contiguous and is
prefilled at every admission.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP Queue 1 item-1 step: live draft weight staging (6), QoS,
deadlines, per-request seeds and priorities (7), KV spill, sessions and
the disaggregated tier (8), the metrics registry and the loop profiler
(9). Unlike the JAX package, the caches and the pool are updated IN
PLACE.
"""
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.block_cache import BlockCache, chain_keys
from .models.paged_decode import (KERNELS, decode_step_paged,
                                  gather_blocks_to_row, init_paged_pool,
                                  install_row_paged, validate_paged_config)
from .models.speculative import speculative_round, speculative_round_paged
from .models.transformer import (NEG_INF, TransformerConfig, chunked_blocks,
                                 decode_block, decode_step, init_kv_cache,
                                 prefill_cache)
from .ops.paged_attention import paged_decode_attention
from .utils.faults import fault_site
from .weights import tree_map

__all__ = ["DecodeEngine", "QueueFullError", "DeadlineExceededError",
           "validate_sampling_overrides"]


class QueueFullError(RuntimeError):
    """Admission rejected: accepting the request would exceed the
    engine's queue-depth or queued-token bound (or a ``serving.submit``
    fault-plan ``drop`` simulated the same). Carries ``retry_after_ms``,
    a backoff hint from recent request latency and the current backlog;
    the HTTP layer forwards it with its 429."""

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class DeadlineExceededError(RuntimeError):
    """A request's deadline passed before any work was dispatched for it
    (the blocking :class:`~elephas_tpu_torch.serving.TextGenerator`
    path)."""


def _filter_logits_rows(logits: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k, then nucleus, filters over ``(B, V)`` logits.
    ``top_k[b] <= 0`` and ``top_p[b] >= 1`` disable the filter for that
    row; the top token is always kept."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kidx = torch.clamp(top_k - 1, 0, v - 1).long()
    kth = torch.gather(sorted_desc, 1, kidx[:, None])
    k_thr = torch.where(((top_k > 0) & (top_k < v))[:, None], kth,
                        -torch.inf)
    logits = torch.where(logits >= k_thr, logits, NEG_INF)
    # top-k masking cannot reorder survivors: mask the first sort
    sorted_desc = torch.where(sorted_desc >= k_thr, sorted_desc, NEG_INF)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[:, :1], dtype=torch.bool),
         cum[:, :-1] < top_p[:, None]], dim=-1)
    p_kth = torch.where(keep_sorted, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    p_thr = torch.where(top_p[:, None] < 1.0, p_kth, -torch.inf)
    return torch.where(logits >= p_thr, logits, NEG_INF)


def validate_sampling_overrides(temperature, top_k, top_p) -> None:
    """Per-request sampling validation; ``None`` means the engine
    default."""
    if temperature is not None:
        if not (temperature >= 0 and np.isfinite(temperature)):
            raise ValueError("temperature must be >= 0 and finite, "
                             f"got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _not_ported(what: str, step: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 1, step {step})")


#: ``submit`` keywords of the JAX engine that belong to later steps
_LATER_SUBMIT_ARGS = {"deadline_ms": 7, "tenant": 7, "priority": 7,
                      "seed": 7, "resume_from": 8, "session": 8}

#: adaptive gamma: EWMA smoothing of each round's pooled acceptance (0.4
#: weights the last ~4 rounds), and rounds between depth adjustments of
#: one step each (hysteresis against chattering); the JAX engine's values
GAMMA_EWMA_ALPHA = 0.4
GAMMA_ADJUST_EVERY = 4


class DecodeEngine:
    """Slot-based continuous batching over one parameter dict.

    :param params: transformer parameters (:func:`~elephas_tpu_torch.
        models.transformer.init_params` or the weight bridge); moved to
        ``device``
    :param config: the model's :class:`TransformerConfig`
    :param max_slots: device batch width (concurrent requests)
    :param max_len: positions per request (default
        ``config.max_seq_len``); each request needs ``len(prompt) +
        max_new_tokens <= max_len``
    :param temperature: 0 = greedy, otherwise categorical sampling
    :param eos_id: optional stop token (not part of the output)
    :param seed: seeds the engine's ``torch.Generator``, which drives
        every sampled token
    :param steps_per_sync: decode steps issued per :meth:`step`, with
        one device-to-host read of all their tokens: each slot's chain
        stays autoregressive, so per-slot output is unchanged; a slot
        that hits eos or its budget mid-chunk has its surplus tokens
        dropped on the host
    :param prefill_chunk: admission (and prefix registration) prefills
        in ``prefill_chunk``-token :func:`decode_block` passes plus one
        natural-size tail, instead of one whole-prompt pass
    :param paged: ``(num_blocks, block_size)`` of a shared block pool
        (``None``: the contiguous per-slot cache). Block 0 is a scratch
        sink that is never allocated
    :param max_queue: bound on queued (not yet admitted) requests; a
        submit past it raises :class:`QueueFullError` (``None`` =
        unbounded)
    :param max_queued_tokens: bound on the prompt tokens waiting in the
        queue
    :param prefix_cache: the automatic content-addressed KV block cache:
        ``None`` = on in paged mode, off otherwise
    :param prefix_cache_block_size: host-mode (contiguous) cache block
        size in tokens (default 64); paged engines cache at the pool's
        block size
    :param prefix_cache_capacity: host-mode bound on cached blocks
        (default 1024; pinned prefix blocks are exempt)
    :param kernel: paged decode attention: ``"gather"`` (materialize
        each row's blocks) or ``"fused"`` (the CUDA kernel reading the
        pool directly; its plain version on the CPU)
    :param draft_params: draft-model parameters switching every slot to
        speculative stepping: each :meth:`step` runs one draft-propose /
        target-verify round at the engine ``temperature`` (per-request
        sampling overrides apply to the admission token only, as in the
        JAX engine); per-request greedy output is unchanged (still
        equal to solo ``generate``), only the number of steps shrinks
    :param draft_config: the draft's config (same vocabulary)
    :param gamma: draft tokens proposed per round; the ceiling under
        ``adaptive_gamma``. Every capacity rule (``max_len``, the paged
        per-slot blocks) reserves ``gamma`` positions of verify slack
    :param adaptive_gamma: steer the operating depth between
        ``gamma_min`` and ``gamma`` from an EWMA of the measured
        acceptance, one step at most every ``GAMMA_ADJUST_EVERY``
        rounds (greedy output is the same under any depth schedule)
    :param gamma_min: adaptive gamma's floor
    :param interleave_prefill: feed chunked admission prefills between
        decode steps (one ``prefill_chunk`` chunk a step, the JAX
        engine's budget without a loop profiler) instead of running each
        to completion at admission, so a long prompt no longer stalls
        in-flight decodes; outputs are unchanged. Requires
        ``prefill_chunk``
    :param device: where the engine runs; ``None`` means the CUDA device
        and raises without one

    The remaining arguments of the JAX signature (``qos``, ``clock``,
    ``kv_spill``, ``session_store``, ``tier``, ``registry``,
    ``profiler``) raise ``NotImplementedError`` when set to anything but
    their defaults.
    """

    def __init__(self, params: Dict, config: TransformerConfig,
                 max_slots: int = 8, max_len: Optional[int] = None,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, draft_params: Optional[Dict] = None,
                 draft_config: Optional[TransformerConfig] = None,
                 gamma: int = 4, steps_per_sync: int = 1,
                 prefill_chunk: Optional[int] = None,
                 paged: Optional[Tuple[int, int]] = None,
                 max_queue: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 clock=None, tier: str = "colocated", registry=None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_block_size: Optional[int] = None,
                 prefix_cache_capacity: Optional[int] = None,
                 qos=None, profiler=None, kv_spill=None,
                 session_store=None, kernel: str = "gather",
                 kernel_interpret: Optional[bool] = None,
                 adaptive_gamma: bool = False, gamma_min: int = 1,
                 interleave_prefill: bool = False,
                 device: DeviceLike = None):
        if qos is not None or clock is not None:
            raise _not_ported("QoS and deadlines (qos, clock)", 7)
        if kv_spill or session_store or tier != "colocated":
            raise _not_ported("KV spill, sessions and the disaggregated "
                              "tier (kv_spill, session_store, tier)", 8)
        if registry is not None or profiler not in (None, False):
            raise _not_ported("the metrics registry and the loop profiler "
                              "(registry, profiler)", 9)
        if kernel_interpret is not None:
            raise NotImplementedError(
                "kernel_interpret selects the JAX package's Pallas "
                "interpreter; the port has none (on CPU tensors the fused "
                "kernel's wrapper runs its plain version)")
        self.device = resolve_device(device)
        self.config = config
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or config.max_seq_len)
        if self.max_len > config.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds "
                             f"config.max_seq_len {config.max_seq_len}")
        self.temperature = float(temperature)
        self.eos_id = eos_id
        if (draft_params is None) != (draft_config is None):
            raise ValueError("draft_params and draft_config go together")
        if draft_config is not None:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_config.vocab_size} != target "
                    f"vocab {config.vocab_size}")
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
            if self.max_len > draft_config.max_seq_len:
                raise ValueError(
                    f"max_len {self.max_len} exceeds draft max_seq_len "
                    f"{draft_config.max_seq_len}")
        self.draft_config = draft_config
        self.gamma = int(gamma)
        # ``gamma`` is the CEILING: the verify slack and the paged block
        # budget are sized to it, so the adaptive controller can only
        # shrink the operating depth ``_gamma_now`` below what admission
        # reserved
        self.adaptive_gamma = bool(adaptive_gamma)
        self.gamma_min = int(gamma_min)
        if self.adaptive_gamma and draft_config is None:
            raise ValueError("adaptive_gamma requires a draft model "
                             "(draft_params/draft_config)")
        if draft_config is not None and not (
                1 <= self.gamma_min <= self.gamma):
            raise ValueError(f"gamma_min {self.gamma_min} must satisfy "
                             f"1 <= gamma_min <= gamma ({self.gamma})")
        self._gamma_now = self.gamma
        self._accept_ewma: Optional[float] = None
        self._rounds_since_adjust = 0
        # a round writes up to gamma positions past the last emitted
        # token: every capacity rule reserves them
        self._slack = self.gamma if draft_config is not None else 0
        self.steps_per_sync = int(steps_per_sync)
        if self.steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        if self.steps_per_sync > 1 and draft_config is not None:
            raise ValueError("steps_per_sync > 1 applies to plain "
                             "stepping; speculative mode already "
                             "amortizes dispatches via draft rounds")
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.interleave_prefill = bool(interleave_prefill)
        if self.interleave_prefill and self.prefill_chunk is None:
            raise ValueError("interleave_prefill requires prefill_chunk")
        # slot -> state of an admission whose prompt is fed chunk by
        # chunk between decode steps: the slot is reserved (not free)
        # but not decoding yet
        self._pending_prefill: Dict[int, Dict] = {}
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                             f"{KERNELS}")
        self.paged = None
        if paged is not None:
            validate_paged_config(config)
            num_blocks, block_size = int(paged[0]), int(paged[1])
            if block_size < 1 or num_blocks < 2:
                raise ValueError("paged needs block_size >= 1 and "
                                 "num_blocks >= 2 (block 0 is the reserved "
                                 "scratch sink)")
            self.paged = (num_blocks, block_size)
        elif kernel == "fused":
            raise ValueError("kernel='fused' is the paged decode-attention "
                             "kernel; it requires paged=(num_blocks, "
                             "block_size)")
        self.kernel = kernel
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device), params)
        self.draft_params = (None if draft_params is None else tree_map(
            lambda t: torch.as_tensor(t).to(self.device), draft_params))
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        if self.paged is not None:
            num_blocks, block_size = self.paged
            # per-slot table width: enough blocks to cover max_len
            self._mb = -(-self.max_len // block_size)
            self.cache = None      # the pool replaces the contiguous cache
            self.pool = init_paged_pool(config, num_blocks, block_size,
                                        self.device)
            self._tables = np.zeros((self.max_slots, self._mb), np.int32)
            self._free_block_ids = deque(range(1, num_blocks))  # 0 = sink
        else:
            self.pool = None
            self.cache = init_kv_cache(config, self.max_slots, self.max_len,
                                       self.device)
        # the draft's KV: contiguous, private to the proposer, prefilled
        # at every admission and never cached
        self.draft_cache = (None if draft_config is None else
                            init_kv_cache(draft_config, self.max_slots,
                                          self.max_len, self.device))
        # per slot: PRIVATE pool block ids, and the SHARED prefix-cache
        # entries its table points at (refcounted, released on retirement)
        self._slot_blocks: List[List[int]] = [[] for _ in
                                              range(self.max_slots)]
        self._slot_cached: List[List] = [[] for _ in range(self.max_slots)]
        # host-side slot state: position of the last PROCESSED token, the
        # pending (emitted, not yet processed) token, budgets, sampling
        self._pos = np.zeros(self.max_slots, np.int32)
        self._last = np.zeros(self.max_slots, np.int32)
        self._budget = np.zeros(self.max_slots, np.int32)
        self._temp = np.full(self.max_slots, self.temperature, np.float32)
        self._topk = np.zeros(self.max_slots, np.int32)     # 0 = off
        self._topp = np.ones(self.max_slots, np.float32)    # 1 = off
        self._rid: List[Optional[int]] = [None] * self.max_slots
        self._queue: deque = deque()
        self._queued_tokens = 0
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be None or >= 1 (the HTTP "
                             "server's admit=False submits always pass "
                             "through the queue)")
        self.max_queued_tokens = (None if max_queued_tokens is None
                                  else int(max_queued_tokens))
        if (self.max_queued_tokens is not None
                and self.max_queued_tokens < 1):
            raise ValueError("max_queued_tokens must be None or >= 1")
        self._outputs: Dict[int, List[int]] = {}
        self._done: Dict[int, List[int]] = {}
        # rid -> [token]: admission-time first tokens awaiting step()
        self._fresh: Dict[int, List[int]] = {}
        self._next_rid = 0
        # wall-clock bookkeeping: submit/admit stamps per rid and a
        # window of finished (queue_wait_s, total_s, tokens) samples
        self._submit_t: Dict[int, float] = {}
        self._admit_t: Dict[int, float] = {}
        self._latency_window: deque = deque(maxlen=1024)
        self._steps = self._emitted = self._finished = self._shed = 0
        self._prefix_hits = self._prefix_tokens = 0
        # speculative counters (accepted and proposed over active slots,
        # slot-rounds) and per-request [accepted, proposed], kept until
        # the result is read
        self._accepted = self._proposed = self._spec_rounds = 0
        self._accept: Dict[int, List[int]] = {}
        self._interleaved = 0
        self._launch_base = paged_decode_attention.launches
        #: chain keys are seeded with the served weight version (always 0:
        #: live weight staging is not ported)
        self.weights_version = 0
        # registered prefixes, longest first: (tokens, last-position
        # logits (vocab,), batch-1 row cache, the draft's row or None)
        self._prefixes: List[Tuple] = []
        self._kv_cache: Optional[BlockCache] = None
        self._kv_cache_bs: Optional[int] = None
        if prefix_cache is None:
            prefix_cache = self.paged is not None
        if prefix_cache:
            self.enable_prefix_cache(block_size=prefix_cache_block_size,
                                     capacity=prefix_cache_capacity)
        elif (prefix_cache_block_size is not None
                or prefix_cache_capacity is not None):
            raise ValueError("prefix_cache_block_size/prefix_cache_capacity "
                             "given with prefix_cache disabled")

    # ------------------------------------------------------------ warmup
    def warmup(self, prompt_lengths: Sequence[int] = ()):
        """Run each hot program once before traffic arrives: the decode
        step (``steps_per_sync`` of them, with the paged kernel's build
        on its first launch) and, for each length in ``prompt_lengths``,
        the admission prefill exactly as an admission runs it plus the
        install. Needs an idle engine: it writes into free slot 0's row
        (the scratch block in paged mode), which the next admission
        overwrites."""
        if (any(r is not None for r in self._rid) or self._queue
                or self._pending_prefill):
            raise RuntimeError("warmup() needs an idle engine")
        idle = np.zeros(self.max_slots, np.int32)
        if self.draft_config is not None:
            self._spec_round(idle, self._gamma_now)
        else:
            self._decode_tokens(idle, np.zeros(self.max_slots, bool))
        for length in sorted(set(int(n) for n in prompt_lengths)):
            if not 1 <= length < self.max_len:
                raise ValueError(f"prompt length {length} out of range")
            fake = np.zeros(length, np.int32)
            _, row = self._prefill_with_prefixes(fake, None)
            if self.paged is not None:
                install_row_paged(self.pool, row, self._tables[0],
                                  -(-length // self.paged[1]))
            else:
                self._install(self.cache, 0, row)
            if self.draft_config is not None:
                _, d_row = self._prefill_with_prefixes(fake, None,
                                                       draft=True)
                self._install(self.draft_cache, 0, d_row)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------- prefixes
    def _fresh_row(self, draft: bool = False) -> Dict:
        return init_kv_cache(self.draft_config if draft else self.config, 1,
                             self.max_len, self.device)

    def register_prefix(self, tokens: Sequence[int]) -> None:
        """Precompute a shared prompt prefix (a system prompt): any later
        request whose prompt starts with these tokens prefills only its
        suffix, through one :func:`decode_block` over the prefix's
        cached row. Longest registered match wins. Each registration
        holds one batch-1 row on the device until :meth:`clear_prefixes`;
        with the block cache on, the prefix's full blocks are also pinned
        there."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prefix must hold at least one token")
        if tokens.size >= self.max_len:
            raise ValueError(f"prefix ({tokens.size}) must leave room "
                             f"below max_len {self.max_len}")
        logits, row = self._prefill_with_prefixes(tokens, None)
        d_row = None
        if self.draft_config is not None:
            _, d_row = self._prefill_with_prefixes(tokens, None, draft=True)
        self._prefixes.append((tokens, logits, row, d_row))
        self._prefixes.sort(key=lambda e: -e[0].size)
        if self._kv_cache is not None:
            self._pin_prefix_blocks(tokens, row)

    def _pin_prefix_blocks(self, tokens: np.ndarray, row: Dict) -> None:
        """A registered prefix's FULL blocks enter the block cache pinned
        (never parked, never evicted), so matching admissions hit them
        through the ordinary chain walk; the sub-block tail keeps riding
        the registered row. A pool too full to hold a pin skips it."""
        cache, bs = self._kv_cache, self._kv_cache_bs
        nfull = tokens.size // bs
        if nfull == 0:
            return
        keys = chain_keys(tokens[:nfull * bs], bs, self.weights_version)
        if self.paged is None:
            missing = [i for i, key in enumerate(keys)
                       if cache.get(key) is None]
            payloads = dict(zip(missing,
                                self._host_cache_payloads(row, missing)))
            for i, key in enumerate(keys):
                entry = cache.get(key)
                if entry is None:
                    entry = cache.insert(key, payloads[i], (i + 1) * bs)
                cache.pin(entry)
            return
        ids = np.zeros(nfull, np.int32)
        for i, key in enumerate(keys):
            entry = cache.get(key)
            if entry is None:
                if (not self._free_block_ids
                        and not cache.reclaimable_count()):
                    break
                ids[i] = self._alloc_block()
                entry = cache.insert(key, int(ids[i]), (i + 1) * bs)
            cache.pin(entry)
        # one install per run of newly allocated blocks
        i = 0
        while i < nfull:
            if not ids[i]:
                i += 1
                continue
            j = i
            while j < nfull and ids[j]:
                j += 1
            install_row_paged(self.pool, row, ids, j, start=i)
            i = j

    def clear_prefixes(self) -> None:
        """Drop every registered prefix (frees their rows) and lift the
        block cache's pins: unpinned entries park on the LRU reclaim list
        and age out under pressure."""
        self._prefixes = []
        if self._kv_cache is not None:
            self._kv_cache.unpin_all()

    def _match_prefix(self, prompt: np.ndarray):
        for entry in self._prefixes:                    # longest first
            p = entry[0]
            if p.size <= prompt.size and np.array_equal(prompt[:p.size], p):
                return entry
        return None

    def _model(self, draft: bool):
        """(params, config) of the draft or the target."""
        if draft:
            return self.draft_params, self.draft_config
        return self.params, self.config

    def _extend(self, row: Dict, tokens: np.ndarray, pos0: int,
                draft: bool = False):
        """Continue ``row`` (engine-owned, written in place) past
        ``pos0`` with ``tokens``: in ``prefill_chunk``-sized
        :func:`decode_block` passes when ``prefill_chunk`` is set, else
        one. Returns (last-position logits ``(vocab,)``, row)."""
        params, cfg = self._model(draft)
        toks = torch.as_tensor(tokens[None], device=self.device)
        if self.prefill_chunk is not None:
            logits, row = chunked_blocks(
                lambda cache, blk, pos, _first: decode_block(
                    params, cache, blk, pos, cfg),
                row, toks, int(pos0), self.prefill_chunk)
        else:
            logits, row = decode_block(params, row, toks, int(pos0), cfg)
        return logits[0, -1], row

    def _prefill_with_prefixes(self, prompt: np.ndarray, entry,
                               draft: bool = False):
        """Batch-1 prefill of the target (or the draft) that reuses a
        matched prefix ``entry``'s row (copied: the registered row stays
        as it is). Returns (last-position logits ``(vocab,)``, row)."""
        params, cfg = self._model(draft)
        if entry is None:
            if self.prefill_chunk is not None:
                return self._extend(self._fresh_row(draft), prompt, 0,
                                    draft)
            logits, row = prefill_cache(
                params, torch.as_tensor(prompt[None], device=self.device),
                cfg, self.max_len)
            return logits[0], row
        ptoks, plogits, prow, pdrow = entry
        prow = pdrow if draft else prow
        if prompt.size == ptoks.size:
            return plogits, prow
        row = tree_map(torch.clone, prow)
        return self._extend(row, prompt[ptoks.size:], int(ptoks.size), draft)

    # ------------------------------------------------- automatic KV cache
    def enable_prefix_cache(self, block_size: Optional[int] = None,
                            capacity: Optional[int] = None) -> None:
        """Turn on the automatic content-addressed KV block cache: every
        full ``block_size`` block of an admitted prompt is keyed by the
        hash chain of its tokens, and admission reuses the longest cached
        chain, prefilling only the remainder. Paged engines cache pool
        blocks (a hit is a table pointer, refcounted while in use, parked
        on an LRU list when not); contiguous engines cache host copies (a
        hit is one host-to-device copy), LRU-bounded by ``capacity``.
        Call before traffic; a no-op when already on."""
        if self._kv_cache is not None:
            return
        if self.paged is not None:
            if block_size is not None and int(block_size) != self.paged[1]:
                raise ValueError(
                    f"paged engines cache at the pool block size "
                    f"{self.paged[1]}, got prefix_cache_block_size="
                    f"{block_size}")
            self._kv_cache_bs = self.paged[1]
            self._kv_cache = BlockCache(on_evict=self._on_cache_evict)
        else:
            self._kv_cache_bs = int(block_size or 64)
            if not 1 <= self._kv_cache_bs < self.max_len:
                raise ValueError(
                    f"prefix_cache_block_size {self._kv_cache_bs} out of "
                    f"range [1, max_len={self.max_len})")
            self._kv_cache = BlockCache(
                capacity=1024 if capacity is None else int(capacity),
                on_evict=self._on_cache_evict)
        self._chain_memo = None     # (rid, walk_keys, insert_keys)

    def _on_cache_evict(self, entry) -> None:
        if self.paged is not None:
            self._free_block_ids.append(entry.payload)

    def _cache_chain_keys(self, prompt: np.ndarray):
        """(walk_keys, insert_keys): insert keys cover every full block;
        the walk stops one block earlier on a block-aligned prompt, so
        the remainder prefill (which yields the first token's logits) is
        never empty."""
        bs = self._kv_cache_bs
        nfull = prompt.size // bs
        ins_keys = chain_keys(prompt[:nfull * bs], bs, self.weights_version)
        return ins_keys[:(prompt.size - 1) // bs], ins_keys

    def _chain_keys_for(self, rid: Optional[int], prompt: np.ndarray):
        """:meth:`_cache_chain_keys` memoized per request: a queue head
        waiting for blocks re-walks every step."""
        memo = self._chain_memo
        if rid is not None and memo is not None and memo[0] == rid:
            return memo[1], memo[2]
        walk, ins = self._cache_chain_keys(prompt)
        if rid is not None:
            self._chain_memo = (rid, walk, ins)
        return walk, ins

    def _alloc_block(self) -> int:
        """One free block id, reclaiming the coldest parked cache entry
        when the free list is dry (callers checked availability)."""
        if not self._free_block_ids:
            self._kv_cache.evict_lru()       # on_evict refills the list
        return self._free_block_ids.popleft()

    def _insert_full_blocks(self, slot: int, prompt: np.ndarray,
                            skip: int, rid: int) -> None:
        """Register the slot's freshly prefilled full blocks
        (``skip..nfull``) in the pooled cache: each absent key's block
        moves from the slot's private list to its shared list, referenced
        by the slot from birth."""
        cache, bs = self._kv_cache, self._kv_cache_bs
        nfull = prompt.size // bs
        if nfull <= skip:
            return
        _, ins_keys = self._chain_keys_for(rid, prompt)
        for i in range(skip, nfull):
            if cache.get(ins_keys[i]) is not None:
                continue           # an equal entry exists: keep ours private
            bid = int(self._tables[slot, i])
            entry = cache.insert(ins_keys[i], bid, (i + 1) * bs,
                                 acquire=True)
            self._slot_blocks[slot].remove(bid)
            self._slot_cached[slot].append(entry)

    def _host_cache_payloads(self, row: Dict, indices) -> List[Dict]:
        """Host copies of blocks ``indices`` of a device row: one
        device-to-host transfer per layer cache tensor (k, v and, under
        the int8 cache, their scales), sliced per block."""
        if not indices:
            return []
        bs = self._kv_cache_bs
        host = {name: {part: t[0].cpu() for part, t in lc.items()}
                for name, lc in row.items()}
        return [{name: {part: t[:, i * bs:(i + 1) * bs].clone()
                        for part, t in parts.items()}
                 for name, parts in host.items()}
                for i in indices]

    def _host_cache_row(self, hits) -> Dict:
        """A device row whose positions ``[0, len(hits)*bs)`` are the
        cached host blocks: the host-mode hit's one copy."""
        row = self._fresh_row()
        n = len(hits) * self._kv_cache_bs
        for name, lc in row.items():
            for part, t in lc.items():
                t[0, :, :n] = torch.cat(
                    [e.payload[name][part] for e in hits], dim=1).to(
                        t.device, t.dtype)
        return row

    def _host_cache_prefill(self, rid: int, prompt: np.ndarray):
        """Contiguous admission with the host block cache: the longest
        cached chain (or a longer registered prefix) supplies the head,
        the remainder prefills, and the new full blocks insert. Returns
        (last-position logits ``(vocab,)``, row)."""
        cache, bs = self._kv_cache, self._kv_cache_bs
        walk_keys, ins_keys = self._chain_keys_for(rid, prompt)
        hits = cache.match_chain(walk_keys)
        j = len(hits)
        entry = self._match_prefix(prompt)
        reg_len = 0 if entry is None else int(entry[0].size)
        if reg_len > j * bs:
            # the pinned row covers more: the registered-prefix path
            self._prefix_hits += 1
            self._prefix_tokens += reg_len
            logits, row = self._prefill_with_prefixes(prompt, entry)
            j = 0
        elif j > 0:
            for e in hits:
                cache.touch(e)
            self._prefix_tokens += j * bs
            cache.record_walk(j, True)
            logits, row = self._extend(self._host_cache_row(hits), prompt[
                j * bs:], j * bs)
        else:
            cache.record_walk(0, bool(walk_keys))
            logits, row = self._prefill_with_prefixes(prompt, None)
        missing = [i for i in range(j, len(ins_keys))
                   if cache.get(ins_keys[i]) is None]
        for i, payload in zip(missing, self._host_cache_payloads(row,
                                                                 missing)):
            cache.insert(ins_keys[i], payload, (i + 1) * bs)
        return logits, row

    # ----------------------------------------------------------- submit
    def check_admissible(self, prompt_size: int, max_new_tokens: int,
                         prompt: Optional[np.ndarray] = None) -> None:
        """Raise ``ValueError`` for a request that could never run: it
        exceeds ``max_len`` (plus the speculative verify slack), needs
        more blocks than the pool can ever give it (pinned prefix blocks
        never free, except the ones the prompt itself reuses), or its
        prompt alone exceeds ``max_queued_tokens``."""
        slack = self._slack
        if prompt_size + max_new_tokens + slack > self.max_len:
            raise ValueError(f"prompt ({prompt_size}) + max_new_tokens "
                             f"({max_new_tokens})"
                             + (f" + gamma ({slack})" if slack else "")
                             + f" exceeds max_len {self.max_len}")
        if self.paged is not None:
            # verify writes land up to gamma positions past the budgeted
            # output: the slot's table owns those blocks too
            needed = -(-(prompt_size + max_new_tokens + slack)
                       // self.paged[1])
            allocatable = self.paged[0] - 1      # block 0 never allocates
            if self._kv_cache is not None:
                pinned = self._kv_cache.pinned_count()
                if pinned and prompt is not None:
                    walk_keys, _ = self._cache_chain_keys(prompt)
                    for e in self._kv_cache.match_chain(walk_keys):
                        if not e.pinned:
                            break
                        needed -= 1
                allocatable -= pinned
            if needed > allocatable:
                raise ValueError(f"request needs {needed} blocks but the "
                                 f"pool only has {allocatable} allocatable "
                                 "— it could never be admitted")
        if (self.max_queued_tokens is not None
                and prompt_size > self.max_queued_tokens):
            raise ValueError(f"prompt of {prompt_size} tokens exceeds "
                             f"max_queued_tokens={self.max_queued_tokens} "
                             "— it could never be admitted")

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None, admit: bool = True,
               **later) -> int:
        """Queue a request and return its id. ``temperature``/``top_k``/
        ``top_p`` override the engine defaults for this request.
        ``admit=False`` defers admission (and its prefill) to the next
        :meth:`step`: the HTTP server submits so, never prefilling while
        it holds its lock. Raises :class:`QueueFullError` when
        ``max_queue`` or ``max_queued_tokens`` would be exceeded. The
        JAX engine's ``deadline_ms``, ``tenant``, ``priority``, ``seed``,
        ``resume_from`` and ``session`` raise ``NotImplementedError``."""
        for name in later:
            if name not in _LATER_SUBMIT_ARGS:
                raise TypeError(f"submit() got an unexpected keyword "
                                f"argument {name!r}")
            raise _not_ported(f"per-request {name}", _LATER_SUBMIT_ARGS[name])
        validate_sampling_overrides(temperature, top_k, top_p)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.check_admissible(int(prompt.size), int(max_new_tokens),
                              prompt=prompt)
        if fault_site("serving.submit"):
            self._shed += 1
            raise QueueFullError("admission rejected (injected shed)",
                                 self._retry_after_ms())
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._shed += 1
            raise QueueFullError(
                f"queue full: {len(self._queue)} requests backlogged "
                f"(max_queue={self.max_queue})", self._retry_after_ms())
        if (self.max_queued_tokens is not None
                and self._queued_tokens + prompt.size
                > self.max_queued_tokens):
            self._shed += 1
            raise QueueFullError(
                f"queue full: {self._queued_tokens} prompt tokens "
                f"backlogged + {prompt.size} would exceed "
                f"max_queued_tokens={self.max_queued_tokens}",
                self._retry_after_ms())
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.monotonic()
        self._queue.append((
            rid, prompt, int(max_new_tokens),
            self.temperature if temperature is None else float(temperature),
            0 if top_k is None else int(top_k),
            1.0 if top_p is None else float(top_p)))
        self._queued_tokens += int(prompt.size)
        if admit:
            self._admit()
        return rid

    def _retry_after_ms(self) -> int:
        """Roughly how long until the backlog drains enough to retry:
        the median recent request latency scaled by the queue depth over
        the slot count, clamped to [50, 10000] ms (100 ms before any
        request finished)."""
        if self._latency_window:
            med = float(np.quantile([t for _, t, _ in self._latency_window],
                                    0.5))
            est = 1000.0 * med * max(1, len(self._queue)) / self.max_slots
        else:
            est = 100.0
        return int(min(10000.0, max(50.0, est)))

    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue, or free its slot and
        discard its partial output. Returns whether anything was
        cancelled (False for unknown or finished ids)."""
        for item in self._queue:
            if item[0] == rid:
                self._queue.remove(item)
                self._queued_tokens -= int(item[1].size)
                self._submit_t.pop(rid, None)
                return True
        for slot, st in list(self._pending_prefill.items()):
            if st["item"][0] == rid:
                self._abort_pending_prefill(slot)
                self._submit_t.pop(rid, None)
                self._admit_t.pop(rid, None)
                return True
        for slot, r in enumerate(self._rid):
            if r is not None and r == rid:
                self._outputs.pop(rid, None)
                self._fresh.pop(rid, None)
                self._accept.pop(rid, None)
                self._rid[slot] = None
                self._release_blocks(slot)
                self._submit_t.pop(rid, None)
                self._admit_t.pop(rid, None)
                return True
        return False

    # -------------------------------------------------------- admission
    def _free_slots(self) -> List[int]:
        # a slot mid-interleaved-prefill is reserved, not free
        return [s for s in range(self.max_slots)
                if self._rid[s] is None and s not in self._pending_prefill]

    def _allocate(self, slot: int, rid: int, prompt: np.ndarray,
                  max_new: int) -> bool:
        """Give ``slot`` the blocks for ``prompt`` plus its budget: the
        cached chain's blocks become the head of its table (claimed
        first, so the allocation below cannot reclaim them), private
        blocks the rest. False when the pool is momentarily short: the
        FIFO head then waits (no overtaking, so no starvation)."""
        bsz = self.paged[1]
        needed = -(-(prompt.size + max_new + self._slack) // bsz)
        hits = []
        if self._kv_cache is not None:
            walk_keys, _ = self._chain_keys_for(rid, prompt)
            hits = self._kv_cache.match_chain(walk_keys)
            reg = self._match_prefix(prompt) if hits else None
            # a registered row that covers more than the chain wins, when
            # a full private allocation is permanently satisfiable
            if (reg is not None and int(reg[0].size) > len(hits) * bsz
                    and needed <= self.paged[0] - 1
                    - self._kv_cache.pinned_count()):
                hits = []
        avail = len(self._free_block_ids)
        if self._kv_cache is not None:
            avail += (self._kv_cache.reclaimable_count()
                      - sum(1 for e in hits if self._kv_cache.is_parked(e)))
        if avail < needed - len(hits):
            return False
        for e in hits:
            self._kv_cache.acquire(e)
        self._slot_cached[slot] = list(hits)
        blocks = [self._alloc_block() for _ in range(needed - len(hits))]
        self._slot_blocks[slot] = blocks
        self._tables[slot, :] = 0              # unused entries -> scratch
        self._tables[slot, :needed] = [e.payload for e in hits] + blocks
        return True

    def _admit(self):
        while self._queue:
            slots = self._free_slots()
            if not slots:
                return
            slot = slots[0]
            rid, prompt, max_new, temp, topk, topp = self._queue[0]
            if (self.paged is not None
                    and not self._allocate(slot, rid, prompt, max_new)):
                return
            item = self._queue.popleft()
            self._queued_tokens -= int(prompt.size)
            self._admit_t[rid] = time.monotonic()
            if self._interleave_ok(slot, prompt):
                # the slot is reserved (blocks allocated, hit chain
                # claimed); its prompt feeds between the coming decode
                # steps and _finish_interleaved_prefill admits it
                self._begin_interleaved_prefill(slot, item)
                continue
            t0 = self._admit_prefill(rid, slot, prompt, temp, topk, topp)
            self._activate(slot, item, t0)

    def _activate(self, slot: int, item, t0: int) -> None:
        """The slot starts decoding ``item``'s request from its first
        token ``t0``."""
        rid, prompt, max_new, temp, topk, topp = item
        self._rid[slot] = rid
        self._outputs[rid] = []
        self._pos[slot] = prompt.size - 1
        self._last[slot] = t0
        self._budget[slot] = max_new
        self._temp[slot] = temp
        self._topk[slot] = topk
        self._topp[slot] = topp
        if self._record(slot, t0):
            self._fresh.setdefault(rid, []).append(t0)

    @staticmethod
    def _install(cache: Dict, slot: int, row: Dict) -> None:
        """Copy a batch-1 row into ``slot`` of a contiguous cache (the
        target's or the draft's)."""
        for name, lc in cache.items():
            for part, t in lc.items():
                t[slot].copy_(row[name][part][0])

    def _install_draft_row(self, slot: int, prompt: np.ndarray,
                           entry=...) -> None:
        """Prefill the draft's KV for ``prompt`` into the slot's row of
        the contiguous draft cache: every admission path runs it, since
        the prefix cache serves the target's KV only. A registered
        prefix's draft row still serves as the head (``entry`` is the
        ``_match_prefix`` result; ``...`` looks it up here)."""
        if self.draft_config is None:
            return
        if entry is ...:
            entry = self._match_prefix(prompt)
        _, d_row = self._prefill_with_prefixes(prompt, entry, draft=True)
        self._install(self.draft_cache, slot, d_row)

    def _admit_prefill(self, rid: int, slot: int, prompt: np.ndarray,
                       temp: float, topk: int, topp: float) -> int:
        """Prefix-aware prefill, the slot's install, and the first
        token."""
        if self._kv_cache is not None:
            if self.paged is not None:
                logits = self._admit_prefill_paged_cached(rid, slot, prompt)
            else:
                logits, row = self._host_cache_prefill(rid, prompt)
                self._install(self.cache, slot, row)
            self._install_draft_row(slot, prompt)
        else:
            entry = self._match_prefix(prompt)
            if entry is not None:
                self._prefix_hits += 1
                self._prefix_tokens += int(entry[0].size)
            logits, row = self._prefill_with_prefixes(prompt, entry)
            if self.paged is not None:
                install_row_paged(self.pool, row, self._tables[slot],
                                  -(-prompt.size // self.paged[1]))
            else:
                self._install(self.cache, slot, row)
            self._install_draft_row(slot, prompt, entry)
        return self._sample_first(logits, temp, topk, topp)

    def _sample_first(self, logits: torch.Tensor, temp: float, topk: int,
                      topp: float) -> int:
        """The admission-time first token from final-position logits
        ``(vocab,)``."""
        return int(self._sample(logits[None],
                                np.asarray([temp], np.float32),
                                np.asarray([topk], np.int32),
                                np.asarray([topp], np.float32))[0])

    def _admit_prefill_paged_cached(self, rid: int, slot: int,
                                    prompt: np.ndarray) -> torch.Tensor:
        """Paged admission with the block cache: the claimed hit chain
        (already the head of the slot's table) is gathered into a row
        head, only the remainder prefills and installs, and the new full
        blocks register. Returns the last position's logits."""
        bs = self._kv_cache_bs
        j = len(self._slot_cached[slot])
        walk_keys, _ = self._chain_keys_for(rid, prompt)
        if j > 0:
            self._prefix_tokens += j * bs
            self._kv_cache.record_walk(j, True)
            row = gather_blocks_to_row(
                self.pool, [int(b) for b in self._tables[slot, :j]],
                self.max_len)
            logits, row = self._extend(row, prompt[j * bs:], j * bs)
        else:
            entry = self._match_prefix(prompt)
            if entry is not None:
                self._prefix_hits += 1
                self._prefix_tokens += int(entry[0].size)
            elif walk_keys:
                self._kv_cache.record_walk(0, True)
            logits, row = self._prefill_with_prefixes(prompt, entry)
        # only the remainder blocks: the shared head already holds its
        # positions and other slots may be reading it
        install_row_paged(self.pool, row, self._tables[slot],
                          -(-prompt.size // bs), start=j)
        self._insert_full_blocks(slot, prompt, j, rid)
        return logits

    # --------------------------------------------------------- sampling
    def _sample_dev(self, logits: torch.Tensor, temps: np.ndarray,
                    topk: np.ndarray, topp: np.ndarray) -> torch.Tensor:
        """Per-row tokens from ``(B, V)`` f32 logits, on the device:
        argmax where the temperature is 0, else a draw from the engine's
        generator after temperature scaling and the row's top-k / top-p
        filters."""
        greedy = torch.argmax(logits, dim=-1)
        sampled_rows = temps > 0
        if not sampled_rows.any():
            return greedy
        dev = logits.device
        t = torch.as_tensor(temps, device=dev)
        filt = logits / torch.clamp(t, min=1e-6)[:, None]
        if (((topk > 0) | (topp < 1.0)) & sampled_rows).any():
            filt = _filter_logits_rows(filt, torch.as_tensor(topk,
                                                             device=dev),
                                       torch.as_tensor(topp, device=dev))
        probs = torch.softmax(filt, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topk: np.ndarray, topp: np.ndarray) -> np.ndarray:
        return self._sample_dev(logits, temps, topk, topp).cpu().numpy()

    def _decode_tokens(self, pos: np.ndarray,
                       active: np.ndarray) -> np.ndarray:
        """``steps_per_sync`` decode steps issued back to back from the
        slots' pending tokens at ``pos``, each step's tokens feeding the
        next on the device; one device-to-host read of the ``(slots,
        steps_per_sync)`` tokens at the end. Inactive slots decode
        garbage at position 0 onwards (static batch shape) into their
        free row, or into the scratch block through their zero table. A
        slot that retires mid-chunk runs on past its budget; its
        positions are clamped to ``max_len - 1`` (its tokens are dropped
        on the host and its row is rewritten at the next admission)."""
        dev, cfg = self.device, self.config
        temps = np.where(active, self._temp, 0.0).astype(np.float32)
        last = torch.as_tensor(self._last, device=dev).long()
        pos_t = torch.as_tensor(pos, device=dev).long()
        if self.paged is not None:
            tables = torch.as_tensor(self._tables, device=dev)
        toks = []
        for i in range(self.steps_per_sync):
            p = pos_t + i
            if i:
                p = torch.clamp(p, max=self.max_len - 1)
            if self.paged is not None:
                logits, self.pool = decode_step_paged(
                    self.params, self.pool, tables, last, p, cfg,
                    kernel=self.kernel)
            else:
                logits, self.cache = decode_step(self.params, self.cache,
                                                 last, p, cfg)
            last = self._sample_dev(logits, temps, self._topk, self._topp)
            toks.append(last)
        return torch.stack(toks, dim=1).cpu().numpy()

    def _spec_round(self, pos: np.ndarray, gamma: int):
        """One speculative round of every slot from its pending token at
        ``pos``, at depth ``gamma`` and the engine temperature; ``(emit
        (B, gamma + 1), a (B,), nxt (B,))`` on the host. Inactive slots
        verify garbage at position 0 into their free rows, or the
        scratch block through their zero tables."""
        dev = self.device
        last = torch.as_tensor(self._last, device=dev).long()
        pos_t = torch.as_tensor(pos, device=dev).long()
        temp = self.temperature
        greedy = not temp > 0
        if self.paged is not None:
            emit, a, nxt, self.pool, self.draft_cache, _ = (
                speculative_round_paged(
                    self.params, self.draft_params, self.pool,
                    torch.as_tensor(self._tables, device=dev),
                    self.draft_cache, last, pos_t, gamma, self.config,
                    self.draft_config, temp if temp > 0 else 1.0,
                    self._gen, greedy))
        else:
            emit, a, nxt, self.cache, self.draft_cache, _ = (
                speculative_round(
                    self.params, self.draft_params, self.cache,
                    self.draft_cache, last, pos_t, gamma, self.config,
                    self.draft_config, temp if temp > 0 else 1.0,
                    self._gen, greedy))
        return emit.cpu().numpy(), a.cpu().numpy(), nxt.cpu().numpy()

    def _steer_gamma(self, accepted: int, proposed: int) -> None:
        """One tick of the adaptive speculative depth: this round's
        pooled acceptance feeds an EWMA, and at most every
        ``GAMMA_ADJUST_EVERY`` rounds ``_gamma_now`` moves ONE step
        toward the depth that acceptance pays for (``1 + round(ewma *
        gamma)``, within ``[gamma_min, gamma]``). Greedy output is the
        same under any depth schedule."""
        if not proposed:
            return
        acc = accepted / proposed
        self._accept_ewma = (acc if self._accept_ewma is None else
                             GAMMA_EWMA_ALPHA * acc
                             + (1.0 - GAMMA_EWMA_ALPHA) * self._accept_ewma)
        self._rounds_since_adjust += 1
        if self._rounds_since_adjust < GAMMA_ADJUST_EVERY:
            return
        self._rounds_since_adjust = 0
        target = max(self.gamma_min,
                     min(self.gamma,
                         1 + int(self._accept_ewma * self.gamma + 0.5)))
        if target > self._gamma_now:
            self._gamma_now += 1
        elif target < self._gamma_now:
            self._gamma_now -= 1

    # ------------------------------------------------ interleaved prefill
    def _interleave_ok(self, slot: int, prompt: np.ndarray) -> bool:
        """Should this admission's chunks feed between decode steps?
        Only with decodes in flight (an idle engine prefills fastest
        run to completion) and more than one chunk of compute left after
        prefix or cache reuse; the contiguous host-cache path stays run
        to completion. Output tokens do not depend on the answer."""
        if (not self.interleave_prefill
                or not any(r is not None for r in self._rid)):
            return False
        if self._kv_cache is not None:
            if self.paged is None:
                return False
            est = len(self._slot_cached[slot]) * self._kv_cache_bs
        else:
            est = 0
        if est == 0:
            entry = self._match_prefix(prompt)
            est = 0 if entry is None else int(entry[0].size)
        return prompt.size - est > self.prefill_chunk

    def _begin_interleaved_prefill(self, slot: int, item) -> None:
        """The front half of admission without the chunk loop: claim
        whatever serves the prompt's head (the cache-hit chain or a
        registered prefix row) as the run-to-completion paths do, then
        park the admission for :meth:`_interleave_prefills`. The slot's
        table points at the scratch sink while pending: inactive slots'
        decode writes land on block 0, and this slot's real blocks (some
        shared through the cache) must not take them."""
        rid, prompt = item[0], item[1]
        reused, j, entry, row = 0, 0, None, None
        if self.paged is not None and self._kv_cache is not None:
            bs = self._kv_cache_bs
            j = len(self._slot_cached[slot])
            walk_keys, _ = self._chain_keys_for(rid, prompt)
            if j > 0:
                reused = j * bs
                self._prefix_tokens += reused
                self._kv_cache.record_walk(j, True)
                row = gather_blocks_to_row(
                    self.pool, [int(b) for b in self._tables[slot, :j]],
                    self.max_len)
            else:
                entry = self._match_prefix(prompt)
                if entry is None and walk_keys:
                    self._kv_cache.record_walk(0, True)
        else:
            entry = self._match_prefix(prompt)
        if entry is not None:
            self._prefix_hits += 1
            reused = int(entry[0].size)
            self._prefix_tokens += reused
        if row is None:
            # the registered row is copied: chunks write their row in place
            row = (self._fresh_row() if entry is None
                   else tree_map(torch.clone, entry[2]))
        self._pending_prefill[slot] = dict(
            item=item, row=row, suffix=prompt[reused:], cursor=0,
            reused=reused, j=j, entry=entry, logits=None,
            table=(self._tables[slot].copy()
                   if self.paged is not None else None))
        if self.paged is not None:
            self._tables[slot, :] = 0

    def _interleave_prefills(self) -> None:
        """Feed one ``prefill_chunk`` chunk of the oldest pending
        admission (the JAX engine's budget without a loop profiler), and
        admit it if that was its last."""
        slot = next(iter(self._pending_prefill))
        if self._feed_prefill_chunk(slot):
            self._finish_interleaved_prefill(slot)

    def _feed_prefill_chunk(self, slot: int) -> bool:
        """Feed ONE chunk of the pending prompt, at the chunk boundaries
        of the run-to-completion path (:meth:`_extend`), so both compute
        the same logits. Returns whether the suffix is exhausted."""
        st = self._pending_prefill[slot]
        suffix, cur = st["suffix"], st["cursor"]
        blk = suffix[cur:cur + self.prefill_chunk]
        logits, st["row"] = decode_block(
            self.params, st["row"],
            torch.as_tensor(blk[None], device=self.device),
            st["reused"] + cur, self.config)
        st["logits"] = logits[0, -1]
        st["cursor"] = cur + int(blk.size)
        self._interleaved += 1
        return st["cursor"] >= suffix.size

    def _finish_interleaved_prefill(self, slot: int) -> None:
        """The back half of admission once every chunk has fed: install
        the row (the remainder blocks only, past a shared head), register
        the new full blocks, prefill the draft, sample the first token
        and start the slot."""
        st = self._pending_prefill.pop(slot)
        item = st["item"]
        rid, prompt, _, temp, topk, topp = item
        if self.paged is not None:
            self._tables[slot] = st["table"]
            install_row_paged(self.pool, st["row"], self._tables[slot],
                              -(-prompt.size // self.paged[1]),
                              start=st["j"])
            if self._kv_cache is not None:
                self._insert_full_blocks(slot, prompt, st["j"], rid)
                self._install_draft_row(slot, prompt)
            else:
                self._install_draft_row(slot, prompt, st["entry"])
        else:
            self._install(self.cache, slot, st["row"])
            self._install_draft_row(slot, prompt, st["entry"])
        self._activate(slot, item,
                       self._sample_first(st["logits"], temp, topk, topp))

    def _abort_pending_prefill(self, slot: int) -> None:
        """Drop a pending interleaved prefill: the slot's table comes
        back so its private blocks free and its claimed chain releases,
        as an active slot's teardown does."""
        st = self._pending_prefill.pop(slot)
        if self.paged is not None:
            self._tables[slot] = st["table"]
        self._release_blocks(slot)

    def stage_draft_params(self, draft_params: Dict, version: int,
                           trace_id: Optional[str] = None) -> None:
        """Live draft weight staging belongs to the weight plane."""
        raise _not_ported("live draft weight staging (stage_draft_params)",
                          6)

    # ------------------------------------------------------- retirement
    def _record(self, slot: int, tok: int) -> bool:
        """Book one emitted token; retire the request on eos or an
        exhausted budget. Returns whether the token is part of the
        output (eos is not)."""
        rid = self._rid[slot]
        if self.eos_id is not None and tok == self.eos_id:
            self._retire_slot(slot)
            return False
        self._outputs[rid].append(tok)
        self._emitted += 1
        self._budget[slot] -= 1
        if self._budget[slot] <= 0:
            self._retire_slot(slot)
        return True

    def _release_blocks(self, slot: int):
        if self.paged is None:
            return
        self._free_block_ids.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        # shared cached blocks: the last release parks the entry on the
        # LRU reclaim list, its KV resident for future hits
        for entry in self._slot_cached[slot]:
            self._kv_cache.release(entry)
        self._slot_cached[slot] = []
        self._tables[slot, :] = 0              # back to the scratch sink

    def _retire_slot(self, slot: int) -> int:
        rid = self._rid[slot]
        self._done[rid] = self._outputs.pop(rid)
        self._rid[slot] = None
        self._release_blocks(slot)
        self._finished += 1
        now = time.monotonic()
        t_sub = self._submit_t.pop(rid, None)
        t_adm = self._admit_t.pop(rid, now)
        if t_sub is not None:
            self._latency_window.append((t_adm - t_sub, now - t_sub,
                                         len(self._done[rid])))
        return rid

    # ------------------------------------------------------------- step
    @property
    def pending(self) -> int:
        """Requests queued or in flight, plus emitted tokens not yet
        surfaced by :meth:`step`."""
        return (len(self._queue) + sum(r is not None for r in self._rid)
                + len(self._pending_prefill) + len(self._fresh))

    def step(self) -> Dict[int, List[int]]:
        """Advance every active slot by ``steps_per_sync`` tokens, or by
        ``1 + accepted`` in speculative mode (fewer for a slot that
        finishes); returns ``{request_id: [tokens]}`` emitted since the
        last call (admission-time first tokens included). Finished
        requests retire and queued ones join between steps; a pending
        interleaved prefill gets its chunk before the decode."""
        fault_site("serving.step")
        self._admit()
        if self._pending_prefill:
            # before reading _fresh: an admission completing here
            # surfaces its first token in this very step
            self._interleave_prefills()
        emitted = {rid: list(toks) for rid, toks in self._fresh.items()}
        self._fresh = {}
        active = np.asarray([r is not None for r in self._rid])
        if not active.any():
            return emitted
        pos = np.where(active, self._pos + 1, 0).astype(np.int32)
        self._steps += 1
        if self.draft_config is not None:
            self._spec_step(pos, active, emitted)
            self._admit()
            return emitted
        toks = self._decode_tokens(pos, active)                 # (B, K)
        for slot in np.nonzero(active)[0]:
            rid = self._rid[slot]
            for tok in toks[slot]:
                if self._rid[slot] is None:
                    break       # retired mid-chunk: the surplus is dropped
                self._pos[slot] += 1
                self._last[slot] = tok
                if self._record(slot, int(tok)):
                    emitted.setdefault(rid, []).append(int(tok))
        self._admit()
        return emitted

    def _spec_step(self, pos: np.ndarray, active: np.ndarray,
                   emitted: Dict[int, List[int]]) -> None:
        """One speculative round: every active slot emits its accepted
        draft prefix and the target's token, at the operating depth
        (verify slack was budgeted at the ceiling, so any depth fits)."""
        g_now = self._gamma_now
        emit, acc, nxt = self._spec_round(pos, g_now)
        n_active = int(active.sum())
        n_accepted = int(acc[active].sum())
        self._accepted += n_accepted
        self._proposed += g_now * n_active
        self._spec_rounds += n_active
        if self.adaptive_gamma:
            self._steer_gamma(n_accepted, g_now * n_active)
        for slot in np.nonzero(active)[0]:
            rid = self._rid[slot]
            a_p = self._accept.setdefault(rid, [0, 0])
            a_p[0] += int(acc[slot])
            a_p[1] += g_now
            self._pos[slot] += 1 + acc[slot]
            self._last[slot] = nxt[slot]
            for tok in emit[slot, :acc[slot] + 1]:
                if self._rid[slot] is None:
                    break       # retired mid-round (eos or budget)
                if self._record(slot, int(tok)):
                    emitted.setdefault(rid, []).append(int(tok))

    def run(self, requests: Sequence[Sequence[int]],
            max_new_tokens: int) -> List[List[int]]:
        """Submit every request, step until drained, return outputs in
        request order."""
        rids = [self.submit(p, max_new_tokens) for p in requests]
        while self.pending:
            self.step()
        return [self.result(r) for r in rids]

    def result(self, rid: int) -> Optional[List[int]]:
        """Finished output for ``rid`` (None while in flight). Pops the
        entry: call once per request."""
        info = self.result_info(rid)
        return None if info is None else info["tokens"]

    def result_info(self, rid: int) -> Optional[Dict]:
        """Like :meth:`result`, as the JAX engine's outcome dict
        ``{"tokens", "timeout", "expired"}`` (both flags False: deadlines
        are not ported); a speculative engine adds the request's own
        ``draft_accepted`` and ``draft_proposed`` (the JAX engine's
        terminal trace event carries them)."""
        if rid not in self._done:
            return None
        out = {"tokens": self._done.pop(rid), "timeout": False,
               "expired": False}
        a_p = self._accept.pop(rid, None)
        if a_p is not None:
            out.update(draft_accepted=a_p[0], draft_proposed=a_p[1])
        return out

    @property
    def stats(self) -> Dict:
        """Counters since construction: steps (device round trips),
        tokens, finished and shed requests, the queue, the prefix and
        block-cache reuse, the pool, request latency over the recent
        window, in speculative mode the draft acceptance (accepted over
        proposed, active slots only), slot-rounds and the operating and
        ceiling gamma, the interleaved prefill chunks, the paged kernel
        and its launches by this engine."""
        steps = self._steps
        out = {"steps": steps,
               "tokens_emitted": self._emitted,
               "requests_finished": self._finished,
               "tokens_per_step": self._emitted / steps if steps else 0.0,
               "requests_shed": self._shed,
               "queue_depth": len(self._queue),
               "queued_tokens": self._queued_tokens}
        if self._prefixes or self._kv_cache is not None:
            out["prefix_hits"] = self._prefix_hits
            out["prefix_tokens_reused"] = self._prefix_tokens
        if self.paged is not None:
            out["blocks_total"] = self.paged[0] - 1
            free = len(self._free_block_ids)
            if self._kv_cache is not None:
                free += self._kv_cache.reclaimable_count()
            out["blocks_free"] = free
        if self._kv_cache is not None:
            out["kv_cache"] = {**self._kv_cache.stats(),
                               "block_size": self._kv_cache_bs}
        if self._latency_window:
            totals = [t for _, t, _ in self._latency_window]
            waits = [w for w, _, _ in self._latency_window]
            out["latency_p50_s"] = float(np.quantile(totals, 0.5))
            out["latency_p99_s"] = float(np.quantile(totals, 0.99))
            out["queue_wait_mean_s"] = sum(waits) / len(waits)
        if self.draft_config is not None:
            # None before any proposal: an idle engine does not read as
            # a zero-acceptance (stale) draft
            out["draft_acceptance"] = (self._accepted / self._proposed
                                       if self._proposed else None)
            out["speculative_rounds"] = self._spec_rounds
            out["draft_weights_version"] = 0
            out["gamma"] = self._gamma_now
            out["gamma_ceiling"] = self.gamma
        if self.interleave_prefill:
            out["prefill_chunks_interleaved"] = self._interleaved
            out["pending_prefills"] = len(self._pending_prefill)
        out.update(kernel=self.kernel,
                   kernel_launches=(paged_decode_attention.launches
                                    - self._launch_base),
                   device=str(self.device))
        return out
