"""Continuous-batching decode engine over the paged KV pool.

The counterpart of ``elephas_tpu/serving_engine.py`` ``DecodeEngine``,
its paged core: a fixed device batch of ``max_slots`` decode slots,
each at its own sequence position, over one shared block pool. Requests
queue FIFO; a request is admitted when a slot is free and the pool holds
enough blocks for its prompt plus its whole token budget. Admission
prefills the whole prompt (:func:`~elephas_tpu_torch.models.transformer.
prefill_cache`), scatters the row into the slot's blocks
(:func:`~elephas_tpu_torch.models.paged_decode.install_row_paged`) and
samples the first token; each :meth:`DecodeEngine.step` then advances
every active slot by one token through
:func:`~elephas_tpu_torch.models.paged_decode.decode_step_paged`.
Retirement (eos or budget) returns the slot's blocks to the free list.

``kernel="fused"`` runs the paged decode attention as the hand-written
CUDA kernel. There is no fallback: on a CUDA device the kernel launches
or the step raises.

Not ported yet: the contiguous cache, the prefix cache, speculative
decoding, ``steps_per_sync``, chunked and interleaved prefill, QoS,
spill and sessions, deadlines and cancel, per-request seeds, and the
metrics, profiler and flight recorder.
"""
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.paged_decode import (KERNELS, decode_step_paged,
                                  init_paged_pool, install_row_paged,
                                  validate_paged_config)
from .models.transformer import NEG_INF, TransformerConfig, prefill_cache
from .ops.paged_attention import paged_decode_attention
from .weights import tree_map

__all__ = ["DecodeEngine", "validate_sampling_overrides"]


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


class DecodeEngine:
    """Slot-based continuous batching over the paged block pool.

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
    :param paged: ``(num_blocks, block_size)`` of the shared block pool
        (required: the contiguous cache is not ported)
    :param kernel: paged decode attention: ``"gather"`` (materialize
        each row's blocks) or ``"fused"`` (the CUDA kernel reading the
        pool directly; its plain version on the CPU)
    :param device: where the engine runs; ``None`` means the CUDA device
        and raises without one
    """

    def __init__(self, params: Dict, config: TransformerConfig,
                 max_slots: int = 8, max_len: Optional[int] = None,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, paged: Optional[Tuple[int, int]] = None,
                 kernel: str = "gather", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or config.max_seq_len)
        if self.max_len > config.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds "
                             f"config.max_seq_len {config.max_seq_len}")
        self.temperature = float(temperature)
        self.eos_id = eos_id
        if paged is None:
            raise NotImplementedError(
                "the contiguous cache is not ported yet; pass "
                "paged=(num_blocks, block_size)")
        validate_paged_config(config)
        num_blocks, block_size = int(paged[0]), int(paged[1])
        if block_size < 1 or num_blocks < 2:
            raise ValueError("paged needs block_size >= 1 and "
                             "num_blocks >= 2 (block 0 is the reserved "
                             "scratch sink)")
        self.paged = (num_blocks, block_size)
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                             f"{KERNELS}")
        self.kernel = kernel
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device), params)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        # per-slot table width: enough blocks to cover max_len
        self._mb = -(-self.max_len // block_size)
        self.pool = init_paged_pool(config, num_blocks, block_size,
                                    self.device)
        self._tables = np.zeros((self.max_slots, self._mb), np.int32)
        self._free_block_ids = deque(range(1, num_blocks))  # 0 = scratch
        self._slot_blocks: List[List[int]] = [[] for _ in
                                              range(self.max_slots)]
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
        self._outputs: Dict[int, List[int]] = {}
        self._done: Dict[int, List[int]] = {}
        # rid -> [token]: admission-time first tokens awaiting step()
        self._fresh: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._steps = 0
        self._emitted = 0
        self._finished = 0
        self._launch_base = paged_decode_attention.launches

    # ----------------------------------------------------------- submit
    def check_admissible(self, prompt_size: int,
                         max_new_tokens: int) -> None:
        """Raise ``ValueError`` for a request that could never run: it
        exceeds ``max_len`` or needs more blocks than the pool has."""
        if prompt_size + max_new_tokens > self.max_len:
            raise ValueError(f"prompt ({prompt_size}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_len "
                             f"{self.max_len}")
        needed = -(-(prompt_size + max_new_tokens) // self.paged[1])
        allocatable = self.paged[0] - 1          # block 0 never allocates
        if needed > allocatable:
            raise ValueError(f"request needs {needed} blocks but the pool "
                             f"only has {allocatable} allocatable — it "
                             "could never be admitted")

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> int:
        """Queue a request and return its id; admission happens now if a
        slot and the blocks are free, else on a later :meth:`step`.
        ``temperature``/``top_k``/``top_p`` override the engine defaults
        for this request."""
        validate_sampling_overrides(temperature, top_k, top_p)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.check_admissible(int(prompt.size), int(max_new_tokens))
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((
            rid, prompt, int(max_new_tokens),
            self.temperature if temperature is None else float(temperature),
            0 if top_k is None else int(top_k),
            1.0 if top_p is None else float(top_p)))
        self._admit()
        return rid

    # -------------------------------------------------------- admission
    def _free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if self._rid[s] is None]

    def _admit(self):
        while self._queue:
            slots = self._free_slots()
            if not slots:
                return
            slot = slots[0]
            rid, prompt, max_new, temp, topk, topp = self._queue[0]
            bsz = self.paged[1]
            needed = -(-(prompt.size + max_new) // bsz)
            if len(self._free_block_ids) < needed:
                # the pool is momentarily short: the FIFO head waits (no
                # overtaking, so no starvation)
                return
            blocks = [self._free_block_ids.popleft() for _ in range(needed)]
            self._slot_blocks[slot] = blocks
            self._tables[slot, :] = 0          # unused entries -> scratch
            self._tables[slot, :needed] = blocks
            self._queue.popleft()
            t0 = self._admit_prefill(slot, prompt, temp, topk, topp)
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

    def _admit_prefill(self, slot: int, prompt: np.ndarray, temp: float,
                       topk: int, topp: float) -> int:
        """Whole-prompt prefill, install into the slot's blocks, and the
        first token."""
        tokens = torch.as_tensor(prompt[None], device=self.device)
        logits, row_cache = prefill_cache(self.params, tokens, self.config,
                                          self.max_len)
        nprefill = -(-prompt.size // self.paged[1])
        install_row_paged(self.pool, row_cache, self._tables[slot], nprefill)
        return int(self._sample(logits, np.asarray([temp], np.float32),
                                np.asarray([topk], np.int32),
                                np.asarray([topp], np.float32))[0])

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topk: np.ndarray, topp: np.ndarray) -> np.ndarray:
        """Per-row tokens from ``(B, V)`` f32 logits: argmax where the
        temperature is 0, else a draw from the engine's generator after
        temperature scaling and the row's top-k / top-p filters."""
        greedy = torch.argmax(logits, dim=-1)
        sampled_rows = temps > 0
        if not sampled_rows.any():
            return greedy.cpu().numpy()
        dev = logits.device
        t = torch.as_tensor(temps, device=dev)
        filt = logits / torch.clamp(t, min=1e-6)[:, None]
        if (((topk > 0) | (topp < 1.0)) & sampled_rows).any():
            filt = _filter_logits_rows(filt, torch.as_tensor(topk,
                                                             device=dev),
                                       torch.as_tensor(topp, device=dev))
        probs = torch.softmax(filt, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        tok = torch.where(t > 0, sampled, greedy)
        return tok.cpu().numpy()

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
        self._free_block_ids.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0              # back to the scratch sink

    def _retire_slot(self, slot: int) -> int:
        rid = self._rid[slot]
        self._done[rid] = self._outputs.pop(rid)
        self._rid[slot] = None
        self._release_blocks(slot)
        self._finished += 1
        return rid

    # ------------------------------------------------------------- step
    @property
    def pending(self) -> int:
        """Requests queued or in flight, plus emitted tokens not yet
        surfaced by :meth:`step`."""
        return (len(self._queue) + sum(r is not None for r in self._rid)
                + len(self._fresh))

    def step(self) -> Dict[int, List[int]]:
        """Advance every active slot by one token; returns ``{request_id:
        [tokens]}`` emitted since the last call (admission-time first
        tokens included). Finished requests retire and queued ones join
        between steps."""
        self._admit()
        emitted = {rid: list(toks) for rid, toks in self._fresh.items()}
        self._fresh = {}
        active = np.asarray([r is not None for r in self._rid])
        if not active.any():
            return emitted
        # inactive slots decode garbage at position 0 through the scratch
        # block (static batch shape)
        pos = np.where(active, self._pos + 1, 0).astype(np.int32)
        self._steps += 1
        dev = self.device
        logits, self.pool = decode_step_paged(
            self.params, self.pool, torch.as_tensor(self._tables, device=dev),
            torch.as_tensor(self._last, device=dev),
            torch.as_tensor(pos, device=dev), self.config,
            kernel=self.kernel)
        toks = self._sample(logits, np.where(active, self._temp, 0.0),
                            self._topk, self._topp)
        for slot in np.nonzero(active)[0]:
            rid = self._rid[slot]
            self._pos[slot] += 1
            self._last[slot] = toks[slot]
            if self._record(slot, int(toks[slot])):
                emitted.setdefault(rid, []).append(int(toks[slot]))
        self._admit()
        return emitted

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
        return self._done.pop(rid, None)

    @property
    def stats(self) -> Dict:
        """Counters since construction, the resolved paged kernel and
        the paged kernel's launches by this engine."""
        return {"steps": self._steps,
                "tokens_emitted": self._emitted,
                "requests_finished": self._finished,
                "tokens_per_step": (self._emitted / self._steps
                                    if self._steps else 0.0),
                "queue_depth": len(self._queue),
                "blocks_total": self.paged[0] - 1,
                "blocks_free": len(self._free_block_ids),
                "kernel": self.kernel,
                "kernel_launches": (paged_decode_attention.launches
                                    - self._launch_base),
                "device": str(self.device)}

