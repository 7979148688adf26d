"""Text utilities: dependency-free byte-level tokenization.

The reference framework has no text pipeline (its data layer is numeric
RDDs); the TPU framework's LM families need one. Byte-level tokenization
(the GPT-2/ByT5 fallback alphabet) is deterministic, reversible, needs
no trained vocabulary, and keeps the vocab MXU-tiny — the right default
for tests, examples, and smoke-scale training. Trained subword
tokenizers can be dropped in anywhere ``encode``-shaped callables are
accepted.

Copied into the port from ``elephas_tpu/utils/text.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
from typing import Iterable, List, Optional

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """UTF-8 byte tokenizer with pad/bos/eos specials.

    ids 0..255 are raw bytes; ``pad_id=256``, ``bos_id=257``,
    ``eos_id=258`` — ``vocab_size=259``.
    """

    pad_id = 256
    bos_id = 257
    eos_id = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Iterable[str], seq_len: int,
                     add_bos: bool = False, add_eos: bool = False,
                     dtype=np.int32) -> np.ndarray:
        """Encode to a dense ``(len(texts), seq_len)`` array — truncated
        or right-padded with ``pad_id``."""
        rows = []
        for text in texts:
            ids = self.encode(text, add_bos=add_bos, add_eos=add_eos)
            ids = ids[:seq_len]
            ids = ids + [self.pad_id] * (seq_len - len(ids))
            rows.append(ids)
        return np.asarray(rows, dtype=dtype)

    def pack_documents(self, texts: Iterable[str], seq_len: int,
                       dtype=np.int32):
        """Greedy document packing: concatenate eos-terminated documents
        into ``(n, seq_len)`` rows plus ``segment_ids`` (1-based per
        document within a row, 0 = padding) for segment-isolated
        attention (``lm_loss(..., segment_ids=...)``) — no cross-document
        leakage, minimal padding waste."""
        rows: List[List[int]] = [[]]
        segs: List[List[int]] = [[]]
        seg_counter = [0]

        for text in texts:
            ids = self.encode(text) + [self.eos_id]
            while ids:
                space = seq_len - len(rows[-1])
                if space == 0:
                    rows.append([])
                    segs.append([])
                    seg_counter[0] = 0
                    space = seq_len
                seg_counter[0] += 1
                take, ids = ids[:space], ids[space:]
                rows[-1].extend(take)
                segs[-1].extend([seg_counter[0]] * len(take))

        out_rows = np.full((len(rows), seq_len), self.pad_id, dtype=dtype)
        out_segs = np.zeros((len(rows), seq_len), dtype=dtype)
        for i, (r, g) in enumerate(zip(rows, segs)):
            out_rows[i, :len(r)] = r
            out_segs[i, :len(g)] = g
        return out_rows, out_segs

    def corpus_to_sequences(self, texts: Iterable[str], seq_len: int,
                            stride: Optional[int] = None,
                            dtype=np.int32) -> np.ndarray:
        """Concatenate documents (eos-separated) into one byte stream and
        window it into ``(n, seq_len)`` LM training rows."""
        stream: List[int] = []
        for text in texts:
            stream.extend(self.encode(text))
            stream.append(self.eos_id)
        step = stride or seq_len
        rows = [stream[i:i + seq_len]
                for i in range(0, max(len(stream) - seq_len + 1, 0), step)]
        if not rows:
            raise ValueError(
                f"corpus of {len(stream)} tokens shorter than "
                f"seq_len={seq_len}")
        return np.asarray(rows, dtype=dtype)
