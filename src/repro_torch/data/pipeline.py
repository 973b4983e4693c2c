"""Data pipeline: synthetic corpora, packing and host sharding (a numpy
copy of ``repro.data.pipeline``).

Two synthetic workload classes mirror the paper's datasets:
  * ``code``  — highly structured/repetitive token streams (HumanEval
                stand-in: high draft acceptance),
  * ``chat``  — higher-entropy streams (MT-bench stand-in: lower
                acceptance),
generated by tiny deterministic template grammars.  ``packed_batches``
yields fixed-shape {tokens, labels, mask} training batches;
``prompt_batch`` builds padded serving prompts.
"""
from __future__ import annotations

import hashlib
from typing import Iterator, List

import numpy as np

from repro_torch.data.tokenizer import EOS, PAD, ByteTokenizer

_CODE_TMPL = [
    "def f{i}(x):\n    return x + {j}\n",
    "for i in range({j}):\n    acc += arr[i] * {i}\n",
    "class C{i}:\n    def get(self):\n        return self.v{j}\n",
    "if x{i} > {j}:\n    y = x{i} - {j}\nelse:\n    y = {j}\n",
    "result = [t * {j} for t in range({i})]\n",
]

_CHAT_WORDS = (
    "the a of to and in that it is was for on are as with his they I at be "
    "this have from or had by word but what some we can out other were all "
    "there when up use your how said an each she which do their time if will "
    "way about many then them write would like so these her long make thing "
    "see him two has look more day could go come did number sound no most "
    "people my over know water than call first who may down side been now find"
).split()


def synthetic_text(kind: str, index: int, length: int = 400) -> str:
    seed = int.from_bytes(hashlib.sha256(f"{kind}:{index}".encode()).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    parts: List[str] = []
    total = 0
    while total < length:
        if kind == "code":
            t = _CODE_TMPL[rng.integers(len(_CODE_TMPL))]
            s = t.format(i=int(rng.integers(10)), j=int(rng.integers(10)))
        else:
            n = int(rng.integers(6, 14))
            s = " ".join(_CHAT_WORDS[rng.integers(len(_CHAT_WORDS))] for _ in range(n)) + ". "
        parts.append(s)
        total += len(s)
    return "".join(parts)[:length]


def token_stream(tok: ByteTokenizer, kind: str, seed: int = 0) -> Iterator[np.ndarray]:
    i = seed * 1_000_003
    while True:
        ids = tok.encode(synthetic_text(kind, i))
        yield np.concatenate([ids, [EOS]])
        i += 1


def packed_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    kind: str = "chat",
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
) -> Iterator[dict]:
    """Infinite iterator of packed {tokens, labels, mask} of (B, T), numpy.

    Documents are concatenated and chopped; each host takes a disjoint
    document substream (host sharding for multi-host input pipelines)."""
    tok = ByteTokenizer(vocab_size)
    stream = token_stream(tok, kind, seed=seed * num_hosts + host_id)
    buf = np.zeros((0,), np.int32)
    while True:
        need = batch * seq_len + 1
        while buf.size < need:
            buf = np.concatenate([buf, next(stream)])
        chunk, buf = buf[:need], buf[need - 1:]
        tokens = chunk[:-1].reshape(batch, seq_len)
        labels = chunk[1:].reshape(batch, seq_len)
        # loss mask: don't train on PAD (none here, but keep the contract)
        mask = (labels != PAD).astype(np.float32)
        yield {"tokens": tokens, "labels": labels, "mask": mask}


def prompt_batch(vocab_size: int, batch: int, *, kind: str = "chat",
                 min_len: int = 16, max_len: int = 64, seed: int = 0) -> dict:
    """Padded prompt batch for serving: {tokens (B,T), lengths (B,)}."""
    tok = ByteTokenizer(vocab_size)
    rng = np.random.default_rng(seed)
    prompts = []
    for i in range(batch):
        L = int(rng.integers(min_len, max_len + 1))
        ids = tok.encode(synthetic_text(kind, seed * 10_000 + i))[:L]
        prompts.append(ids)
    T = max(len(p) for p in prompts)
    out = np.full((batch, T), PAD, np.int32)
    lengths = np.zeros((batch,), np.int32)
    for i, p in enumerate(prompts):
        out[i, : len(p)] = p
        lengths[i] = len(p)
    return {"tokens": out, "lengths": lengths}
