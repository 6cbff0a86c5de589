"""Deterministic, restart-safe synthetic data pipeline (port of
``repro/data/pipeline.py``).

Batches are seeded by (run seed, step), so a restarted job regenerates
exactly the batch it would have seen. The token stream is the reference's
order-2 Markov chain over the vocab, drawn with numpy from the same seeds,
so ``SyntheticLM.batch`` gives the reference's arrays bit for bit, for
every family: audio draws B * K streams, one a codebook; a ViT batch holds
no tokens, only patch embeddings and class labels. A
background thread (``Prefetcher``) keeps ``depth`` batches ahead of the
training loop as pinned CPU tensors; the copy to the card is the caller's,
explicit and non-blocking.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch



@dataclasses.dataclass
class SyntheticLM:
    """Markov-chain token stream with per-(seed, step) determinism:
    ``tokens`` and ``targets``, (B, T) int32; a ``vlm`` batch adds the
    frontend stub's ``frontend_embeds`` (B, T, d_model) float32 and
    ``mrope_positions`` (3, B, T) int32, drawn after the tokens from the
    same generator, as the reference draws them. An ``audio`` batch's
    tokens and targets are (B, K, T), K = ``n_codebooks``: B * K streams
    drawn as one, row b * K + k codebook k of sequence b. A ``vit`` batch
    is ``frontend_embeds`` (B, T, d_model) float32 (standard normal) and
    ``labels`` (B,) int32 in [0, max(vocab_size, 2)): the train CLI passes
    ``vocab_size=max(cfg.vocab_size, 2)``, 2 for vit, so its labels are 0
    or 1, as the reference's are."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    family: str = "dense"
    d_model: int = 0         # the frontend embeddings' width (vlm, vit)
    n_codebooks: int = 0     # the audio family's streams a sequence

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        succ = min(8, v)  # each token has ~8 successors
        self._succ_idx = rng.integers(0, v, size=(v, succ))
        self._succ_p = rng.dirichlet(np.ones(succ), size=v)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) % (2**63))
        b, t, v = self.batch_size, self.seq_len, self.vocab_size

        def stream(n):
            toks = np.empty((n, t + 1), np.int32)
            toks[:, 0] = rng.integers(0, v, size=n)
            for i in range(t):
                cur = toks[:, i]
                choice = (rng.random(n)[:, None] < np.cumsum(self._succ_p[cur], -1)).argmax(-1)
                toks[:, i + 1] = self._succ_idx[cur, choice]
            return toks

        if self.family == "audio":
            s = stream(b * self.n_codebooks).reshape(b, self.n_codebooks, t + 1)
            return {"tokens": s[..., :-1], "targets": s[..., 1:]}
        if self.family == "vit":
            return {"frontend_embeds": rng.standard_normal((b, t, self.d_model))
                    .astype(np.float32),
                    "labels": rng.integers(0, max(v, 2), size=b).astype(np.int32)}
        toks = stream(b)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.family == "vlm":
            batch["frontend_embeds"] = (
                rng.standard_normal((b, t, self.d_model)).astype(np.float32) * 0.02)
            pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t))
            batch["mrope_positions"] = np.stack([pos, pos, pos])
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def make_batch_spec(cfg, shape) -> dict:
    """Every model input of (``cfg``, ``shape``) as a meta tensor (the dry
    run's: shapes and dtypes, no storage). ``shape``: a ``configs.Shape``;
    a decode shape gives one token a stream."""
    b, t = shape.global_batch, shape.seq_len
    f = getattr(torch, cfg.dtype)

    def meta(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.family == "audio":
            return {"tokens": meta((b, cfg.n_codebooks, 1))}
        batch = {"tokens": meta((b, 1))}
        if cfg.family == "vlm":
            batch["mrope_positions"] = meta((3, b, 1))
        return batch
    if cfg.family == "audio":
        return {"tokens": meta((b, cfg.n_codebooks, t)),
                "targets": meta((b, cfg.n_codebooks, t))}
    if cfg.family == "vit":
        return {"frontend_embeds": meta((b, t, cfg.d_model), f), "labels": meta((b,))}
    batch = {"tokens": meta((b, t)), "targets": meta((b, t))}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = meta((b, t, cfg.d_model), f)
        batch["mrope_positions"] = meta((3, b, t))
    return batch


def make_train_batch(cfg, generator: torch.Generator, batch_size: int, seq_len: int) -> dict:
    """Random batch on the generator's device (tests, examples): ``tokens``
    and ``targets`` (B, T) int32, uniform over the vocab, ``targets`` the
    tokens shifted by one; a ``vlm`` batch adds ``frontend_embeds``
    (standard normal x 0.02, float32) and ``mrope_positions`` (three copies
    of ``arange(T)``); audio's are (B, K, T); a ``vit`` batch is
    ``frontend_embeds`` (B, T, d_model) standard normal float32 and
    ``labels`` (B,) int32 in [0, max(n_classes, 2)), as the reference's."""
    dev = generator.device
    if cfg.family == "vit":
        return {"frontend_embeds": torch.randn((batch_size, seq_len, cfg.d_model),
                                               generator=generator, device=dev),
                "labels": torch.randint(0, max(cfg.n_classes, 2), (batch_size,),
                                        generator=generator, device=dev, dtype=torch.int32)}
    lead = (batch_size, cfg.n_codebooks) if cfg.family == "audio" else (batch_size,)
    toks = torch.randint(0, cfg.vocab_size, (*lead, seq_len + 1), generator=generator,
                         device=dev, dtype=torch.int32)
    if cfg.family == "audio":
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = torch.randn((batch_size, seq_len, cfg.d_model),
                                               generator=generator, device=dev) * 0.02
        p = torch.arange(seq_len, device=dev, dtype=torch.int32)[None].expand(batch_size,
                                                                              seq_len)
        batch["mrope_positions"] = torch.stack([p, p, p])
    return batch


def to_tensors(batch: dict, pin: bool = False) -> dict:
    """A numpy batch as CPU tensors, in pinned memory if ``pin``."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches, each turned into CPU
    tensors (pinned when ``pin``) off the training loop's thread."""

    def __init__(self, it: Iterator[dict], depth: int = 2, pin: bool = False):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._pin = pin
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop.is_set():
                return
            item = to_tensors(item, self._pin)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the thread and wait for it (it never blocks longer than a
        tenth of a second on a full queue)."""
        self._stop.set()
        self._thread.join(timeout=10)
