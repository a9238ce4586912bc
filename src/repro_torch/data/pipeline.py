"""DU-based token data pipeline.

Training data is organized exactly the way the paper's BWA workload was
(§6.3): a large input partitioned into per-task Data-Units ("each task
consumes a unique part of the data") plus a *shared* DU every task needs
(the reference-genome analogue — here: tokenizer/eval artifacts).  Shards
are serialized token arrays; the pipeline reads whichever replica is
co-located with the executing pilot (via CUContext) and cuts fixed-shape
next-token-prediction batches with a background prefetcher.

Two on-DU formats coexist:

  * ``.npy`` files (:func:`encode_tokens`) — self-describing, read whole
    via ``CUContext.read_input``;
  * raw little-endian int32 ``.bin`` files (:func:`encode_raw_tokens`) —
    the *chunk-streamable* format: the DU's canonical byte stream
    (files concatenated in sorted-relpath order) IS the token stream, so
    :class:`StreamingShardReader` can consume published chunk prefixes
    through ``CUContext.stream_input`` before the whole shard is staged.
"""

from __future__ import annotations

import io
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core import CoordinationStore, DataUnit, DataUnitDescription

#: default shard chunk size — small enough that a 200 kB demo shard still
#: splits into several chunks (so prefix streaming/prefetch is exercised)
SHARD_CHUNK_BYTES = 64 * 1024


def encode_tokens(tokens: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, tokens.astype(np.int32), allow_pickle=False)
    return buf.getvalue()


def decode_tokens(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def encode_raw_tokens(tokens: np.ndarray) -> bytes:
    """Chunk-streamable codec: raw little-endian int32, no header — any
    byte prefix of length 4k decodes to the first k tokens."""
    return np.ascontiguousarray(tokens, dtype="<i4").tobytes()


def decode_raw_tokens(data: bytes) -> np.ndarray:
    usable = len(data) - (len(data) % 4)
    return np.frombuffer(data[:usable], dtype="<i4")


def _decode_shard_file(relpath: str, data: bytes) -> np.ndarray:
    return decode_raw_tokens(data) if relpath.endswith(".bin") else decode_tokens(data)


def make_token_shards(
    n_shards: int,
    tokens_per_shard: int,
    vocab_size: int,
    seed: int = 0,
    files_per_shard: int = 4,
    fmt: str = "npy",
) -> List[Dict[str, bytes]]:
    """Synthetic corpus: ``n_shards`` shard file-sets (each a DU's files).

    Tokens follow a Zipf-like unigram distribution (not uniform) so that a
    few optimizer steps measurably reduce the loss — the e2e training tests
    assert improvement, and uniform noise has nothing to learn.

    ``fmt="raw"`` emits headerless ``tokens_*.bin`` files whose sorted
    concatenation is the raw token stream (the streamable shard format);
    ``fmt="npy"`` keeps the self-describing per-file arrays."""
    if fmt not in ("npy", "raw"):
        raise ValueError(f"unknown shard format {fmt!r} (use 'npy' or 'raw')")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / (ranks + 5.0)
    probs /= probs.sum()
    encode = encode_raw_tokens if fmt == "raw" else encode_tokens
    ext = "bin" if fmt == "raw" else "npy"
    shards = []
    per_file = tokens_per_shard // files_per_shard
    for s in range(n_shards):
        files = {}
        for f in range(files_per_shard):
            toks = rng.choice(vocab_size, size=per_file, p=probs).astype(np.int32)
            files[f"tokens_{f:03d}.{ext}"] = encode(toks)
        shards.append(files)
    return shards


def shard_dus(
    shards: List[Dict[str, bytes]],
    store: CoordinationStore,
    name: str = "corpus",
    affinities: Optional[List[Optional[str]]] = None,
    chunk_size: Optional[int] = None,
) -> List[DataUnit]:
    """Wrap shard file-sets into Data-Units (partitioned-data pattern)."""
    dus = []
    for i, files in enumerate(shards):
        aff = affinities[i % len(affinities)] if affinities else None
        dus.append(
            DataUnit(
                DataUnitDescription(
                    name=f"{name}.shard{i:03d}",
                    files=files,
                    affinity=aff,
                    **({"chunk_size": chunk_size} if chunk_size else {}),
                ),
                store,
            )
        )
    return dus


def stage_shard_dus(
    session,
    shards: List[Dict[str, bytes]],
    name: str = "corpus",
    affinities: Optional[List[Optional[str]]] = None,
    chunk_size: int = SHARD_CHUNK_BYTES,
) -> List:
    """Session-native shard staging: each shard file-set becomes a chunked
    DU placed by affinity (round-robin over ``affinities``); returns the
    :class:`~repro.core.futures.DUFuture` handles.  Chunked manifests are
    what lets consumers stream prefixes (``CUContext.stream_input``) and
    the async scheduler prefetch at chunk granularity."""
    futures = []
    for i, files in enumerate(shards):
        aff = affinities[i % len(affinities)] if affinities else None
        futures.append(
            session.submit_du(
                name=f"{name}.shard{i:03d}",
                files=files,
                affinity=aff,
                chunk_size=chunk_size,
            )
        )
    return futures


class ShardReader:
    """Cuts [batch, seq+1] windows from a shard's token stream (wrapping).

    Window positions are drawn from a **per-step** RNG stream
    (``default_rng([seed, step])``), so ``batches(start_step=k)`` resumes
    exactly where an uninterrupted run would be at step k — a training
    chunk replayed after a pilot failure sees the same data it would have
    seen the first time (resume ≡ continuation)."""

    def __init__(self, files: Dict[str, bytes], seed: int = 0):
        arrays = [_decode_shard_file(k, files[k]) for k in sorted(files)]
        self.tokens = np.concatenate(arrays) if arrays else np.zeros(0, np.int32)
        self.seed = seed

    @classmethod
    def from_cu_context(cls, cu_ctx, du_id: str, seed: int = 0) -> "ShardReader":
        manifest = cu_ctx.input_manifest(du_id)
        files = {rel: cu_ctx.read_input(du_id, rel) for rel in manifest}
        return cls(files, seed=seed)

    def batches(
        self, batch: int, seq: int, start_step: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.tokens)
        need = seq + 1
        assert n >= need, f"shard too small: {n} < {need}"
        step = start_step
        while True:
            rng = np.random.default_rng([self.seed, step])
            starts = rng.integers(0, n - need, size=batch)
            window = np.stack([self.tokens[s : s + need] for s in starts])
            yield {
                "tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32),
            }
            step += 1


class StreamingShardReader:
    """Chunk-prefix shard reader over ``CUContext.stream_input``.

    Consumes a raw-format (``.bin``) shard DU as its chunks land in the
    sandbox — published prefixes of a streaming producer, or the staged
    prefix of a sealed chunked DU — and cuts **deterministic sequential
    windows**: step k's batch covers tokens
    ``[k·batch·(seq+1), (k+1)·batch·(seq+1))`` of the canonical stream
    (wrapping modulo the final length once the stream is exhausted).
    Positions depend only on the step index, never on how much of the
    stream had arrived when the batch was cut, so a replayed chunk reads
    identical data (resume ≡ continuation) and sync/async execution modes
    see identical batches."""

    def __init__(self, cu_ctx, du_id: str, window: int = 4):
        self._chunks = cu_ctx.stream_input(du_id, window=window)
        self._buf = bytearray()
        self._exhausted = False
        #: chunks consumed so far (observability: prefetch-overlap tests)
        self.chunks_consumed = 0

    def _tokens(self) -> np.ndarray:
        return decode_raw_tokens(bytes(self._buf))

    def _fill(self, need_tokens: int) -> None:
        while not self._exhausted and len(self._buf) // 4 < need_tokens:
            try:
                _, data = next(self._chunks)
            except StopIteration:
                self._exhausted = True
                return
            self._buf.extend(data)
            self.chunks_consumed += 1

    def batches(
        self, batch: int, seq: int, start_step: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        need = seq + 1
        per_step = batch * need
        step = start_step
        while True:
            lo = step * per_step
            self._fill(lo + per_step)
            toks = self._tokens()
            n = len(toks)
            assert n >= need, f"shard too small: {n} < {need}"
            if n >= lo + per_step:
                window = toks[lo : lo + per_step]
            else:
                # stream exhausted: n is the final length, wrap modulo it —
                # the same positions an unwrapped infinite stream would map
                # to, computable identically on any replay
                window = toks[np.arange(lo, lo + per_step) % n]
            window = window.reshape(batch, need)
            yield {
                "tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32),
            }
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue (overlaps host-side
    batch prep with device compute).

    ``close()`` is leak-proof: the producer's puts are stop-aware (bounded
    timeout, re-checking the stop flag), and close drains the queue until
    the thread exits — a producer parked in ``put`` on a full queue can
    never outlive an abandoned iterator."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(it,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False once the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self):
        """Stop the producer and reclaim the thread (drain-and-join): free
        a slot so a blocked put observes the stop flag, repeat until the
        thread is gone."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
