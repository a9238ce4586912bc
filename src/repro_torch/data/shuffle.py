"""Windowed shuffle: streaming map → reduce over per-reducer DU streams.

The classic Pilot-Data shuffle (bench_dataflow) is seal-gated: every
reducer parks ``Waiting`` until every mapper has sealed its intermediate
DU, so the reduce stage's stage-in + compute serializes behind the
slowest mapper.  This module keeps the same declarative DAG but makes the
intermediate DUs **streaming**: each mapper partitions its records into
``n_reducers`` per-reducer output DUs and flushes them incrementally
(``CUContext.flush_output`` → ordered chunk-availability events), and each
reducer is released the moment its inputs have published their first
*window* of chunks — map and reduce overlap on the critical path.

Records are length-prefixed ``(key, value)`` pairs so reducers can decode
them incrementally from the chunk stream (chunk boundaries are byte
offsets, not record boundaries): :class:`RecordAssembler` stitches chunks
back into records as they arrive.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

from ..core import DataUnitDescription
from ..core.data_unit import DEFAULT_CHUNK_SIZE

#: ``map_fn(relpath, file_bytes) -> iterable of (key, value_bytes)``
MapFn = Callable[[str, bytes], Iterable[Tuple[str, bytes]]]
#: ``reduce_fn(key, [value_bytes, ...]) -> reduced_bytes``
ReduceFn = Callable[[str, List[bytes]], bytes]

_HEADER = struct.Struct(">II")  # key length, value length


def encode_record(key: str, value: bytes) -> bytes:
    kb = key.encode("utf-8")
    return _HEADER.pack(len(kb), len(value)) + kb + bytes(value)


def decode_records(data: bytes) -> List[Tuple[str, bytes]]:
    """Decode a complete buffer of length-prefixed records."""
    asm = RecordAssembler()
    records = asm.feed(data)
    if asm.pending:
        raise ValueError(f"trailing partial record ({asm.pending} bytes)")
    return records


def partition_of(key: str, n_reducers: int) -> int:
    """Deterministic key → reducer partition (stable across processes)."""
    return zlib.crc32(key.encode("utf-8")) % n_reducers


class RecordAssembler:
    """Incremental decoder: feed arbitrary byte fragments (stream chunks),
    get back every record completed so far.  Partial records carry over
    to the next ``feed`` — chunk boundaries never split a decoded record.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def pending(self) -> int:
        """Bytes buffered that do not yet form a complete record."""
        return len(self._buf)

    def feed(self, data: bytes) -> List[Tuple[str, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[str, bytes]] = []
        while True:
            if len(self._buf) < _HEADER.size:
                return out
            klen, vlen = _HEADER.unpack_from(self._buf)
            total = _HEADER.size + klen + vlen
            if len(self._buf) < total:
                return out
            key = bytes(self._buf[_HEADER.size : _HEADER.size + klen])
            value = bytes(self._buf[_HEADER.size + klen : total])
            del self._buf[:total]
            out.append((key.decode("utf-8"), value))


def make_mapper(map_fn: MapFn, n_reducers: int, flush_every: int = 8) -> Callable:
    """Executable factory: partition every mapped record by key into the
    CU's ``n_reducers`` streaming output DUs, flushing each partition's
    stream every ``flush_every`` records so reducers see chunk prefixes
    while the mapper is still running."""

    def mapper(cu_ctx) -> int:
        out_ids = cu_ctx.cu.description.output_data
        if len(out_ids) != n_reducers:
            raise RuntimeError(
                f"mapper expects {n_reducers} output DUs, got {len(out_ids)}"
            )
        emitted = 0
        part_seq = [0] * n_reducers
        part_pending = [0] * n_reducers
        for du_id in cu_ctx.cu.description.input_data:
            for rel in sorted(cu_ctx.input_manifest(du_id)):
                data = cu_ctx.read_input(du_id, rel)
                for key, value in map_fn(rel, data):
                    r = partition_of(key, n_reducers)
                    cu_ctx.write_output(
                        f"part-{part_seq[r]:06d}",
                        encode_record(key, value),
                        index=r,
                    )
                    part_seq[r] += 1
                    part_pending[r] += 1
                    emitted += 1
                    if part_pending[r] >= flush_every:
                        part_pending[r] = 0
                        if not cu_ctx.flush_output(r):
                            return emitted  # foreign attempt owns the stream
        for r in range(n_reducers):
            if part_pending[r] and not cu_ctx.flush_output(r):
                return emitted
        return emitted

    return mapper


def make_reducer(reduce_fn: ReduceFn, window: int = 4) -> Callable:
    """Executable factory: consume every streaming input DU chunk-by-chunk
    as the producers publish (``CUContext.stream_input`` — read frontier
    advances behind the reducer so consumed stream chunks are evictable),
    group values by key, and write one sorted record file of
    ``reduce_fn(key, values)`` results."""

    def reducer(cu_ctx) -> int:
        groups: Dict[str, List[bytes]] = {}
        for du_id in cu_ctx.cu.description.input_data:
            asm = RecordAssembler()
            for _idx, chunk in cu_ctx.stream_input(du_id, window=window):
                for key, value in asm.feed(chunk):
                    groups.setdefault(key, []).append(value)
            if asm.pending:
                raise RuntimeError(
                    f"du://{du_id}: stream ended mid-record "
                    f"({asm.pending} trailing bytes)"
                )
        blob = b"".join(
            encode_record(key, reduce_fn(key, groups[key]))
            for key in sorted(groups)
        )
        cu_ctx.write_output("reduced.bin", blob)
        return len(groups)

    return reducer


@dataclasses.dataclass
class ShuffleResult:
    """Futures for one windowed-shuffle DAG submission."""

    mappers: List  # CUFuture per mapper
    reducers: List  # CUFuture per reducer
    outputs: List  # DUFuture per reducer output (sealed record files)

    def wait(self, timeout: float = 120.0) -> List[bytes]:
        """Block for the reduce stage; returns each reducer's record blob."""
        for fut in self.reducers:
            fut.result(timeout=timeout)
        return [fut.du.read("reduced.bin") for fut in self.outputs]


def windowed_shuffle(
    session,
    inputs: Sequence,
    map_fn: MapFn,
    reduce_fn: ReduceFn,
    n_reducers: int,
    *,
    window: int = 2,
    flush_every: int = 8,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    size_hint: int = 0,
    name: str = "shuffle",
    sim_map_s: float = 0.0,
    sim_reduce_s: float = 0.0,
) -> ShuffleResult:
    """Submit a streaming map → shuffle → reduce DAG in one shot.

    Every mapper gets ``n_reducers`` *streaming* intermediate DUs
    (``ready_chunks=window``); reducer *r* consumes partition *r* of every
    mapper and is released on the first published window instead of the
    last mapper seal.  ``chunk_size`` tunes streaming granularity (smaller
    chunks → earlier release, more events), ``flush_every`` the mapper's
    flush cadence, and ``size_hint`` optionally switches the readiness
    threshold to a fraction-of-expected-chunks basis downstream."""
    if n_reducers < 1:
        raise ValueError("n_reducers must be >= 1")
    map_name = f"{name}.map"
    reduce_name = f"{name}.reduce"
    session.register_function(map_name, make_mapper(map_fn, n_reducers, flush_every))
    session.register_function(reduce_name, make_reducer(reduce_fn, window=window))
    map_futs = []
    for m, src in enumerate(inputs):
        outs = [
            DataUnitDescription(
                name=f"{name}.m{m}.r{r}",
                streaming=True,
                ready_chunks=window,
                chunk_size=chunk_size,
                size_hint=size_hint,
            )
            for r in range(n_reducers)
        ]
        map_futs.append(
            session.submit_cu(
                executable=map_name,
                input_data=[src],
                output_data=outs,
                sim_compute_s=sim_map_s,
            )
        )
    reduce_futs = []
    out_futs = []
    for r in range(n_reducers):
        fut = session.submit_cu(
            executable=reduce_name,
            input_data=[mf.outputs[r] for mf in map_futs],
            output_data=[DataUnitDescription(name=f"{name}.out.r{r}")],
            sim_compute_s=sim_reduce_s,
        )
        reduce_futs.append(fut)
        out_futs.append(fut.outputs[0])
    return ShuffleResult(mappers=map_futs, reducers=reduce_futs, outputs=out_futs)
