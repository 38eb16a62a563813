"""Multi-core host feed (the port's copy of blazeseq_tpu/parallel/feed.py,
host-only): record-boundary file shards -> parallel parser threads ->
padded batches.

`shard_file` splits a plain FASTQ on record boundaries, and one parser
thread per shard runs the native scan/gather kernel, which executes outside
the GIL (ctypes releases it), so threads scale across host cores; on a
1-core host it degrades to the serial path's throughput.

Batches are yielded in completion order with their shard id. Per-record
global ordering across shards is NOT preserved (QC statistics, counters, and
alignment scoring are order-invariant and merge by summation). Within a
shard, order is preserved.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

from ..fastq.parser import FastqParser, ParserConfig
from .sharding import open_shard, shard_file


class _ShardError:
    __slots__ = ("shard_id", "exc")

    def __init__(self, shard_id: int, exc: BaseException):
        self.shard_id = shard_id
        self.exc = exc


def parallel_padded_batches(
    path,
    workers: int = 0,
    max_records: int = 16384,
    max_len: int = 256,
    pad_records_to: Optional[int] = None,
    config: Optional[ParserConfig] = None,
    queue_depth: int = 2,
    reuse_buffers: bool = False,
) -> Iterator[Tuple[int, "PaddedFastqBatch"]]:
    """Yield (shard_id, PaddedFastqBatch) from `workers` parser threads over
    record-boundary file shards. workers=0 uses all cores. Plain
    (uncompressed) files only — gzip inputs parallelize inside
    ParallelGzipReader instead.

    With reuse_buffers=True each worker rotates a small pool of padded
    buffers; a yielded batch is recycled to its worker when the consumer
    advances PAST the following batch — i.e. batch k stays valid while batch
    k+1 is being processed, the serial double-buffered padded_batches
    contract. Hold batches longer than that only with reuse_buffers=False.

    A parse/validation error in any shard is re-raised on the consumer side
    after in-flight batches drain; its message already carries the record
    context relative to the shard start."""
    import numpy as np

    from .. import native

    workers = workers or os.cpu_count() or 1
    shards = shard_file(path, workers)
    workers = len(shards)
    if workers == 1:
        parser = FastqParser(open_shard(path, 1, 0), config=config)
        for pb in parser.padded_batches(max_records, max_len=max_len,
                                        pad_records_to=pad_records_to,
                                        reuse_buffers=reuse_buffers):
            yield 0, pb
        return

    out: "queue.Queue" = queue.Queue(maxsize=max(2, queue_depth * workers))
    stop = threading.Event()
    rows = max(max_records, pad_records_to or 0)

    # Per-worker buffer pools (reuse_buffers mode). Pool depth bounds each
    # worker's in-flight batches: 1 in production + what sits in the out
    # queue + 1 held by the consumer. Consumption is arrival-ordered, so a
    # worker's oldest batch always drains and acquire() cannot deadlock.
    pool_depth = queue_depth + 2
    free_qs = []
    if reuse_buffers:
        for _ in range(workers):
            fq: "queue.Queue" = queue.Queue()
            for _ in range(pool_depth):
                fq.put((native.aligned_empty((rows, max_len)),
                        native.aligned_empty((rows, max_len)),
                        np.zeros(rows, dtype=np.int32)))
            free_qs.append(fq)

    def run(shard_id: int) -> None:
        try:
            parser = FastqParser(open_shard(path, workers, shard_id),
                                 config=config)
            while parser.has_more():
                buf_set = free_qs[shard_id].get() if reuse_buffers else None
                pb = parser.next_padded(max_records, max_len, pad_records_to,
                                        _out=buf_set)
                if pb.n_records == 0:
                    break
                if stop.is_set():
                    return
                out.put((shard_id, pb, buf_set))
        except BaseException as exc:  # surfaced on the consumer side
            out.put(_ShardError(shard_id, exc))
        finally:
            out.put(None)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(workers)]
    for t in threads:
        t.start()
    done = 0
    err: Optional[_ShardError] = None
    pending = None  # previously yielded (shard_id, buf_set), recycled late
    try:
        while done < workers:
            item = out.get()
            if item is None:
                done += 1
            elif isinstance(item, _ShardError):
                err = err or item
            else:
                shard_id, pb, buf_set = item
                yield shard_id, pb
                # consumer advanced past the PREVIOUS batch: recycle it now
                # (one-batch delay = serial double-buffered contract)
                if pending is not None:
                    free_qs[pending[0]].put(pending[1])
                pending = (shard_id, buf_set) if buf_set is not None else None
        if err is not None:
            raise err.exc
    finally:
        stop.set()
        if reuse_buffers:
            for fq in free_qs:
                fq.put(None)  # wake any worker blocked on acquire
        # drain until every producer exits: a single drain can miss in-flight
        # puts (each worker may still push one batch + its None sentinel)
        while any(t.is_alive() for t in threads):
            try:
                out.get(timeout=0.05)
            except queue.Empty:
                pass
        try:
            while True:
                out.get_nowait()
        except queue.Empty:
            pass



def parallel_count(path, workers: int = 0,
                   config: Optional[ParserConfig] = None) -> Tuple[int, int]:
    """(records, bases) over all shards in parallel — the multi-core
    equivalent of FastqParser.count() (reference runner contract
    `records base_pairs`, benchmark/fastq-parser/run_blazeseq.mojo:21-60)."""
    workers = workers or os.cpu_count() or 1
    shards = shard_file(path, workers)
    workers = len(shards)
    if workers == 1:
        return FastqParser(open_shard(path, 1, 0), config=config).count()
    results = [None] * workers
    errs = []

    def run(shard_id: int) -> None:
        try:
            parser = FastqParser(open_shard(path, workers, shard_id),
                                 config=config)
            results[shard_id] = parser.count()
        except BaseException as exc:
            errs.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    records = sum(r[0] for r in results if r)
    bases = sum(r[1] for r in results if r)
    return records, bases
