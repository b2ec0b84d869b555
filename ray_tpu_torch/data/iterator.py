"""DataIterator + streaming_split coordination (reference:
python/ray/data/iterator.py DataIterator and
_internal/execution/streaming_split coordination via
StreamSplitDataIterator — an actor serves blocks to N consumers).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Iterator, List, Optional

import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.common import config
from ray_tpu_torch.data import block as B

# docs/observability.md: component "data".
_BATCH_ASSEMBLY = telemetry.histogram(
    "data", "batch_assembly_s", "slice+concat+format per emitted batch"
)
_PREFETCH_DEPTH = telemetry.gauge(
    "data", "prefetch_queue_depth", "batches ready ahead of the consumer"
)
_BYTES_FETCHED = telemetry.counter(
    "data", "bytes_fetched", "block bytes materialized on the consumer"
)
_SPLIT_QUEUE_DEPTH = telemetry.gauge(
    "data", "split_queue_depth", "blocks buffered across split queues"
)
_SPLIT_DISPATCHED = telemetry.counter(
    "data", "split_blocks_dispatched", "blocks routed to a split queue"
)
_SPLIT_STEALS = telemetry.counter(
    "data", "split_steals", "tail blocks claimed from a lagging split"
)


def batches_from_blocks(
    blocks: Iterator[pa.Table],
    batch_size: Optional[int],
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator[Any]:
    """Re-chunk a stream of blocks into fixed-size batches.

    Copy budget (docs/perf.md): an offset cursor walks the queued tables and
    emits each batch from zero-copy ``pa.Table.slice`` views, concatenating
    ONLY when a batch spans a block boundary. The remainder of a block is
    never re-copied per batch (the old path paid concat + two slice copies
    of the whole buffer for every emitted batch).
    """
    if batch_size is None:
        for blk in blocks:
            if blk.num_rows:
                yield B.block_to_batch(blk, batch_format)
        return
    hist = _BATCH_ASSEMBLY.cell()
    buf: collections.deque = collections.deque()
    off = 0  # rows of buf[0] already emitted
    buffered = 0  # unemitted rows across buf
    for blk in blocks:
        if blk.num_rows == 0:
            continue
        buf.append(blk)
        buffered += blk.num_rows
        while buffered >= batch_size:
            t0 = time.perf_counter()
            need = batch_size
            parts: List[pa.Table] = []
            while need:
                head = buf[0]
                take = min(head.num_rows - off, need)
                parts.append(head.slice(off, take))
                off += take
                need -= take
                if off == head.num_rows:
                    buf.popleft()
                    off = 0
            buffered -= batch_size
            batch = parts[0] if len(parts) == 1 else B.concat_blocks(parts)
            out = B.block_to_batch(batch, batch_format)
            hist.observe(time.perf_counter() - t0)
            yield out
    if buffered and not drop_last:
        t0 = time.perf_counter()
        parts = [buf[0].slice(off)] + list(buf)[1:]
        batch = parts[0] if len(parts) == 1 else B.concat_blocks(parts)
        out = B.block_to_batch(batch, batch_format)
        hist.observe(time.perf_counter() - t0)
        yield out


def iter_blocks_pipelined(
    refs: Iterator[Any], lookahead: Optional[int] = None
) -> Iterator[pa.Table]:
    """Fetch blocks with up to ``lookahead`` gets in flight, yielding in
    input order — object-store pull overlaps batch assembly instead of
    serializing against it (reference: prefetch_blocks in the iterator
    path). ``ray_tpu_torch.get`` is thread-safe (worker.run_async bridges onto
    the owner's event loop), so a small thread pool is all this needs."""
    if lookahead is None:
        lookahead = config.data_fetch_lookahead
    bytes_cell = _BYTES_FETCHED.cell()

    def _fetch(ref):
        blk = ray_tpu_torch.get(ref)
        bytes_cell.inc(blk.nbytes)
        return blk

    refs = iter(refs)
    if lookahead <= 1:
        try:
            for ref in refs:
                yield _fetch(ref)
        finally:
            close = getattr(refs, "close", None)
            if close is not None:
                close()
        return
    from concurrent.futures import ThreadPoolExecutor

    # One fetch thread: the blocks are fetched in order. A fetched block is
    # held (its zero-copy buffers keep its store hold) and cannot be
    # spilled, and the block the consumer waits for may need the arena room
    # that later blocks, fetched first, would take.
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="block-fetch")
    pending: collections.deque = collections.deque()
    try:
        for ref in refs:
            pending.append(pool.submit(_fetch, ref))
            if len(pending) >= lookahead:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()
        pool.shutdown(wait=False)
        close = getattr(refs, "close", None)
        if close is not None:
            close()


def prefetch_iterator(it: Iterator[Any], n: int) -> Iterator[Any]:
    """Run `it` in a background thread, keeping up to `n` items ready.
    Overlaps batch assembly (block fetch + slice + format conversion) with
    the consumer's compute — the reference's prefetch_batches semantics
    (python/ray/data/iterator.py iter_batches)."""
    if n <= 0:
        yield from it
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=n)
    _END = object()
    stop = threading.Event()
    depth = _PREFETCH_DEPTH.cell()

    def _put(item) -> bool:
        # Bounded put that gives up when the consumer abandoned the
        # iterator — otherwise the fill thread would block on a full queue
        # forever, pinning the buffered batches and the upstream iterator.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                depth.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for item in it:
                if not _put(item):
                    break
            else:
                _put(_END)
        except BaseException as e:  # surfaced on the consumer side
            _put(e)
        finally:
            if stop.is_set():
                # Run upstream generators' finally-blocks promptly.
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass

    t = threading.Thread(target=fill, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            depth.set(q.qsize())
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _mapped_with_close(fn, it):
    """map() that forwards close() to the source generator — the prefetch
    thread relies on close() to run upstream finally-blocks promptly when
    the consumer abandons iteration (plain map objects have no close)."""
    try:
        for item in it:
            yield fn(item)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class _SplitCoordinator:
    """Actor owning one dataset execution, streaming blocks to N splits.

    True streaming (reference: _internal/execution/operators/output_splitter.py
    + streaming_executor.py:48): a producer thread drives the pull-based
    StreamingExecutor and deposits block refs into per-split queues; splits
    drain their queue on demand. The producer blocks when every queue is at
    its cap, so backpressure reaches the executor's submit window and the
    dataset never has to fit in the object store. First-batch latency is one
    block, not one epoch. The executor runs with
    ``preserve_order=config.data_split_preserve_order`` (default False):
    splits shard the stream anyway, so blocks dispatch in completion order
    and a straggler read task delays only itself.

    Dispatch (the reference OutputSplitter's equal=False load balancing):
    each block goes to the least-loaded non-full queue, so a stalled or
    slow split only ever pins cap-many blocks while healthy splits keep
    streaming. Once the producer finishes, an idle split steals the tail
    from lagging splits — immediately from splits that joined the epoch
    (they are racing it anyway), and only after a grace period from splits
    that never showed up (protects a late-starting trainer worker's share).

    Epochs: a split calls start_epoch before each pass. Joining a running
    epoch is immediate; asking for the NEXT epoch blocks until every split
    that joined the current epoch has drained it (barrier — prevents a fast
    split's relaunch from leaking next-epoch blocks into a slow split's
    current iteration), then relaunches the execution. A split that
    abandoned an epoch mid-way (consumer broke out of iter_batches) has its
    leftover share discarded when it asks for a fresh pass.
    """

    # Handed-out refs are pinned for this many subsequent next_refs calls of
    # the same split: the owner (this actor) must keep a ref alive until the
    # borrower has fetched the payload. 3 (not 2) because the consumer
    # requests group k+1 while group k's fetches are still in flight (the
    # DataIterator RPC lookahead) — groups k, k+1, k+2 may all have
    # unfinished fetches when k+2 is handed out.
    _PIN_GROUPS = 3
    # Seconds after producer completion before an idle split may steal from
    # a split that never joined this epoch. Trade-off: shorter means a
    # sole sequential consumer finishes sooner; longer protects a
    # slow-starting trainer worker's share (reference equal=False makes no
    # reservation at all — any grace here is stricter fairness than the
    # reference's demand dispatch).
    _STEAL_GRACE = 10.0

    def __init__(self, plan_blob: bytes, n: int, parallelism: int):
        import collections
        import threading

        import cloudpickle

        self.ops = cloudpickle.loads(plan_blob)
        self.n = n
        self.parallelism = parallelism
        self._cond = threading.Condition()
        self._queues: List[Any] = [collections.deque() for _ in range(n)]
        self._queue_cap = max(2, -(-parallelism // n) + 1)
        self._buffered = 0
        self._rr = 0  # tie-break rotation for least-loaded dispatch
        self._epoch = -1
        self._producer: Optional[Any] = None
        self._producer_done = True
        self._done_at: float = 0.0  # monotonic time the producer finished
        self._producer_error: Optional[BaseException] = None
        # Epoch membership: splits that called start_epoch for the current
        # epoch, and splits that observed it exhausted.
        self._joined: set = set()
        self._finished: set = set()
        # split_idx -> deque of recently handed-out ref groups (pinning).
        self._handed: Dict[int, Any] = {
            i: collections.deque(maxlen=self._PIN_GROUPS) for i in range(n)
        }
        self._depth_cell = _SPLIT_QUEUE_DEPTH.cell()
        self._dispatched_cell = _SPLIT_DISPATCHED.cell()
        self._steals_cell = _SPLIT_STEALS.cell()

    # -- producer ------------------------------------------------------------

    def _launch(self, joined_by: int) -> None:
        """Start execution for a new epoch. Caller holds self._cond."""
        import threading
        import time as _time

        self._epoch += 1
        for q in self._queues:
            q.clear()
        self._buffered = 0
        self._producer_done = False
        self._producer_error = None
        self._joined = {joined_by}
        self._finished = set()
        epoch = self._epoch

        def run():
            from ray_tpu_torch.data._execution import StreamingExecutor

            try:
                ex = StreamingExecutor(
                    self.parallelism,
                    preserve_order=config.data_split_preserve_order,
                )
                for bundle in ex.execute(self.ops):
                    ref = bundle.block
                    with self._cond:
                        while (
                            self._epoch == epoch
                            and min(len(q) for q in self._queues)
                            >= self._queue_cap
                        ):
                            self._cond.wait(1.0)
                        if self._epoch != epoch:
                            return  # superseded; drop the rest
                        # Least-loaded non-full queue; rotate ties so an
                        # all-empty start round-robins.
                        order = sorted(
                            range(self.n),
                            key=lambda i: (
                                len(self._queues[i]),
                                (i - self._rr) % self.n,
                            ),
                        )
                        dest = order[0]
                        self._rr = (dest + 1) % self.n
                        self._queues[dest].append(ref)
                        self._buffered += 1
                        self._dispatched_cell.inc()
                        self._depth_cell.set(self._buffered)
                        self._cond.notify_all()
            except BaseException as e:  # surfaced to every consumer
                with self._cond:
                    if self._epoch == epoch:  # a superseded producer's late
                        self._producer_error = e  # failure must not poison
                        # the relaunched epoch.
            finally:
                with self._cond:
                    if self._epoch == epoch:
                        self._producer_done = True
                        self._done_at = _time.monotonic()
                        self._cond.notify_all()

        self._producer = threading.Thread(
            target=run, daemon=True, name=f"split-producer-{epoch}"
        )
        self._producer.start()

    # -- split-facing API ----------------------------------------------------

    def start_epoch(self, split_idx: int, timeout: float = 600.0) -> int:
        """Begin (or join) an epoch for this split; returns the epoch id.

        Blocks (barrier) when asking for a new epoch while peers are still
        draining the current one.
        """
        import time as _time

        with self._cond:
            if self._producer is None:
                self._launch(split_idx)
                return self._epoch
            if split_idx not in self._joined:
                # Fresh join of the running (or just-drained) epoch. Its
                # reserved share is still in its queue — un-joined splits
                # are protected from stealing by the grace period.
                self._joined.add(split_idx)
                return self._epoch
            if split_idx not in self._finished:
                # Abandoned mid-epoch (consumer broke out of iteration):
                # discard this split's leftover share so the epoch can
                # drain, then fall through to request a fresh pass.
                q = self._queues[split_idx]
                self._buffered -= len(q)
                q.clear()
                self._depth_cell.set(self._buffered)
                self._finished.add(split_idx)
                self._cond.notify_all()
            # Wants the NEXT epoch: wait until every joined split drained
            # the current one, then relaunch (one waiter wins; the rest see
            # the epoch advance and join it).
            target = self._epoch + 1
            deadline = _time.monotonic() + timeout
            while self._epoch < target:
                # Ready when every joined split drained the epoch. The
                # producer need not be done: if all consumers abandoned, the
                # relaunch supersedes it (the producer thread observes the
                # epoch bump and exits instead of producing to nobody).
                ready = self._buffered == 0 and self._joined <= self._finished
                if ready:
                    self._launch(split_idx)
                    return self._epoch
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"split {split_idx} waited {timeout}s for peers "
                        f"{sorted(self._joined - self._finished)} to finish "
                        f"epoch {self._epoch}"
                    )
                self._cond.wait(min(remaining, 1.0))
            self._joined.add(split_idx)
            return self._epoch

    def next_refs(
        self,
        split_idx: int,
        max_n: int = 4,
        timeout: float = 300.0,
        epoch: Optional[int] = None,
    ):
        """Claim up to max_n block refs for this split.

        Returns (refs, done): done=True means the epoch is exhausted and no
        further refs will arrive. Blocks until at least one ref is available
        or the epoch ends; raises the producer's error if execution failed.

        ``epoch`` (from start_epoch) fences stale calls: the DataIterator
        keeps one next_refs RPC in flight ahead, so a consumer that abandons
        iteration can leave a blocked call behind — when the epoch advances,
        that call must return empty instead of eating the new epoch's
        blocks.
        """
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cond:
            while True:
                if epoch is not None and self._epoch != epoch:
                    return [], True  # stale pre-fetch from a finished pass
                if self._producer_error is not None:
                    raise self._producer_error
                src = self._queues[split_idx]
                if not src and self._producer_done and self._buffered:
                    # Tail steal: production finished and this split is
                    # idle. Joined peers are fair game (they are actively
                    # racing); never-joined peers keep their share for a
                    # grace period in case they are still spawning.
                    grace_over = (
                        _time.monotonic() - self._done_at >= self._STEAL_GRACE
                    )
                    candidates = [
                        q
                        for j, q in enumerate(self._queues)
                        if q and (j in self._joined or grace_over)
                    ]
                    if candidates:
                        src = max(candidates, key=len)
                        self._steals_cell.inc()
                if src:
                    refs = []
                    while src and len(refs) < max_n:
                        refs.append(src.popleft())
                    self._buffered -= len(refs)
                    self._depth_cell.set(self._buffered)
                    done = self._producer_done and self._buffered == 0
                    if done:
                        self._finished.add(split_idx)
                    # Pin: the bounded deque drops groups handed out
                    # _PIN_GROUPS calls ago — by then the consumer has
                    # fetched them (with the RPC lookahead, group k's
                    # fetches finish before group k+2 is requested).
                    self._handed[split_idx].append(refs)
                    self._cond.notify_all()  # wake the producer (queue space)
                    return refs, done
                if self._producer_done and self._buffered == 0:
                    self._finished.add(split_idx)
                    self._cond.notify_all()  # release the epoch barrier
                    return [], True
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"split {split_idx} waited {timeout}s for a block"
                    )
                self._cond.wait(min(remaining, 1.0))


class DataIterator:
    """Per-consumer view of a streaming split; picklable (ships the
    coordinator actor handle).

    Single-split fast path: ``streaming_split(1)`` constructs this with a
    plan blob and NO coordinator — one consumer needs no cross-consumer
    queueing, so iteration drives the StreamingExecutor in-process (each
    pass is a fresh epoch, same semantics) and skips the actor spawn plus
    a per-group RPC round trip. Pickling ships the plan blob itself: the
    receiving process (a trainer worker is a full ray worker, exactly what
    the coordinator actor would have been) drives its own local execution.
    With one split there is one consumer, so "each consumer executes the
    plan" and "one shared execution" coincide; pickling stays free of side
    effects (no actor spawn mid-serialization, which may run on the event
    loop thread)."""

    def __init__(
        self,
        coordinator,
        split_idx: int,
        _local_plan: Optional[bytes] = None,
        _parallelism: int = 8,
    ):
        self._coord = coordinator
        self._idx = split_idx
        self._local_plan = _local_plan
        self._par = _parallelism

    def _local_blocks(self) -> Iterator[pa.Table]:
        import cloudpickle

        from ray_tpu_torch.data._execution import StreamingExecutor

        ops = cloudpickle.loads(self._local_plan)
        ex = StreamingExecutor(
            self._par, preserve_order=config.data_split_preserve_order
        )

        def refs():
            for bundle in ex.execute(ops):
                yield bundle.block

        yield from iter_blocks_pipelined(refs())

    def _ref_stream(self, epoch: int) -> Iterator[Any]:
        """Yield this split's block refs, keeping ONE next_refs RPC in
        flight ahead: the request for group k+1 rides the wire while group
        k's blocks are fetched (coordinator pinning covers the overlap —
        see _SplitCoordinator._PIN_GROUPS)."""
        nxt = self._coord.next_refs.remote(self._idx, epoch=epoch)
        while True:
            refs, done = ray_tpu_torch.get(nxt)
            if not done:
                nxt = self._coord.next_refs.remote(self._idx, epoch=epoch)
            for ref in refs:
                yield ref
            if done:
                return

    def _blocks(self) -> Iterator[pa.Table]:
        if self._coord is None:
            yield from self._local_blocks()
            return
        epoch = ray_tpu_torch.get(self._coord.start_epoch.remote(self._idx))
        # Direct object-store fetch: zero-copy shm view for local blocks,
        # chunked pull for remote ones — the data plane never flows through
        # the coordinator actor. Pipelined so fetch overlaps assembly.
        yield from iter_blocks_pipelined(self._ref_stream(epoch))

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 1,
        _finalize_fn: Optional[Any] = None,
    ) -> Iterator[Any]:
        """Iterate fixed-size batches over this split's stream of blocks.

        _finalize_fn (reference: python/ray/data/iterator.py iter_batches
        _finalize_fn) runs on each batch INSIDE the prefetch thread — put
        the host->device copy there (pinned memory, then
        `.to(device, non_blocking=True)` on a side stream) and the copy of
        batch k+1 overlaps the consumer's device compute on batch k (double
        buffering). The prefetch thread has its own current CUDA device, so
        name the device explicitly.
        """
        it = batches_from_blocks(
            self._blocks(), batch_size, batch_format, drop_last
        )
        if _finalize_fn is not None:
            it = _mapped_with_close(_finalize_fn, it)
        yield from prefetch_iterator(it, prefetch_batches)

    def iter_rows(self) -> Iterator[Any]:
        for blk in self._blocks():
            yield from B.block_to_rows(blk)

    def materialize(self):
        from ray_tpu_torch.data.dataset import Dataset
        from ray_tpu_torch.data._execution import FromBlocks

        return Dataset([FromBlocks(list(self._blocks()))])

    def __reduce__(self):
        return (DataIterator, (self._coord, self._idx, self._local_plan, self._par))
