"""Worker-process parallelism for the ``--threads`` CLI mode.

Counterpart of ``atropos_tpu/commands/multicore.py`` (reference model:
``atropos/commands/multicore.py`` + ``atropos/commands/trim/multicore.py``):
the main process reads and enqueues record batches; N-1 spawned workers
run the pipeline over them; results either stream to one dedicated
writer process, optionally in input order, or every worker writes its
own ``.N``-suffixed shard files (parallel-write, the fastest placement).
Worker summaries return over a queue and merge through the typed summary
algebra. Robustness is soft: waits log-escalate on timeout instead of
killing, and liveness / batch-completeness audits surface silent worker
deaths.

The workers run the reference's per-record pipeline, with no batched
engine. A pipeline that carries a device (the statistics' position
counts of qc and ``--stats``) carries it as a device string, which the
spawned child resolves on its own; the card's kernels run in the
multi-process ranks instead (:mod:`atropos_tpu_torch.parallel`).
"""
import heapq
import inspect
import logging
import multiprocessing
import os
import time
from queue import Empty, Full

#: spawn-based multiprocessing context: the parent may hold a live CUDA
#: context and torch's threads by the time workers launch; CUDA cannot be
#: used in a forked child, and forking a multi-threaded process risks
#: deadlocks. Spawned children start from a clean interpreter and never
#: inherit device state.
_MP = multiprocessing.get_context("spawn")
Process = _MP.Process
Queue = _MP.Queue
Value = _MP.Value

from atropos_tpu_torch import AtroposError
from atropos_tpu_torch.util import run_interruptible

#: max seconds between retries of a blocked queue operation
RETRY_INTERVAL = 5

CONTROL_ACTIVE = -1  # controlled process should keep running
CONTROL_ERROR = -2  # controlled process hit an error; peers should exit


def _log():
    return logging.getLogger()


class MulticoreError(AtroposError):
    """Base error for the parallel runtime."""


class Done(MulticoreError):
    """Signals normal completion inside a process loop."""


class Killed(MulticoreError):
    """Signals early termination of a process."""


# -- low-level primitives ------------------------------------------------------


def wait_on(
    condition,
    *args,
    wait_message="Waiting {}",
    timeout=None,
    fail_callback=None,
    wait=None,
    timeout_callback=None,
):
    """Poll ``condition(*args)`` until it returns anything but False.

    The timeout is *soft*: when exceeded, the wait message escalates to
    error level and ``timeout_callback`` fires (raising it if it is an
    exception class), but polling continues — a deliberately lenient
    policy for hosts with congested filesystems.
    """
    if wait is True:
        pause = lambda: time.sleep(RETRY_INTERVAL)
    elif isinstance(wait, int):
        pause = lambda: time.sleep(wait)
    else:
        pause = wait

    started = None
    while True:
        outcome = condition(*args)
        if outcome is not False:
            return outcome
        if fail_callback:
            fail_callback()
        now = time.time()
        if started is None:
            started = now
            continue
        elapsed = now - started
        message = wait_message.format(
            "for {} seconds".format(round(elapsed, 1))
        )
        if timeout is not None and elapsed >= timeout:
            _log().error(message)
            if timeout_callback:
                if inspect.isclass(timeout_callback):
                    raise timeout_callback()
                timeout_callback()
        else:
            _log().debug(message)
        if pause:
            pause()


def enqueue(
    queue,
    item,
    wait_message="Waiting to enqueue item {}",
    block_timeout=RETRY_INTERVAL,
    **kwargs,
):
    def try_put(value):
        try:
            queue.put(value, block=True, timeout=block_timeout)
            return True
        except Full:
            return False

    wait_on(try_put, item, wait_message=wait_message, **kwargs)


def dequeue(
    queue,
    wait_message="Waiting to dequeue item {}",
    block_timeout=RETRY_INTERVAL,
    **kwargs,
):
    def try_get():
        try:
            return queue.get(block=True, timeout=block_timeout)
        except Empty:
            return False

    return wait_on(try_get, wait_message=wait_message, **kwargs)


def enqueue_all(items, queue, timeout, fail_callback):
    """Feed every item into the queue; returns how many were enqueued."""
    count = 0
    for item in items:
        enqueue(
            queue,
            item,
            wait_message="Main process waiting to queue item {}",
            timeout=timeout,
            fail_callback=fail_callback,
        )
        count += 1
    return count


def ensure_processes(
    processes, message="One or more process exited: {}", alive=True
):
    """Raise unless every process matches the expected aliveness."""
    states = [proc.is_alive() for proc in processes]
    if alive != all(states):
        offenders = [str(i) for i, state in enumerate(states) if state != alive]
        raise MulticoreError(message.format(",".join(offenders)))


def wait_on_process(process, timeout, terminate=False):
    return wait_on(
        lambda: not process.is_alive(),
        wait_message="Waiting on {} to terminate {{}}".format(process.name),
        timeout=timeout,
        wait=lambda: process.join(RETRY_INTERVAL),
        timeout_callback=(process.terminate if terminate else None),
    )


def kill(process, retcode, timeout):
    if retcode <= 1:
        wait_on_process(process, timeout, terminate=True)
    elif process.is_alive():
        process.terminate()


class Control:
    """One shared long used as a tiny cross-process control channel."""

    def __init__(self, initial_value=CONTROL_ACTIVE):
        self.control = Value("l", initial_value)

    def get_value(self, lock=True):
        if not lock:
            return self.control.value
        with self.control.get_lock():
            return self.control.value

    def set_value(self, value):
        with self.control.get_lock():
            self.control.value = value

    def check_value(self, value, lock=False):
        return self.get_value(lock=lock) == value

    def check_value_positive(self, lock=False):
        return self.get_value(lock=lock) >= 0


class PendingQueue:
    """Priority-ordered holding pen for out-of-order batches (heap-based)."""

    def __init__(self, max_size=None):
        self._heap = []
        self._items = {}
        self.max_size = max_size

    def push(self, priority, value):
        if self.full:
            raise Full()
        if priority in self._items:
            raise ValueError("Duplicate priority value: {}".format(priority))
        heapq.heappush(self._heap, priority)
        self._items[priority] = value

    def pop(self):
        if self.empty:
            raise Empty()
        priority = heapq.heappop(self._heap)
        return self._items.pop(priority)

    @property
    def min_priority(self):
        return self._heap[0] if self._heap else None

    @property
    def full(self):
        return bool(self.max_size) and len(self._heap) >= self.max_size

    @property
    def empty(self):
        return not self._heap


# -- worker / runner -----------------------------------------------------------


class ParallelPipelineMixin:
    """Tracks which batch indexes this worker actually processed."""

    def start(self, **kwargs):
        super().start(**kwargs)
        self.seen_batches = set()

    def process_batch(self, batch):
        self.seen_batches.add(batch[0]["index"])
        super().process_batch(batch)

    def finish(self, summary, worker=None):
        super().finish(summary, worker=worker)
        _log().debug(
            "%s finished; processed %d batches, %d reads",
            worker.name if worker else "worker",
            len(self.seen_batches),
            sum(self.record_counts.values()),
        )


class WorkerProcess(Process):
    """One forked pipeline executor; None on the input queue stops it."""

    def __init__(self, index, input_queue, pipeline, summary_queue, timeout):
        super().__init__(name="Worker process {}".format(index))
        self.index = index
        self.input_queue = input_queue
        self.pipeline = pipeline
        self.summary_queue = summary_queue
        self.timeout = timeout

    def _next_batch(self):
        return dequeue(
            self.input_queue,
            wait_message="{} waiting on batch {{}}".format(self.name),
            timeout=self.timeout,
        )

    def run(self):
        _log().debug("%s running under pid %d", self.name, os.getpid())
        summary = {}
        try:
            self.pipeline.start(worker=self)
            try:
                while True:
                    batch = self._next_batch()
                    if batch is None:
                        break
                    self.pipeline.process_batch(batch)
            finally:
                self.pipeline.finish(summary, worker=self)
            _log().debug("%s finished normally", self.name)
        except Exception as err:
            _log().error("Unexpected error in %s", self.name, exc_info=True)
            summary["exception"] = err
        enqueue(
            self.summary_queue,
            (self.index, self.pipeline.seen_batches, summary),
            wait_message="{} waiting to queue summary {{}}".format(self.name),
            timeout=self.timeout,
        )


def launch_workers(count, args=(), offset=0, worker_class=WorkerProcess):
    _log().info("Starting %d worker processes", count)
    workers = [worker_class(offset + i, *args) for i in range(count)]
    for worker in workers:
        worker.start()
    return workers


class ParallelPipelineRunner:
    """Main-process orchestration: feed, reap summaries, audit, merge."""

    def __init__(self, command_runner, pipeline, threads=None):
        self.threads = threads or command_runner.threads
        if self.threads < 2:
            raise ValueError("'threads' must be >= 2")
        self.command_runner = command_runner
        self.pipeline = pipeline
        self.timeout = max(command_runner.process_timeout, RETRY_INTERVAL)
        self.input_queue = Queue(command_runner.read_queue_size)
        self.summary_queue = Queue(self.threads)
        self.worker_processes = None
        self.num_batches = None
        self.seen_summaries = None
        self.seen_batches = None

    # hooks for subclasses
    def ensure_alive(self):
        ensure_processes(self.worker_processes)

    def after_enqueue(self):
        pass

    def finish(self):
        pass

    def run(self):
        retcode = run_interruptible(self)
        self.terminate(retcode)
        return retcode

    def terminate(self, retcode):
        if self.worker_processes is None:
            _log().warning("Called terminate before starting workers")
            return
        _log().debug("Exiting all processes")
        for process in self.worker_processes:
            kill(process, retcode, self.timeout)

    def __call__(self):
        self._feed_all_input()
        self.after_enqueue()
        self._await_summaries()
        self._reap_and_merge()
        self._audit_batches()
        self.finish()

    def _feed_all_input(self):
        """Launch N-1 workers, stream every batch, send poison pills, then
        convert the now-idle reader slot into one more worker."""
        worker_args = (
            self.input_queue,
            self.pipeline,
            self.summary_queue,
            self.timeout,
        )
        self.worker_processes = launch_workers(self.threads - 1, worker_args)
        self.num_batches = enqueue_all(
            self.command_runner.iterator(),
            self.input_queue,
            self.timeout,
            self.ensure_alive,
        )
        _log().debug("Main loop complete; saw %d batches", self.num_batches)
        enqueue_all(
            (None,) * self.threads,
            self.input_queue,
            self.timeout,
            self.ensure_alive,
        )
        self.worker_processes.extend(
            launch_workers(1, worker_args, offset=self.threads - 1)
        )

    def _await_summaries(self):
        def on_timeout():
            try:
                ensure_processes(
                    self.worker_processes,
                    "Workers are still alive and haven't returned summaries: {}",
                    alive=False,
                )
            except Exception as err:
                _log().error(err)

        wait_on(
            self.summary_queue.full,
            wait_message="Waiting on worker summaries {}",
            timeout=self.timeout,
            wait=True,
            timeout_callback=on_timeout,
        )

    def _reap_and_merge(self):
        self.seen_summaries = set()
        self.seen_batches = set()

        def on_missing():
            missing = set(range(1, self.threads)) - self.seen_summaries
            raise AtroposError(
                "Missing summaries from processes %s",
                ",".join(str(idx) for idx in missing),
            )

        for _ in range(1, self.threads + 1):
            entry = dequeue(self.summary_queue, fail_callback=on_missing)
            worker_index, worker_batches, worker_summary = entry
            if worker_summary is None:
                raise MulticoreError(
                    "Worker process {} died unexpectedly".format(worker_index)
                )
            if worker_summary.get("exception") is not None:
                raise AtroposError(
                    "Worker process {} died unexpectedly".format(worker_index),
                    worker_summary["exception"],
                )
            self.seen_summaries.add(worker_index)
            self.seen_batches |= worker_batches
            self.command_runner.summary.merge(worker_summary)

    def _audit_batches(self):
        if self.num_batches <= 0:
            return
        missing = set(range(1, self.num_batches + 1)) - self.seen_batches
        if missing:
            raise AtroposError(
                "Workers did not process batches {}".format(
                    ",".join(str(idx) for idx in sorted(missing))
                )
            )


# -- trim-specific plumbing -------------------------------------------------------


class QueueResultHandler:
    """Result handler that relays batches to the writer process's queue."""

    def __init__(self, queue):
        self.queue = queue
        self.message = None
        self.timeout = None

    def start(self, worker):
        self.message = "{} waiting to queue result {{}}".format(worker.name)
        self.timeout = worker.timeout

    def write_result(self, batch_num, result):
        enqueue(
            self.queue,
            (batch_num, result),
            wait_message=self.message,
            timeout=self.timeout,
        )

    def finish(self, total_batches=None):
        pass


class CompressingWorkerResultHandler:
    """Worker-side compression placement: join + compress result strings
    before they cross the queue (wins at >= 8 threads per the reference's
    benchmarks)."""

    def __init__(self, handler):
        self.handler = handler
        self.file_compressors = None

    def start(self, worker):
        self.handler.start(worker)
        self.file_compressors = {}

    def write_result(self, batch_num, result):
        self.handler.write_result(
            batch_num,
            dict(self.prepare_file(*item) for item in result.items()),
        )

    def prepare_file(self, path, strings):
        compressor = self.get_compressor(path)
        if compressor:
            payload = b"".join(s.encode() for s in strings)
            return ((path, "wb"), compressor.compress(payload))
        return ((path, "wt"), "".join(strings))

    def get_compressor(self, filename):
        from atropos_tpu_torch.io.compression import get_compressor

        if filename not in self.file_compressors:
            self.file_compressors[filename] = get_compressor(filename)
        return self.file_compressors[filename]

    def finish(self, total_batches=None):
        self.handler.finish(total_batches=total_batches)


class ResultProcess(Process):
    """The writer process: drains (batch_num, {path: data}) results.

    It learns the expected batch count late (over the Control value, once
    the reader finishes) and exits when everything arrived."""

    def __init__(self, result_handler, queue, control, timeout=60):
        super().__init__(name="Result process")
        self.result_handler = result_handler
        self.queue = queue
        self.control = control
        self.timeout = timeout
        self.seen_batches = set()
        self.num_batches = None

    def _check_done(self):
        if self.num_batches is None and self.control.check_value_positive():
            self.num_batches = self.control.get_value()
        if (
            self.num_batches is not None
            and len(self.seen_batches) >= self.num_batches
        ):
            raise Done()

    def _report_missing(self):
        if self.num_batches is None:
            return
        missing = set(range(1, self.num_batches + 1)) - self.seen_batches
        _log().error(
            "Result thread still missing batches %s of %d",
            ",".join(str(i) for i in missing),
            self.num_batches,
        )

    def run(self):
        _log().debug(
            "Writer process %s running under pid %d", self.name, os.getpid()
        )
        try:
            self.result_handler.start(self)
            while True:
                batch_num, result = dequeue(
                    self.queue,
                    wait_message="Result process waiting on result {}",
                    timeout=self.timeout,
                    fail_callback=self._check_done,
                    timeout_callback=self._report_missing,
                )
                self.seen_batches.add(batch_num)
                self.result_handler.write_result(batch_num, result)
        except Done:
            _log().debug("Writer process exiting normally")
        except Killed:
            _log().debug("Writer process exited early")
        except Exception:
            _log().error("Unexpected error in writer process", exc_info=True)
            self.control.set_value(CONTROL_ERROR)
        finally:
            total = self.control.get_value(lock=True)
            self.result_handler.finish(total if total > 0 else None)


class WriterManager:
    """Lifecycle owner of the writer process + its control channel."""

    def __init__(self, writers, compression, preserve_order, result_queue, timeout):
        from atropos_tpu_torch.commands.trim.pipeline import (
            OrderPreservingWriterResultHandler,
            WriterResultHandler,
        )

        handler_class = (
            OrderPreservingWriterResultHandler
            if preserve_order
            else WriterResultHandler
        )
        handler = handler_class(writers, compressed=compression == "worker")
        self.timeout = timeout
        self.writer_control = Control(CONTROL_ACTIVE)
        self.writer_process = ResultProcess(
            handler, result_queue, self.writer_control, timeout
        )
        self.writer_process.start()

    def is_active(self):
        return self.writer_process.is_alive() and self.writer_control.check_value(
            CONTROL_ACTIVE
        )

    def set_num_batches(self, num_batches):
        self.writer_control.set_value(num_batches)

    def wait(self):
        wait_on_process(self.writer_process, self.timeout)

    def terminate(self, retcode):
        kill(self.writer_process, retcode, self.timeout)


class ParallelTrimPipelineRunner(ParallelPipelineRunner):
    """Adds writer-process supervision to the generic runner."""

    def __init__(
        self,
        command_runner,
        pipeline,
        threads,
        writer_manager=None,
        queue_manager=None,
    ):
        super().__init__(command_runner, pipeline, threads)
        self.writer_manager = writer_manager
        self.queue_manager = queue_manager

    def ensure_alive(self):
        super().ensure_alive()
        if self.writer_manager and not self.writer_manager.is_active():
            raise MulticoreError("Writer process exited")

    def after_enqueue(self):
        if self.writer_manager:
            self.writer_manager.set_num_batches(self.num_batches)

    def finish(self):
        if self.writer_manager:
            self.writer_manager.wait()
        if self.queue_manager:
            self.queue_manager.shutdown()

    def terminate(self, retcode):
        super().terminate(retcode)
        if self.writer_manager:
            self.writer_manager.terminate(retcode)


def run_parallel_trim(command_runner, record_handler, writers):
    """Orchestrate parallel trimming (reference ``trim/__init__.py:692``):
    choose the compression placement, set up the writer process or
    parallel-write shards, and run the trim pipeline over workers."""

    from atropos_tpu_torch.commands.trim import (
        WorkerResultHandler,
        WriterResultHandler,
    )
    from atropos_tpu_torch.io.compression import can_use_system_compression

    options = command_runner.options
    timeout = max(command_runner.process_timeout, RETRY_INTERVAL)
    threads = command_runner.threads
    _log().debug(
        "Starting trim in parallel mode with threads=%d, timeout=%d",
        threads,
        timeout,
    )
    if threads < 2:
        raise ValueError("'threads' must be >= 2")

    # compression placement: system gzip in the writer process when
    # available and requested, else zlib in the workers
    compression = command_runner.compression
    if compression is None:
        if command_runner.writer_process and can_use_system_compression():
            compression = "writer"
        else:
            compression = "worker"
    if compression == "writer" and threads > 2:
        threads -= 1

    queue_manager = _MP.Manager()
    result_queue = queue_manager.Queue(options.result_queue_size)
    writer_manager = None

    if options.writer_process:
        relay = QueueResultHandler(result_queue)
        if compression == "writer":
            worker_result_handler = WorkerResultHandler(relay)
        else:
            worker_result_handler = CompressingWorkerResultHandler(relay)
        writer_manager = WriterManager(
            writers, compression, options.preserve_order, result_queue, timeout
        )
    else:
        worker_result_handler = WorkerResultHandler(
            WriterResultHandler(writers, use_suffix=True)
        )

    from atropos_tpu_torch.commands.trim.pipeline import (
        ParallelPairedEndTrimPipeline,
        ParallelSingleEndTrimPipeline,
    )

    pipeline_class = (
        ParallelPairedEndTrimPipeline
        if options.paired
        else ParallelSingleEndTrimPipeline
    )
    pipeline = pipeline_class(record_handler, worker_result_handler)
    runner = ParallelTrimPipelineRunner(
        command_runner, pipeline, threads, writer_manager, queue_manager
    )
    return runner.run()
