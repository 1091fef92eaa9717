"""Trim-pipeline execution machinery.

The turbo runner (:mod:`atropos_tpu_torch.engine.turbo`) routes whole
batches as interval arithmetic; what it needs from here is the holder of
the modifier/filter/formatter stacks, whose ``summarize`` feeds the
report, the ``--stats`` wrapper that holds the pre- and post-trim
statistics tables the runner fills from its batch matrices, and the
summary class that derives the fraction/total fields.

The configurations the turbo runner declines, and the workers of
``--threads``, run through the pipeline here: a batch flows through the
modifier chain (whole-batch through the batched engine,
:class:`~atropos_tpu_torch.engine.TrimEngine`, or per record where the
engine declines too, and always in a ``--threads`` worker) -> filter
routing -> formatting into a per-batch ``{path: [str]}`` result dict ->
a ResultHandler that delivers it (write directly, or enqueue toward a
writer process in parallel mode). Counterpart of
``atropos_tpu/commands/trim/pipeline.py``.
"""
from collections import defaultdict
from collections.abc import Sequence

from atropos_tpu_torch.commands.multicore import (
    MulticoreError,
    ParallelPipelineMixin,
    PendingQueue,
)
from atropos_tpu_torch.commands.base import (
    PairedEndPipelineMixin,
    Pipeline,
    SingleEndPipelineMixin,
    Summary,
)
from atropos_tpu_torch.commands.stats import (
    PairedEndReadStatistics,
    SingleEndReadStatistics,
)


class RecordHandler:
    """One record (pair) through modify -> filter -> format."""

    def __init__(self, modifiers, filters, formatters):
        self.modifiers = modifiers
        self.filters = filters
        self.formatters = formatters

    def handle_record(self, context, read1, read2=None):
        reads = self.modifiers.modify(read1, read2)
        dest = self.filters.filter(*reads)
        self.formatters.format(context["results"], dest, *reads)
        return (dest, reads)

    def finish_batch(self):
        pass

    def summarize(self):
        return dict(
            trim=dict(
                modifiers=self.modifiers.summarize(),
                filters=self.filters.summarize(),
                formatters=self.formatters.summarize(),
            )
        )


class StatsRecordHandlerWrapper:
    """Pre- and/or post-trim statistics around a handler.

    Post-trim statistics are kept per destination filter, so reports can
    show the composition of kept vs discarded reads separately. The turbo
    runner fills the tables (``pre`` and ``post``: source -> statistics,
    ``post`` under each destination filter) from its batch matrices; the
    per-record pipeline through :meth:`handle_record`, which notes each
    record's bytes where the reference collects them, and
    :meth:`finish_batch`, which counts a batch's records into each table
    at once (the position counts run on the statistics' device, one call
    a table and batch). ``kwargs`` go to every statistics object
    (``qualities``, ``quality_base``, ``device``), each side's options
    from ``stats_args`` beside them.
    """

    def __init__(self, record_handler, paired, stats_args, **kwargs):
        self.record_handler = record_handler
        self.read_statistics_class = (
            PairedEndReadStatistics if paired else SingleEndReadStatistics
        )
        self.pre = self.post = None
        if "pre" in stats_args:
            self.pre = {}
            self.pre_kwargs = dict(kwargs, **stats_args["pre"])
        if "post" in stats_args:
            self.post = {}
            self.post_kwargs = dict(kwargs, **stats_args["post"])
        #: statistics object -> the records noted for it in this batch
        self._pending = {}

    def _note(self, table, kwargs, source, read1, read2=None):
        if source not in table:
            table[source] = self.read_statistics_class(**kwargs)
        record = (read1.name, read1.sequence, read1.qualities)
        if read2 is not None:
            record = (record, (read2.name, read2.sequence, read2.qualities))
        self._pending.setdefault(table[source], []).append(record)

    def handle_record(self, context, read1, read2=None):
        source = context["source"]
        if self.pre is not None:
            self._note(self.pre, self.pre_kwargs, source, read1, read2)
        dest, reads = self.record_handler.handle_record(context, read1, read2)
        if self.post is not None:
            table = self.post.setdefault(dest, {})
            self._note(table, self.post_kwargs, source, *reads)
        return (dest, reads)

    def finish_batch(self):
        """Count the records noted in this batch into their tables."""
        pending, self._pending = self._pending, {}
        for stats, records in pending.items():
            stats.collect_records(records)

    def summarize(self):
        summary = self.record_handler.summarize()
        if self.pre is not None:
            summary["pre"] = {
                source: stats.summarize()
                for source, stats in self.pre.items()
            }
        if self.post is not None:
            # route filters without a short name (Trimmed/Untrimmed) fall
            # back to the class name, mirroring FilterWrapper.name
            summary["post"] = {
                getattr(dest, "name", dest.__name__): {
                    source: stats.summarize()
                    for source, stats in table.items()
                }
                for dest, table in self.post.items()
            }
        return summary


#: records (pairs) the pipeline ran through the modifier chain one at a
#: time, without a batched engine: the reference's own route for colorspace
#: and for ``--stats`` on a configuration the turbo runner declines
PER_RECORD_COUNTS = {"records": 0}


# -- result delivery -------------------------------------------------------------


class ResultHandler:
    """Sink for per-batch result dicts."""

    def start(self, worker=None):
        pass

    def finish(self, total_batches=None):
        pass

    def write_result(self, batch_num, result):
        raise NotImplementedError()


class ResultHandlerWrapper(ResultHandler):
    def __init__(self, handler):
        self.handler = handler

    def start(self, worker):
        self.handler.start(worker)

    def write_result(self, batch_num, result):
        self.handler.write_result(batch_num, result)

    def finish(self, total_batches=None):
        self.handler.finish(total_batches=total_batches)


class WorkerResultHandler(ResultHandlerWrapper):
    """Joins each output's strings into one blob before forwarding
    (subclasses add compression here in parallel-worker mode)."""

    def write_result(self, batch_num, result):
        self.handler.write_result(
            batch_num,
            dict(self.prepare_file(*item) for item in result.items()),
        )

    def prepare_file(self, path, strings):
        return (path, "".join(strings))


class WriterResultHandler(ResultHandler):
    """Terminal handler: hands results to a Writers object."""

    def __init__(self, writers, compressed=False, use_suffix=False):
        self.writers = writers
        self.compressed = compressed
        self.use_suffix = use_suffix

    def start(self, worker=None):
        if self.use_suffix:
            if worker is None:
                raise ValueError("worker must not be None")
            self.writers.suffix = ".{}".format(worker.index)

    def write_result(self, batch_num, result):
        self.writers.write_result(result, self.compressed)

    def finish(self, total_batches=None):
        self.writers.close()


# -- the pipeline -----------------------------------------------------------------


class TrimPipeline(Pipeline):
    """Record batches through the trim stack.

    With an attached engine, the whole batch's modifier chain runs through
    batched matching on the run's device (:mod:`atropos_tpu_torch.engine`);
    filter routing and formatting are identical either way.
    """

    def __init__(self, record_handler, result_handler, engine=None):
        super().__init__()
        self.record_handler = record_handler
        self.result_handler = result_handler
        self.engine = engine

    def start(self, worker=None):
        self.result_handler.start(worker)

    def add_to_context(self, context):
        context["results"] = defaultdict(list)

    def handle_records(self, context, records):
        if self.engine is None:
            super().handle_records(context, records)
            PER_RECORD_COUNTS["records"] += context["size"]
        else:
            self._handle_batch_on_engine(context, records)
        self.record_handler.finish_batch()
        self.result_handler.write_result(context["index"], context["results"])

    def _handle_batch_on_engine(self, context, records):
        handler = self.record_handler
        paired = isinstance(self, PairedEndPipelineMixin)
        bp = context["bp"]
        if paired:
            pairs = list(records)
            for read1, read2 in pairs:
                bp[0] += len(read1.sequence)
                bp[1] += len(read2.sequence)
        else:
            pairs = [(record, None) for record in records]
            for record in records:
                bp[0] += len(record)
        for read1, read2 in self.engine.modify_batch(pairs):
            reads = (read1, read2) if paired else (read1,)
            dest = handler.filters.filter(*reads)
            handler.formatters.format(context["results"], dest, *reads)

    def handle_reads(self, context, read1, read2=None):
        return self.record_handler.handle_record(context, read1, read2)

    def finish(self, summary, **kwargs):
        self.result_handler.finish()
        super().finish(summary)
        summary.update(self.record_handler.summarize())


class SingleEndTrimPipeline(SingleEndPipelineMixin, TrimPipeline):
    pass


class PairedEndTrimPipeline(PairedEndPipelineMixin, TrimPipeline):
    pass


class TrimSummary(Summary):
    """Summary that derives fraction_*/total_* fields for count stats."""

    @staticmethod
    def _ratio(part, whole):
        return (part / whole) if part and whole != 0 else 0

    def _post_process_other(self, node, key, value):
        if self.has_exception or not isinstance(key, str):
            return
        if key.startswith("records_"):
            whole = self["total_record_count"]
            if isinstance(value, Sequence):
                node["fraction_" + key] = [
                    self._ratio(item, whole) for item in value
                ]
                node["total_" + key] = sum(item for item in value if item)
            else:
                node["fraction_" + key] = self._ratio(value, whole)
        elif key.startswith("bp_"):
            whole = self["sum_total_bp_count"]
            if isinstance(value, Sequence):
                node["fraction_" + key] = [
                    self._ratio(item, per_read)
                    for item, per_read in zip(value, self["total_bp_counts"])
                ]
                total = sum(item for item in value if item)
                node["total_" + key] = total
                node["fraction_total_" + key] = self._ratio(total, whole)
            else:
                node["fraction_" + key] = self._ratio(value, whole)


class ParallelSingleEndTrimPipeline(ParallelPipelineMixin, SingleEndTrimPipeline):
    """Module-level (spawned workers pickle pipelines by qualified name)."""


class ParallelPairedEndTrimPipeline(ParallelPipelineMixin, PairedEndTrimPipeline):
    """Module-level (spawned workers pickle pipelines by qualified name)."""


class OrderPreservingWriterResultHandler(WriterResultHandler):
    """Buffers out-of-order batches, flushing in input order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pending = None
        self.cur_batch = None

    def start(self, worker=None):
        super().start(worker)
        self.pending = PendingQueue()
        self.cur_batch = 1

    def write_result(self, batch_num, result):
        if batch_num != self.cur_batch:
            self.pending.push(batch_num, result)
            return
        self.writers.write_result(result, self.compressed)
        self.cur_batch += 1
        self.consume_pending()

    def consume_pending(self):
        while not self.pending.empty and (
            self.cur_batch == self.pending.min_priority
        ):
            self.writers.write_result(self.pending.pop(), self.compressed)
            self.cur_batch += 1

    def finish(self, total_batches=None):
        if total_batches is not None:
            self.consume_pending()
            if self.cur_batch != total_batches + 1:
                raise MulticoreError(
                    "OrderPreservingWriterResultHandler finishing "
                    "without having seen {} of {} batches".format(
                        total_batches + 1 - self.cur_batch, total_batches
                    )
                )
        super().finish(total_batches=total_batches)
