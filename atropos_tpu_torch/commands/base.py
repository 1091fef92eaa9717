"""Shared command machinery: the batch loop, the summary tree, and the
record batcher every command runner is built on.

Records stream off a reader and are grouped into fixed-size batches (the
unit of work the batched engine encodes into arrays for the device, and
the unit the parallel modes ship between processes).
Summaries are merge-capable dict trees that collapse to plain data at the
end of a run. Counterpart of ``atropos_tpu/commands/base.py``: with more
than one rank (:mod:`atropos_tpu_torch.parallel.distributed`) each rank's
batcher yields only the batches it owns; ``--progress`` wraps the batch
iterator as there.
"""
import platform
import sys
from collections.abc import Sequence

from atropos_tpu_torch import AtroposError, NotPortedError, __version__
from atropos_tpu_torch.adapters import AdapterCache
from atropos_tpu_torch.io.seqio import open_reader, sra_reader
from atropos_tpu_torch.util import Const, MergingDict, Summarizable, Timing


class Pipeline:
    """Consumes record batches, tracking per-source record/bp tallies."""

    def __init__(self):
        self.record_counts = {}
        self.bp_counts = {}

    def __call__(self, command_runner, raise_on_error=False, **kwargs):
        self.start(**kwargs)
        try:
            for batch in command_runner.iterator():
                self.process_batch(batch)
        except Exception as err:
            if raise_on_error:
                raise
            command_runner.summary["exception"] = dict(
                message=str(err), details=sys.exc_info()
            )
        finally:
            self.finish(command_runner.summary, **kwargs)

    def start(self, **kwargs):
        pass

    def process_batch(self, batch):
        """Handle one ({metadata}, [records]) batch."""
        batch_meta, records = batch
        context = batch_meta.copy()
        source = context["source"]
        self.record_counts[source] = (
            self.record_counts.get(source, 0) + context["size"]
        )
        # per-source [read1_bp, read2_bp]; handlers mutate it in place
        context["bp"] = self.bp_counts.setdefault(source, [0, 0])
        self.add_to_context(context)
        self.handle_records(context, records)

    def add_to_context(self, context):
        pass

    def handle_records(self, context, records):
        for idx, record in enumerate(records):
            try:
                self.handle_record(context, record)
            except Exception as err:
                raise AtroposError(
                    "An error occurred at record {} of batch {}".format(
                        idx, context["index"]
                    )
                ) from err

    def handle_record(self, context, record):
        raise NotImplementedError()

    def handle_reads(self, context, read1, read2=None):
        raise NotImplementedError()

    def finish(self, summary, **kwargs):
        totals = tuple(sum(col) for col in zip(*self.bp_counts.values()))
        summary.update(
            record_counts=self.record_counts,
            total_record_count=sum(self.record_counts.values()),
            bp_counts=self.bp_counts,
            total_bp_counts=totals,
            sum_total_bp_count=sum(totals),
        )


class SingleEndPipelineMixin:
    def handle_record(self, context, record):
        context["bp"][0] += len(record)
        return self.handle_reads(context, record)


class PairedEndPipelineMixin:
    def handle_record(self, context, record):
        read1, read2 = record
        counts = context["bp"]
        counts[0] += len(read1.sequence)
        counts[1] += len(read2.sequence)
        return self.handle_reads(context, read1, read2)


class Summary(MergingDict):
    """The run's summary tree.

    While the run is live, nodes may be Summarizable/Const objects;
    ``finish`` walks the tree bottom-up replacing them with plain data so
    the result serializes cleanly.
    """

    @property
    def has_exception(self):
        return "exception" in self

    def finish(self):
        self._collapse(self)

    def _collapse(self, node):
        if node is None:
            return
        for key, value in tuple(node.items()):
            if value is None:
                continue
            if isinstance(value, Summarizable):
                node[key] = value = value.summarize()
            if isinstance(value, dict):
                self._collapse(value)
            elif isinstance(value, Sequence) and self._is_dict_list(value):
                for child in value:
                    self._collapse(child)
            else:
                if isinstance(value, Const):
                    node[key] = value = value.value
                self._post_process_other(node, key, value)

    @staticmethod
    def _is_dict_list(value):
        return len(value) > 0 and all(
            child is None or isinstance(child, dict) for child in value
        )

    def _post_process_other(self, parent, key, value):
        pass


class BaseCommandRunner:
    """Owns the reader + batcher + summary for one command invocation.

    Iterating the runner yields batches; attribute lookups fall through to
    the reader and then to the parsed options, so command code can write
    ``self.quality_base`` etc. without caring where the value lives.
    """

    def __init__(self, options, summary_class=Summary):
        self.options = options
        self.summary = summary_class()
        self.timing = Timing()
        self.return_code = None
        self.size = options.batch_size or 1000
        self.batches = 0
        self.done = False
        # multi-process sharding (atropos_tpu_torch.parallel.distributed):
        # with shard_count > 1 this rank only yields the batches it owns
        self.shard_rank = 0
        self.shard_count = 1
        self.reader = self._open_input(options)

        source = iter(self.reader)
        if options.subsample:
            source = self._subsampled(source, options.subsample,
                                      options.subsample_seed)
        self.iterable = enumerate(source, 1)
        self._batch_source = self._generate_batches()

        self._progress_options = None
        if options.progress:
            self._progress_options = (
                options.progress,
                self.size,
                self.max_reads,
                options.counter_magnitude,
            )

        self.init_summary()

    #: reader-constructor arguments copied verbatim from the options
    _READER_OPTIONS = ("quality_base", "colorspace", "input_read", "alphabet")

    @classmethod
    def _open_input(cls, options):
        common = {
            name: getattr(options, name) for name in cls._READER_OPTIONS
        }
        if getattr(options, "sra_reader", None):
            reader = sra_reader(reader=options.sra_reader, **common)
            options.sra_reader = None
            return reader
        interleaved = bool(options.interleaved_input)
        if interleaved:
            input1, input2, qualfile = options.interleaved_input, None, None
        elif options.paired:
            input1, input2, qualfile = options.input1, options.input2, None
        else:
            input1, input2, qualfile = options.input1, None, options.input2
        return open_reader(
            file1=input1,
            file2=input2,
            file_format=options.format,
            qualfile=qualfile,
            interleaved=interleaved,
            **common,
        )

    @staticmethod
    def _subsampled(source, fraction, seed):
        import random

        if seed:
            random.seed(seed)

        def gen():
            for record in source:
                if random.random() < fraction:
                    yield record

        return gen()

    def __getattr__(self, name):
        if hasattr(self.reader, name):
            return getattr(self.reader, name)
        if hasattr(self.options, name):
            return getattr(self.options, name)
        raise ValueError("Unknown attribute: {}".format(name))

    # -- batching ------------------------------------------------------------

    def iterator(self):
        """The batch iterator, progress-wrapped when requested."""
        if self._progress_options:
            from atropos_tpu_torch.io.progress import create_progress_reader

            wrapped = create_progress_reader(self, *self._progress_options)
            if wrapped is not None:
                return wrapped
        return self

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._batch_source)

    def _generate_batches(self):
        """Group records into (metadata, [records]) batches.

        The reader is finished (closed, summary collapsed) as soon as the
        input is exhausted or the --max-reads quota is reached — before
        the final partial batch is delivered. A mid-stream reader error
        finishes the reader and propagates, dropping the partial batch.
        """
        quota = None
        pending = []
        try:
            while True:
                try:
                    read_index, record = next(self.iterable)
                except StopIteration:
                    break
                if quota is None:
                    # max_reads may resolve via reader/options delegation,
                    # so sample it lazily (0 = unlimited)
                    quota = self.max_reads or 0
                pending.append(record)
                hit_quota = quota and read_index >= quota
                if len(pending) >= self.size or hit_quota:
                    if hit_quota:
                        self.finish()
                    batch = self._assemble(pending)
                    pending = []
                    if batch is not None:
                        yield batch
                    if hit_quota:
                        return
        except BaseException:
            self.finish()
            raise
        self.finish()
        if pending:
            batch = self._assemble(pending)
            if batch is not None:
                yield batch

    def _assemble(self, records):
        """Number the batch; None when another rank owns it."""
        self.batches += 1
        if self.shard_count > 1 and (
            (self.batches - 1) % self.shard_count != self.shard_rank
        ):
            return None
        meta = dict(index=self.batches, source=0, size=len(records))
        return (meta, list(records))

    # -- summary / lifecycle ---------------------------------------------------

    def init_summary(self):
        self.summary["program"] = "Atropos"
        self.summary["version"] = __version__
        self.summary["python"] = platform.python_version()
        self.summary["command"] = self.name
        # the device is reported beside the options, so the options
        # section equals that of an atropos_tpu run of the same argv
        options = self.options.__dict__.copy()
        self.summary["device"] = options.pop("device", None)
        self.summary["options"] = options
        self.summary["timing"] = self.timing
        self.summary["sample_id"] = self.options.sample_id
        self.summary["input"] = self.reader.summarize()
        self.summary["input"].update(
            batch_size=self.size, max_reads=self.max_reads, batches=self.batches
        )

    def run(self):
        """Execute the command under timing; returns (retcode, summary)."""
        with self.timing:
            try:
                self.return_code = self()
            except NotPortedError:
                raise
            except Exception as err:  # pylint: disable=broad-except
                self.summary["exception"] = dict(
                    message=str(err), details=sys.exc_info()
                )
                self.return_code = 1
            finally:
                self.finish()
        return (self.return_code, self.summary)

    def __call__(self):
        raise NotImplementedError()

    def finish(self):
        if not self.done:
            self.done = True
            self.reader.close()
        self.summary.finish()

    def load_known_adapters(self):
        """Build the adapter-name cache per the run's options."""
        cache_file = (
            self.options.adapter_cache_file
            if self.options.cache_adapters
            else None
        )
        cache = AdapterCache(cache_file)
        if cache.empty and self.options.default_adapters:
            cache.load_default()
        for spec in self.options.known_adapter or ():
            name, seq = spec.split("=")
            cache.add(name, seq)
        for url in self.options.known_adapters_file or ():
            cache.load_from_url(url)
        if self.options.cache_adapters:
            cache.save()
        return cache
