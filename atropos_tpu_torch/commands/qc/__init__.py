"""The 'qc' command: FastQC-style read statistics.

Counterpart of ``atropos_tpu/commands/qc/__init__.py``. Three routes, as
there:

- **native** (summary ``mode`` "turbo"): the native runtime parses chunks
  of FASTQ/FASTA files, gathers padded byte matrices and hands them to
  :meth:`~atropos_tpu_torch.commands.stats.ReadStatistics.collect_matrices`,
  no record objects anywhere;
- **serial**: the record pipeline for what the native route declines
  (colorspace, SRA, ``--subsample``, interleaved input, per-tile tables,
  streams), a batch of records at a time;
- **parallel** (``--threads``): the record pipeline in spawned workers
  (:mod:`atropos_tpu_torch.commands.multicore`), whose summaries merge.

On all three, the per-position byte counts run on the run's device
(:func:`~atropos_tpu_torch.commands.stats.position_byte_counts`); a
worker gets the device as its string.
"""
import numpy as np

from atropos_tpu_torch.commands.base import (
    BaseCommandRunner,
    PairedEndPipelineMixin,
    Pipeline,
    SingleEndPipelineMixin,
)
from atropos_tpu_torch.commands.multicore import ParallelPipelineMixin
from atropos_tpu_torch.commands.stats import (
    PairedEndReadStatistics,
    SingleEndReadStatistics,
)
from atropos_tpu_torch.util import run_interruptible


class QcPipeline(Pipeline):
    """Statistics-collection pipeline; one accumulator per input source."""

    statistics_class = None

    def __init__(self, **kwargs):
        super().__init__()
        self.stats = {}
        self.stats_kwargs = kwargs

    def _get_stats(self, source):
        if source not in self.stats:
            self.stats[source] = self.statistics_class(**self.stats_kwargs)
        return self.stats[source]

    def handle_records(self, context, records):
        """Count the batch's bases per record, then collect its statistics
        in one batch."""
        for record in records:
            self.handle_record(context, record)
        self._get_stats(context["source"]).collect_batch(records)

    def handle_reads(self, context, read1, read2=None):
        # statistics are collected a batch at a time in handle_records
        pass

    def finish(self, summary, **kwargs):
        super().finish(summary)
        summary["pre"] = {
            source: stats.summarize() for source, stats in self.stats.items()
        }


class SingleEndQcPipeline(SingleEndPipelineMixin, QcPipeline):
    statistics_class = SingleEndReadStatistics


class PairedEndQcPipeline(PairedEndPipelineMixin, QcPipeline):
    statistics_class = PairedEndReadStatistics


class ParallelSingleEndQcPipeline(ParallelPipelineMixin, SingleEndQcPipeline):
    """Module-level (spawned workers pickle pipelines by qualified name)."""


class ParallelPairedEndQcPipeline(ParallelPipelineMixin, PairedEndQcPipeline):
    """Module-level (spawned workers pickle pipelines by qualified name)."""


def _gather(chunk, sub, offsets):
    """The padded ``[n, W]`` uint8 matrix of one field (sequences or
    qualities at ``offsets``) of the records ``sub`` of a parsed chunk,
    and their lengths."""
    from atropos_tpu_torch import runtime

    offs = np.ascontiguousarray(offsets[sub], np.int64)
    lens = np.ascontiguousarray(chunk.seq_len[sub], np.int32)
    width = max(1, int(lens.max(initial=0)))
    out = np.zeros((offs.shape[0], width), np.uint8)
    runtime.lib().gather_padded(
        runtime._u8(chunk.buf), runtime._i64(offs), runtime._i32(lens),
        offs.shape[0], width, runtime._u8(out),
    )
    return out, lens


def _collect(chunk, sub, part, fmt):
    """Collect the records ``sub`` of a chunk into one statistics part."""
    seqs, lens = _gather(chunk, sub, chunk.seq_off)
    quals = None
    if fmt == "fastq":
        quals, _ = _gather(chunk, sub, chunk.qual_off)
    part.collect_matrices(seqs, quals, lens)


class CommandRunner(BaseCommandRunner):
    name = "qc"

    #: records a statistics call takes at most
    SLICE_RECORDS = 65536

    def __call__(self):
        pipeline_class = (
            PairedEndQcPipeline if self.paired else SingleEndQcPipeline
        )
        pipeline_args = dict(
            qualities=self.delivers_qualities, quality_base=self.quality_base
        )
        if self.stats:
            pipeline_args.update(self.stats)
        pipeline_args["device"] = self.options.device

        if self.threads is None:
            retcode = self._run_native(pipeline_args)
            if retcode is not None:
                return retcode
            self.summary.update(mode="serial", threads=1)
            return run_interruptible(pipeline_class(**pipeline_args), self)
        self.summary.update(mode="parallel", threads=self.threads)
        return self._run_parallel(pipeline_class, pipeline_args)

    def _run_native(self, pipeline_args):
        """The native-chunk route: parse chunks with the native runtime and
        feed ``collect_matrices`` from gathered byte matrices. Returns the
        exit code, or None when the configuration needs the record
        pipeline (inputs that are not FASTQ/FASTA paths, colorspace, SRA,
        subsampling, per-tile statistics, interleaved input)."""
        options = self.options
        if (
            options.colorspace
            or getattr(options, "sra_reader", None)
            or options.subsample
            or options.interleaved_input
            or pipeline_args.get("tiles")
        ):
            return None
        from atropos_tpu_torch.commands.cli import int_or_str
        from atropos_tpu_torch.engine.turbo import _TurboRunnerBase

        fmt1 = _TurboRunnerBase._stream_format(options.input1, options.format)
        if fmt1 is None:
            return None
        fmt2 = None
        if self.paired:
            fmt2 = _TurboRunnerBase._stream_format(
                options.input2, options.format
            )
            if fmt2 is None:
                return None

        quota = int_or_str(options.max_reads) or None
        stats_class = (
            PairedEndReadStatistics if self.paired else SingleEndReadStatistics
        )
        stats = stats_class(**pipeline_args)
        if self.paired:
            total, bp_counts = self._consume_paired(
                options, fmt1, fmt2, stats, quota
            )
        else:
            total, bp1 = self._consume(options.input1, fmt1, stats, quota)
            bp_counts = (bp1, 0)
        self._finish_native(total, bp_counts, stats)
        return 0

    @staticmethod
    def _open_stream(path, fmt):
        from atropos_tpu_torch.engine.turbo import (
            _ChunkStream,
            _PrefetchStream,
            _TurboRunnerBase,
        )

        return _PrefetchStream(
            _ChunkStream(path, _TurboRunnerBase.CHUNK_BYTES, fmt),
            _TurboRunnerBase.PREFETCH,
        )

    def _consume(self, path, fmt, part, quota):
        """Stream one file into one statistics part; (records, bp)."""
        stream = self._open_stream(path, fmt)
        total = 0
        bp = 0
        try:
            while True:
                chunk = stream.next_chunk()
                if chunk is None:
                    break
                avail = chunk.n
                if quota is not None:
                    avail = min(avail, quota - total)
                    if avail <= 0:
                        break
                for start in range(0, avail, self.SLICE_RECORDS):
                    sub = slice(start, min(start + self.SLICE_RECORDS, avail))
                    _collect(chunk, sub, part, fmt)
                total += avail
                bp += int(chunk.seq_len[:avail].sum())
        finally:
            stream.close()
        return total, bp

    def _consume_paired(self, options, fmt1, fmt2, stats, quota):
        """Both mate files in lockstep, with the pair-name validation of
        the record reader."""
        from atropos_tpu_torch.engine.turbo import validate_pair_names
        from atropos_tpu_torch.io.seqio import FormatError

        s1 = self._open_stream(options.input1, fmt1)
        s2 = self._open_stream(options.input2, fmt2)
        total = 0
        bp1 = bp2 = 0
        cur1 = cur2 = None
        pos1 = pos2 = 0
        try:
            while True:
                if quota is not None and total >= quota:
                    break
                if cur1 is None or pos1 == cur1.n:
                    cur1 = s1.next_chunk()
                    pos1 = 0
                if cur2 is None or pos2 == cur2.n:
                    cur2 = s2.next_chunk()
                    pos2 = 0
                if cur1 is None or cur2 is None:
                    if (cur1 is None) != (cur2 is None):
                        more, less = (2, 1) if cur1 is None else (1, 2)
                        raise FormatError(
                            "Reads are improperly paired. There are more "
                            "reads in file {0} than in file {1}.".format(
                                more, less
                            )
                        )
                    break
                take = min(cur1.n - pos1, cur2.n - pos2, self.SLICE_RECORDS)
                if quota is not None:
                    take = min(take, quota - total)
                sub1 = slice(pos1, pos1 + take)
                sub2 = slice(pos2, pos2 + take)
                validate_pair_names(cur1, sub1, cur2, sub2)
                _collect(cur1, sub1, stats.read1, fmt1)
                _collect(cur2, sub2, stats.read2, fmt2)
                bp1 += int(cur1.seq_len[sub1].sum())
                bp2 += int(cur2.seq_len[sub2].sum())
                pos1 += take
                pos2 += take
                total += take
        finally:
            s1.close()
            s2.close()
        return total, (bp1, bp2)

    def _finish_native(self, total, bp_counts, stats):
        self.summary.update(mode="turbo", threads=1)
        if total:
            self.summary.update(
                record_counts={0: total},
                total_record_count=total,
                bp_counts={0: list(bp_counts)},
                total_bp_counts=tuple(bp_counts),
                sum_total_bp_count=sum(bp_counts),
            )
        else:
            self.summary.update(
                record_counts={},
                total_record_count=0,
                bp_counts={},
                total_bp_counts=(),
                sum_total_bp_count=0,
            )
        self.summary["pre"] = {0: stats.summarize()}
        return 0

    def _run_parallel(self, pipeline_class, pipeline_args):
        """Spawn worker processes, each running the same pipeline over its
        share of batches; summaries (count tables add) merge at the end."""
        import logging

        from atropos_tpu_torch.commands.multicore import ParallelPipelineRunner

        parallel_class = (
            ParallelPairedEndQcPipeline
            if pipeline_class is PairedEndQcPipeline
            else ParallelSingleEndQcPipeline
        )
        runner = ParallelPipelineRunner(self, parallel_class(**pipeline_args))
        logging.getLogger().debug(
            "Starting atropos qc in parallel mode with threads=%d, timeout=%d",
            runner.threads,
            runner.timeout,
        )
        return runner.run()
