"""The 'trim' command: adapter/quality trimming.

The stack is assembled by :mod:`~atropos_tpu_torch.commands.trim.builder`
and executed by one of three modes (counterpart of
``atropos_tpu/commands/trim/__init__.py``):

- **turbo**: streaming native parse -> one device step per batch ->
  native format, for interval-expressible configurations, single-end
  (``TurboTrimRunner``) or paired-end with either aligner
  (``TurboPairedRunner``) (:mod:`atropos_tpu_torch.engine.turbo`);
- **serial**: every configuration the turbo runner declines, through the
  per-record pipeline (:mod:`atropos_tpu_torch.commands.trim.pipeline`)
  with whole-batch adapter matching on the run's device
  (:class:`~atropos_tpu_torch.engine.TrimEngine`) where the engine takes
  the configuration, and fully per record where it declines too
  (colorspace; ``--stats``, whose tables the reference collects per
  record), as in the reference;
- **parallel**: spawned worker shards (``--threads``,
  :mod:`atropos_tpu_torch.commands.multicore`), the per-record pipeline
  without an engine in each worker, as in the reference.

Under an initialized ``torch.distributed`` process group of more than
one rank, the turbo and serial modes shard chunks or batches round-robin
across the ranks, write per-rank output shard files, and merge the
summaries into one report, which rank 0 writes
(:mod:`atropos_tpu_torch.parallel.distributed`); the mode is then
"distributed".
"""
import logging
import textwrap

from atropos_tpu_torch.commands.base import BaseCommandRunner
from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder
from atropos_tpu_torch.commands.trim.pipeline import (  # noqa: F401
    PairedEndTrimPipeline,
    RecordHandler,
    SingleEndTrimPipeline,
    StatsRecordHandlerWrapper,
    TrimSummary,
    WorkerResultHandler,
    WriterResultHandler,
)
from atropos_tpu_torch.util import run_interruptible


_PAIRING_LABEL = {
    False: "single-end",
    "first": "paired-end legacy",
    "both": "paired-end",
}

_LEGACY_MODE_WARNING = (
    "Requested read modifications are applied only to the first read since "
    "backwards compatibility mode is enabled. To modify both reads, also "
    "use any of the -A/-B/-G/-U options. Use a dummy adapter sequence when "
    "necessary: -A XXX"
)


class CommandRunner(BaseCommandRunner):
    name = "trim"

    def __init__(self, options):
        super().__init__(options, TrimSummary)

    def __call__(self):
        options = self.options
        logger = logging.getLogger()

        modifiers, filters, formatters, writers = TrimStackBuilder(self).build()
        record_handler = RecordHandler(modifiers, filters, formatters)
        if options.stats:
            # the statistics' position counts run where the run runs; the
            # device goes as its string, which a spawned worker resolves
            record_handler = StatsRecordHandlerWrapper(
                record_handler,
                options.paired,
                options.stats,
                qualities=self.delivers_qualities,
                quality_base=self.quality_base,
                device=options.device,
            )

        self._log_configuration(logger, modifiers)
        engine = self._build_engine(logger, modifiers, record_handler)
        distributed = self._configure_distributed(logger, writers)

        if options.threads is not None:
            self.summary.update(mode="parallel", threads=options.threads)
            return self.run_parallel(record_handler, writers)

        retcode = self._run_single_process(
            record_handler, writers, engine, distributed
        )
        if distributed:
            self._merge_distributed_summaries()
        return retcode

    # -- setup helpers ---------------------------------------------------------

    def _log_configuration(self, logger, modifiers):
        options = self.options
        num_adapters = sum(len(a) for a in modifiers.get_adapters())
        logger.info(
            "Trimming %s adapter%s with at most %.1f%% errors in %s mode ...",
            num_adapters,
            "s" if num_adapters > 1 else "",
            options.error_rate * 100,
            _PAIRING_LABEL[options.paired],
        )
        if options.paired == "first" and (
            modifiers.get_modifiers(read=2) or options.quality_cutoff
        ):
            logger.warning("\n".join(textwrap.wrap(_LEGACY_MODE_WARNING)))

    def _build_engine(self, logger, modifiers, record_handler):
        """The batched engine on the run's device, when eligible."""
        if not isinstance(record_handler, RecordHandler):
            return None
        from atropos_tpu_torch import engine as engine_mod

        engine = engine_mod.TrimEngine.build(modifiers, self.options)
        if engine is not None:
            logger.info("Using batched device engine for adapter matching")
        else:
            logger.info(
                "Scalar pipeline (engine ineligible: %s)",
                engine_mod.LAST_FALLBACK_REASON,
            )
        return engine

    def _configure_distributed(self, logger, writers):
        """Set up the per-rank sharding when a process group of more than
        one rank is initialized."""
        from atropos_tpu_torch.parallel.distributed import (
            log_topology,
            process_info,
        )

        rank, world = process_info()
        if world <= 1:
            return False
        log_topology(self.options.device)
        if self.options.threads is not None:
            logger.warning(
                "Multi-host mode runs one pipeline per host; ignoring --threads"
            )
            self.options.threads = None
        self.shard_rank = rank
        self.shard_count = world
        writers.suffix = ".{}".format(rank)
        if rank != 0:
            self.options.report_file = None
        return True

    # -- execution modes ---------------------------------------------------------

    def _run_single_process(self, record_handler, writers, engine, distributed):
        from atropos_tpu_torch.engine.turbo import (
            TurboPairedRunner,
            TurboTrimRunner,
        )

        options = self.options
        mode_suffix = "distributed" if distributed else None
        runner_class = TurboPairedRunner if options.paired else TurboTrimRunner
        turbo = runner_class.build(
            self, record_handler, writers, device=options.device
        )
        if turbo is not None:
            self.summary.update(mode=mode_suffix or "turbo", threads=1)
            return turbo.run()

        pipeline_class = (
            PairedEndTrimPipeline if options.paired else SingleEndTrimPipeline
        )
        pipeline = pipeline_class(
            record_handler,
            WorkerResultHandler(WriterResultHandler(writers)),
            engine=engine,
        )
        self.summary.update(mode=mode_suffix or "serial", threads=1)
        return run_interruptible(pipeline, self, raise_on_error=True)

    def _merge_distributed_summaries(self):
        from atropos_tpu_torch.parallel.distributed import (
            LOCAL_SUMMARY_KEYS,
            barrier,
            merge_summaries,
        )

        local = {key: self.summary.get(key) for key in LOCAL_SUMMARY_KEYS}
        merged = merge_summaries(dict(self.summary))
        self.summary.clear()
        self.summary.update(merged)
        self.summary.update(local)
        barrier("atropos-trim-finish")

    def run_parallel(self, record_handler, writers):
        """Spawned worker-shard mode (``--threads``)."""
        from atropos_tpu_torch.commands.multicore import run_parallel_trim

        return run_parallel_trim(self, record_handler, writers)
