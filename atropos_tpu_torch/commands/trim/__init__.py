"""The 'trim' command: adapter/quality trimming.

The stack is assembled by :mod:`~atropos_tpu_torch.commands.trim.builder`
and executed by one of two modes (counterpart of
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
  record), as in the reference.

The parallel (``--threads``) and multi-host modes of that module raise
:class:`~atropos_tpu_torch.NotPortedError`.
"""
import logging
import textwrap

from atropos_tpu_torch import NotPortedError, resolve_device
from atropos_tpu_torch.commands.base import BaseCommandRunner
from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder
from atropos_tpu_torch.commands.trim.pipeline import (  # noqa: F401
    PairedEndTrimPipeline,
    RecordHandler,
    SingleEndTrimPipeline,
    StatsRecordHandlerWrapper,
    TrimSummary,
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


def check_ported(options):
    """Raise :class:`NotPortedError` for every option that selects a
    path outside the ported slices. Runs before the input is opened, so
    nothing is read or written for such a request."""
    if options.threads is not None:
        raise NotPortedError("--threads", "multi-gpu")


class CommandRunner(BaseCommandRunner):
    name = "trim"

    def __init__(self, options):
        check_ported(options)
        super().__init__(options, TrimSummary)

    def __call__(self):
        options = self.options
        logger = logging.getLogger()

        modifiers, filters, formatters, writers = TrimStackBuilder(self).build()
        record_handler = RecordHandler(modifiers, filters, formatters)
        if options.stats:
            # the statistics' position counts run where the run runs
            record_handler = StatsRecordHandlerWrapper(
                record_handler,
                options.paired,
                options.stats,
                qualities=self.delivers_qualities,
                quality_base=self.quality_base,
                device=resolve_device(options.device),
            )

        self._log_configuration(logger, modifiers)
        engine = self._build_engine(logger, modifiers, record_handler)
        return self._run_single_process(record_handler, writers, engine)

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

    # -- execution modes ---------------------------------------------------------

    def _run_single_process(self, record_handler, writers, engine):
        from atropos_tpu_torch.engine.turbo import (
            TurboPairedRunner,
            TurboTrimRunner,
        )

        options = self.options
        runner_class = TurboPairedRunner if options.paired else TurboTrimRunner
        turbo = runner_class.build(
            self, record_handler, writers, device=options.device
        )
        if turbo is not None:
            self.summary.update(mode="turbo", threads=1)
            return turbo.run()

        pipeline_class = (
            PairedEndTrimPipeline if options.paired else SingleEndTrimPipeline
        )
        pipeline = pipeline_class(
            record_handler, WriterResultHandler(writers), engine=engine
        )
        self.summary.update(mode="serial", threads=1)
        return run_interruptible(pipeline, self, raise_on_error=True)
