"""The 'trim' command: adapter/quality trimming.

The stack is assembled by :mod:`~atropos_tpu_torch.commands.trim.builder`
and executed by a turbo runner (:mod:`atropos_tpu_torch.engine.turbo`):
streaming native parse -> one device step per batch -> native format, for
interval-expressible configurations, single-end (``TurboTrimRunner``) or
paired-end with either aligner (``TurboPairedRunner``). Counterpart of
``atropos_tpu/commands/trim/__init__.py``; the engine, serial, parallel
and multi-host modes of that module are not part of this package and
raise :class:`~atropos_tpu_torch.NotPortedError`.
"""
import logging
import textwrap

from atropos_tpu_torch import NotPortedError
from atropos_tpu_torch.commands.base import BaseCommandRunner
from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder
from atropos_tpu_torch.commands.trim.pipeline import (  # noqa: F401
    RecordHandler,
    TrimSummary,
)


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
    path outside the ported turbo slices. Runs before the input is
    opened, so nothing is read or written for such a request."""
    if options.colorspace:
        raise NotPortedError("colorspace trimming", "engine")
    if options.threads is not None:
        raise NotPortedError("--threads", "multi-gpu")
    if options.stats:
        raise NotPortedError("--stats", "side-files")
    if options.info_file or options.rest_file or options.wildcard_file:
        raise NotPortedError(
            "info/rest/wildcard side files", "side-files"
        )
    if options.output and "{name}" in str(options.output):
        raise NotPortedError("demultiplexed output", "side-files")
    if options.overwrite_low_quality:
        raise NotPortedError("-w (overwrite low quality)", "side-files")


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

        from atropos_tpu_torch.engine.turbo import (
            TurboPairedRunner,
            TurboTrimRunner,
        )

        # build() returns the runner or raises NotPortedError with the
        # reason the turbo runner of atropos_tpu would decline for
        runner_class = TurboPairedRunner if options.paired else TurboTrimRunner
        turbo = runner_class.build(
            self, record_handler, writers, device=options.device
        )
        self.summary.update(mode="turbo", threads=1)
        return turbo.run()
