"""The 'error' command: estimate the empirical sequencing error rate.

Counterpart of ``atropos_tpu/commands/error/__init__.py``, with its two
estimators: ``quality`` converts base qualities to error probabilities
through a 256-entry lookup table and averages them on the host, one read
at a time into one Python float in record order, as there (a batched or
device sum would change the last bits of the estimate); ``shadow`` drives
the R ShadowRegression package through ``Rscript`` and fails as the
reference does where R is missing. The command has no device work; its
device is resolved all the same, as every command's is.
"""
import re
from collections import Counter

import numpy as np

from atropos_tpu_torch.commands.base import (
    BaseCommandRunner,
    PairedEndPipelineMixin,
    Pipeline,
    SingleEndPipelineMixin,
)
from atropos_tpu_torch.util import run_interruptible


class CommandRunner(BaseCommandRunner):
    name = "error"

    def __call__(self):
        if not self.delivers_qualities:
            raise ValueError("Cannot estimate error rate without base qualities")

        estimator_class = {
            "quality": BaseQualityErrorEstimator,
            "shadow": ShadowRegressionErrorEstimator,
        }[self.algorithm]

        estimator_args = dict(max_read_len=self.max_bases)
        if self.paired:
            estimator = PairedErrorEstimator(
                estimator_class=estimator_class, **estimator_args
            )
        else:
            estimator = estimator_class(**estimator_args)

        self.summary["errorrate"] = estimator_args
        self.summary.update(mode="serial", threads=1)
        return run_interruptible(estimator, self, raise_on_error=True)


class ErrorEstimator(SingleEndPipelineMixin, Pipeline):
    """Streams reads, accumulates, and produces (estimate, details)."""

    def __init__(self, max_read_len):
        super().__init__()
        self.total_len = 0
        self.max_read_len = max_read_len

    def _clip(self, text):
        """Truncate per --max-bases; returns (text, length)."""
        length = len(text)
        if self.max_read_len and self.max_read_len < length:
            length = self.max_read_len
            text = text[:length]
        return text, length

    def handle_reads(self, context, read1, read2=None):
        raise NotImplementedError()

    def estimate(self):
        raise NotImplementedError()

    def finish(self, summary, **kwargs):
        super().finish(summary)
        estimate, details = self.estimate()
        summary["errorrate"].update(
            estimate=(estimate,),
            total_len=(self.total_len,),
            details=(details,),
        )


# phred char -> error probability, for every possible byte
_PHRED_PROB = 10.0 ** (-(np.arange(256) - 33) / 10.0)


class BaseQualityErrorEstimator(ErrorEstimator):
    """Mean per-base error probability implied by the quality string.

    Known to overestimate the true error rate (qualities are calibrated
    pessimistically), but needs no second pass.
    """

    def __init__(self, max_read_len=None):
        super().__init__(max_read_len)
        self.total_qual = 0.0

    def handle_reads(self, context, read1, read2=None):
        quals, readlen = self._clip(read1.qualities)
        codes = np.frombuffer(quals.encode("ascii"), np.uint8)
        self.total_qual += float(_PHRED_PROB[codes].sum())
        self.total_len += readlen

    def estimate(self):
        return (self.total_qual / self.total_len, None)


#: reads that are homopolymer runs or contain any N are uninformative
FILTER_RE = re.compile("A+|C+|G+|T+|.*N.*")

_R_SCRIPT = """\
library(ShadowRegression)
errorRates = getErrorRates("{reads}", type="{method}")
write.table(errorRates$perReadER, "{per_read}", sep="\\t", quote=F, \
col.names=F, row.names=T)
write.table(errorRates$cycleER, "{per_cycle}", sep="\\t", quote=F, \
col.names=F, row.names=T)
"""


class ShadowRegressionErrorEstimator(ErrorEstimator):
    """Shadow-regression estimation (Wang et al. 2012) via Rscript.

    Exists for CLI parity with the reference; raises a clear error when
    R is not installed.
    """

    def __init__(self, method="sub", max_read_len=None, rscript_exe="Rscript"):
        super().__init__(max_read_len)
        self.seqs = Counter()
        self.method = method
        self.rscript_exe = rscript_exe

    def handle_reads(self, context, read1, read2=None):
        seq, readlen = self._clip(read1.sequence)
        if FILTER_RE.fullmatch(seq):
            return
        self.seqs[seq] += 1
        self.total_len += readlen

    def _run_rscript(self, read_counts, per_read, per_cycle, script_file):
        import subprocess

        from atropos_tpu_torch import AtroposError

        with open(script_file, "wt") as out:
            out.write(
                _R_SCRIPT.format(
                    reads=read_counts,
                    method=self.method,
                    per_read=per_read,
                    per_cycle=per_cycle,
                )
            )
        proc = subprocess.Popen(
            [self.rscript_exe, "--vanilla", script_file],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        with proc:
            stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise AtroposError(
                "R script failed: rc={}; stdout={}; stderr={}".format(
                    proc.returncode, stdout, stderr
                )
            )

    def estimate(self):
        import csv
        import os
        import tempfile

        from atropos_tpu_torch import AtroposError

        scratch = tuple(tempfile.mkstemp()[1] for _ in range(4))
        read_counts, per_read, per_cycle, script_file = scratch
        try:
            with open(read_counts, "wt") as out:
                csv.writer(out, delimiter=" ").writerows(
                    sorted(self.seqs.items(), reverse=True, key=lambda i: i[1])
                )
            self._run_rscript(read_counts, per_read, per_cycle, script_file)
            with open(per_read, "rt") as infile:
                per_read_error = dict(csv.reader(infile, delimiter="\t"))
            if len(per_read_error) != 4:
                raise AtroposError("Invalid output from R script")
            with open(per_cycle, "rt") as infile:
                per_cycle_error = [
                    row[0:3] for row in csv.reader(infile, delimiter="\t")
                ]
            if not per_cycle_error:
                raise AtroposError("Invalid output from R script")
            return (
                per_read_error["error rate"],
                dict(per_read=per_read_error, per_cycle=per_cycle_error),
            )
        finally:
            for path in scratch:
                os.remove(path)


class PairedErrorEstimator(PairedEndPipelineMixin, Pipeline):
    """Runs an independent estimator per mate."""

    def __init__(self, estimator_class=BaseQualityErrorEstimator, **kwargs):
        super().__init__()
        self.estimator1 = estimator_class(**kwargs)
        self.estimator2 = estimator_class(**kwargs)

    def handle_reads(self, context, read1, read2):
        self.estimator1.handle_reads(context, read1)
        self.estimator2.handle_reads(context, read2)

    def finish(self, summary, **kwargs):
        super().finish(summary)
        estimate1, details1 = self.estimator1.estimate()
        estimate2, details2 = self.estimator2.estimate()
        summary["errorrate"].update(
            estimate=(estimate1, estimate2),
            total_len=(self.estimator1.total_len, self.estimator2.total_len),
            details=(details1, details2),
        )
