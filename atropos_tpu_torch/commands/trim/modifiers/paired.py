"""Pair-level modifiers: the insert-match adapter cutter.

Counterpart of ``InsertAdapterCutter`` of
``atropos_tpu/commands/trim/modifiers/paired.py`` (reference
``atropos/commands/trim/modifiers.py:359-509``). The turbo paired runner
(:class:`~atropos_tpu_torch.engine.turbo._InsertPair`) carries out its flow
over whole batches — insert match, fallback independent adapter matches,
symmetric-match duplication, per-mate trim — and accumulates the
statistics into this object, which holds the stage's parameters and
reports them. Overlap error correction (``--correct-mismatches``), the
other pair modifiers (``-w``, ``--merge-overlapping``, ``--bisulfite
swift``) and the per-pair scalar path are not part of this package.
"""
from atropos_tpu_torch import NotPortedError
from atropos_tpu_torch.align import InsertAligner
from atropos_tpu_torch.commands.trim.modifiers.base import ReadPairModifier


class InsertAdapterCutter(ReadPairModifier):
    """Paired 3' adapter removal driven by insert-overlap matching."""

    def __init__(
        self,
        adapter1,
        adapter2,
        action="trim",
        mismatch_action=None,
        symmetric=True,
        min_insert_overlap=1,
        **aligner_args,
    ):
        if mismatch_action is not None:
            raise NotPortedError(
                "--correct-mismatches with the insert aligner", "insert-correct"
            )
        self.mismatch_action = None
        self.adapter1 = adapter1
        self.adapter2 = adapter2
        self.aligner = InsertAligner(
            adapter1.sequence,
            adapter2.sequence,
            min_insert_overlap=min_insert_overlap,
            **aligner_args,
        )
        self.min_insert_len = min_insert_overlap
        self.action = action
        self.symmetric = symmetric
        self.with_adapters = [0, 0]

    def summarize(self):
        return dict(
            records_with_adapters=self.with_adapters,
            adapters=tuple(
                {adapter.name: adapter.summarize()}
                for adapter in (self.adapter1, self.adapter2)
            ),
        )
