"""Pair-level modifiers: the insert-match adapter cutter and the mate
overwrite.

Counterparts of ``InsertAdapterCutter`` and ``OverwriteRead`` of
``atropos_tpu/commands/trim/modifiers/paired.py`` (reference
``atropos/commands/trim/modifiers.py:359-563``). The turbo paired runner
carries out their flows over whole batches — for the insert cutter
(:class:`~atropos_tpu_torch.engine.turbo._InsertPair`) the insert match,
fallback independent adapter matches, symmetric-match duplication and
per-mate trim; for the overwrite (``TurboPairedRunner._compute_overwrite``
and ``_overwrite_post``) the window-quality test and the swap — and these
objects hold the stages' parameters and report them. Overlap error
correction (``--correct-mismatches``), the other pair modifiers
(``--merge-overlapping``, ``--bisulfite swift``) and the per-pair scalar
path are not part of this package.
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


class OverwriteRead(ReadPairModifier):
    """``-w``: replace a mate whose leading-window quality is poor with the
    reverse complement of its good partner (ref ``modifiers.py:511-563``).
    A pair is tested when both mates are at least ``window_size`` long: the
    mean quality of a mate's first ``window_size`` bases below
    ``worse_read_min_quality`` while its partner's reaches
    ``better_read_min_quality`` replaces it (mate 1 is tested first)."""

    def __init__(
        self,
        worse_read_min_quality,
        better_read_min_quality,
        window_size,
        base=33,
    ):
        self.worse_read_min_quality = worse_read_min_quality
        self.better_read_min_quality = better_read_min_quality
        self.window_size = window_size
        self.base = base
