"""The adapter-removal modifier.

Matching semantics per the reference (``atropos/commands/trim/
modifiers.py:91-195``): up to ``times`` rounds, each round picking the
adapter with the most matching bases. The batched device engine
(:mod:`atropos_tpu_torch.engine`) precomputes round-one matches for whole
batches and injects them via ``first_match``, so the scalar search here
only runs for later rounds and engine-ineligible adapters.
"""
from collections import OrderedDict

from atropos_tpu_torch.commands.trim.modifiers.base import Modifier

#: distinguishes "no injected match" from "injected None (no match)"
_NO_INJECTION = object()


class AdapterCutter(Modifier):
    """Find + remove the best adapter, ``times`` rounds; actions:
    ``trim`` (remove), ``mask`` (overwrite with N), ``None`` (tag only)."""

    def __init__(self, adapters=None, times=1, action="trim"):
        super().__init__()
        self.adapters = adapters or []
        self.times = times
        self.action = action
        self.with_adapters = 0

    def _best_match(self, read):
        """The match with the most matching bases over all adapters."""
        winner = None
        for adapter in self.adapters:
            found = adapter.match_to(read)
            if found and (winner is None or found.matches > winner.matches):
                winner = found
        return winner

    def _match_rounds(self, read, first_match):
        """Iteratively match+trim; returns (matches, final read)."""
        matches = []
        current = read
        for round_index in range(self.times):
            if round_index == 0 and first_match is not _NO_INJECTION:
                found = first_match
            else:
                found = self._best_match(current)
            if found is None:
                break
            matches.append(found)
            current = found.adapter.trimmed(found)
        return matches, current

    @staticmethod
    def _mask_adapters(trimmed_read, matches):
        """Re-expand the trimmed read to full length, with every
        adapter-matched base replaced by N (qualities restored)."""
        masked = trimmed_read.sequence
        for match in sorted(matches, reverse=True, key=lambda m: m.astart):
            pad = "N" * (
                len(match.read.sequence)
                - len(match.adapter.trimmed(match).sequence)
            )
            masked = (pad + masked) if match.front else (masked + pad)
        trimmed_read.sequence = masked
        trimmed_read.qualities = matches[0].read.qualities

    def __call__(self, read, first_match=_NO_INJECTION, injected_rounds=None):
        """``injected_rounds`` lets the batched engine supply the ENTIRE
        (matches, final_read) state of :meth:`_match_rounds`, computed
        with batched kernels over whole batches — including rounds 2+
        of ``--times`` and linked-adapter front/back passes."""
        if len(read) == 0:
            return read

        if injected_rounds is not None:
            matches, trimmed_read = injected_rounds
            matches = list(matches)
        else:
            matches, trimmed_read = self._match_rounds(read, first_match)
        if not matches:
            trimmed_read.match = None
            trimmed_read.match_info = None
            return trimmed_read

        assert len(trimmed_read) < len(read), (
            "Trimmed read isn't shorter than original"
        )

        if self.action == "mask":
            self._mask_adapters(trimmed_read, matches)
            assert len(trimmed_read.sequence) == len(read)
        elif self.action is None:
            trimmed_read = read
        # action == "trim": the match rounds already removed the bases

        trimmed_read.match = matches[-1]
        trimmed_read.match_info = [m.get_info_record() for m in matches]
        self.with_adapters += 1
        return trimmed_read

    def summarize(self):
        per_adapter = OrderedDict(
            (adapter.name, adapter.summarize()) for adapter in self.adapters
        )
        return dict(
            records_with_adapters=self.with_adapters, adapters=per_adapter
        )
