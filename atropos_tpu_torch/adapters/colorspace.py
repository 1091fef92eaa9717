"""SOLiD colorspace adapter matching.

Colorspace encodes transitions between bases, so trimming an adapter
changes the color at each cut boundary: a 5' trim must re-encode the
first remaining color against the primer base, and a 3' trim removes one
extra color (the transition into the adapter). Behavior parity with the
reference (``atropos/adapters/__init__.py:507-611``); counterpart of
``atropos_tpu/adapters/colorspace.py``. Colorspace reads are matched on
the host by the scalar :class:`~atropos_tpu_torch.align.Aligner`, as in
the reference: the batched engine and the turbo runners decline them.
"""
from atropos_tpu_torch.adapters.model import Adapter, FRONT, PREFIX
from atropos_tpu_torch.align import Match
from atropos_tpu_torch.util import colorspace as cs


class ColorspaceAdapter(Adapter):
    """Adapter matched against color-encoded reads."""

    def __init__(self, *args, **kwargs):
        if kwargs.get("adapter_wildcards", False):
            raise ValueError("Wildcards not supported for colorspace adapters")
        kwargs["adapter_wildcards"] = False
        super().__init__(*args, **kwargs)

        given_in_nucleotide_space = set(self.sequence) <= set("ACGT")
        if given_in_nucleotide_space:
            self.nucleotide_sequence = self.sequence
            # color-encode; the first color depends on the preceding base,
            # which is unknown here, so it is dropped
            self.sequence = cs.encode(self.sequence)[1:]
        if self.where in (PREFIX, FRONT) and not given_in_nucleotide_space:
            raise ValueError(
                "A 5' colorspace adapter needs to be given in nucleotide space"
            )
        self.aligner.reference = self.sequence

    def __repr__(self):
        return "<ColorspaceAdapter(sequence={0!r}, where={1})>".format(
            self.sequence, self.where
        )

    def _prefix_query(self, read):
        """The anchored-5' search pattern for this read: the color of the
        primer->adapter transition, then the adapter colors."""
        transition = cs.ENCODE[read.primer + self.nucleotide_sequence[0:1]]
        return transition + self.sequence

    def match_to(self, read):
        if self.where != PREFIX:
            return super().match_to(read)

        pattern = self._prefix_query(read)
        if read.sequence.startswith(pattern):
            size = len(pattern)
            match = Match(
                0, size, 0, size, size, 0, self._front_flag, self, read
            )
        else:
            self.aligner.reference = pattern
            alignment = self.aligner.locate(read.sequence)
            if self.debug:
                print(self.aligner.dpmatrix)  # pragma: no cover
            if alignment is None:
                return None
            match = Match(*(alignment + (self._front_flag, self, read)))

        assert match.length > 0
        assert match.errors / match.length <= self.max_error_rate
        assert match.length >= self.min_overlap
        return match

    def _trimmed_front(self, match):
        read = match.read
        self.lengths_front[match.rstop] += 1
        self.errors_front[match.rstop][match.errors] += 1

        boundary_color = read.sequence[match.rstop : match.rstop + 1]
        if not boundary_color:
            return read[match.rstop :]
        # the color after the adapter encoded (last_adapter_base -> X);
        # recover X, then re-encode the transition as (primer -> X)
        next_base = cs.DECODE[self.nucleotide_sequence[-1:] + boundary_color]
        trimmed = read[:]
        trimmed.sequence = (
            cs.ENCODE[read.primer + next_base]
            + read.sequence[match.rstop + 1 :]
        )
        trimmed.qualities = (
            read.qualities[match.rstop :] if read.qualities else None
        )
        return trimmed

    def _trimmed_back(self, match):
        # also drop the color encoding the transition into the adapter
        cut = max(match.rstart - 1, 0)
        removed = len(match.read) - cut
        self.lengths_back[removed] += 1
        self.errors_back[removed][match.errors] += 1
        return match.read[:cut]
