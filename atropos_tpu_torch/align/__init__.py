"""Alignment layer: flags, match records and the insert aligner's parameters.

The scalar kernels live in :mod:`atropos_tpu_torch.align.oracle` (the executable
spec), the batched plain PyTorch DP in :mod:`atropos_tpu_torch.align.batched`
and the CUDA kernels in :mod:`atropos_tpu_torch.align.cuda_kernel`. This
package re-exports the scalar API under the same names the rest of the
framework uses, mirroring the reference layering
(``atropos/align/__init__.py``). The paired-end :class:`InsertAligner`
holds the insert matcher's parameters and its random-match probability;
the turbo paired runner does the matching itself, over whole batches
(:class:`~atropos_tpu_torch.engine.turbo._InsertPair`), and the per-record
pipeline decides per pair in :meth:`InsertAligner.match_insert` from the
candidates the batched engine computed on the device.
"""
from collections import namedtuple

from atropos_tpu_torch.align.flags import (  # noqa: F401
    SEMIGLOBAL,
    START_WITHIN_SEQ1,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
)
from atropos_tpu_torch.align.oracle import (  # noqa: F401
    Aligner,
    MultiAligner,
    compare_prefixes,
    compare_suffixes,
    locate,
)
from atropos_tpu_torch.util import RandomMatchProbability, reverse_complement


class Match:
    """An alignment match binding coordinates to an adapter and read.

    Coordinates: ``(astart, astop)`` within the adapter, ``(rstart, rstop)``
    within the read; ``matches``/``errors`` counted over the aligned region.
    Field semantics match the reference (``atropos/align/__init__.py:51``).
    """

    __slots__ = [
        "astart",
        "astop",
        "rstart",
        "rstop",
        "matches",
        "errors",
        "front",
        "adapter",
        "read",
        "length",
    ]

    def __init__(
        self,
        astart,
        astop,
        rstart,
        rstop,
        matches,
        errors,
        front=None,
        adapter=None,
        read=None,
    ):
        self.astart = astart
        self.astop = astop
        self.rstart = rstart
        self.rstop = rstop
        self.matches = matches
        self.errors = errors
        self.front = self._guess_is_front() if front is None else front
        self.adapter = adapter
        self.read = read
        self.length = self.astop - self.astart
        if self.length <= 0:
            raise ValueError("Match length must be >= 0")
        if self.length - self.errors <= 0:
            raise ValueError("A Match requires at least one matching position.")

    def __repr__(self):
        return (
            "Match(astart={0}, astop={1}, rstart={2}, rstop={3}, matches={4}, "
            "errors={5})"
        ).format(
            self.astart, self.astop, self.rstart, self.rstop, self.matches,
            self.errors,
        )

    def copy(self):
        return Match(
            self.astart,
            self.astop,
            self.rstart,
            self.rstop,
            self.matches,
            self.errors,
            self.front,
            self.adapter,
            self.read,
        )

    def _guess_is_front(self):
        return self.rstart == 0

    def wildcards(self, wildcard_char="N"):
        """Characters of the read matched by wildcard positions in the
        adapter (unreliable in the presence of indels)."""
        wildcards = [
            self.read.sequence[self.rstart + i]
            for i in range(self.length)
            if (
                self.adapter.sequence[self.astart + i] == wildcard_char
                and self.rstart + i < len(self.read.sequence)
            )
        ]
        return "".join(wildcards)

    def rest(self):
        """Portion of the read before a front match / after a back match."""
        if self.front:
            return self.read.sequence[: self.rstart]
        return self.read.sequence[self.rstop :]

    def get_info_record(self):
        """MatchInfo for ``--info-file`` output."""
        seq = self.read.sequence
        qualities = self.read.qualities
        if qualities is None:
            qualities = ""
        rsize = rsize_total = self.rstop - self.rstart
        if self.front and self.rstart > 0:
            rsize_total = self.rstop
        elif not self.front and self.rstop < len(seq):
            rsize_total = len(seq) - self.rstart
        return MatchInfo(
            self.read.name,
            self.errors,
            self.rstart,
            self.rstop,
            seq[0 : self.rstart],
            seq[self.rstart : self.rstop],
            seq[self.rstop :],
            self.adapter.name,
            qualities[0 : self.rstart],
            qualities[self.rstart : self.rstop],
            qualities[self.rstop :],
            self.front,
            self.astop - self.astart,
            rsize,
            rsize_total,
        )


MatchInfo = namedtuple(
    "MatchInfo",
    (
        "read_name",
        "errors",
        "rstart",
        "rstop",
        "seq_before",
        "seq_adapter",
        "seq_after",
        "adapter_name",
        "qual_before",
        "qual_adapter",
        "qual_after",
        "is_front",
        "asize",
        "rsize_adapter",
        "rsize_total",
    ),
)


class InsertAligner:
    """The paired-end insert matcher.

    Counterpart of ``atropos_tpu/align/__init__.py::InsertAligner``. Read1
    is aligned against reverse-complemented read2 for a whole batch on the
    device (the diagonal-count kernels of
    :mod:`atropos_tpu_torch.align.insert_kernel`). The turbo paired runner
    makes every decision of :meth:`match_insert` vectorized on the host
    from these parameters; the per-record pipeline calls
    :meth:`match_insert` per pair with the batch's candidates, or, where
    the reference runs it without its batched engine (colorspace,
    ``--stats``), with the scalar :class:`MultiAligner`, as the reference
    does. All use the same thresholds, the same order and the same float64
    random-match probability (:class:`RandomMatchProbability`).
    """

    def __init__(
        self,
        adapter1,
        adapter2,
        match_probability=None,
        insert_max_rmp=1e-6,
        adapter_max_rmp=0.001,
        min_insert_overlap=1,
        max_insert_mismatch_frac=0.2,
        min_adapter_overlap=1,
        max_adapter_mismatch_frac=0.2,
        adapter_check_cutoff=9,
        base_probs=None,
        adapter_wildcards=True,
        read_wildcards=False,
    ):
        self.adapter1 = adapter1
        self.adapter1_len = len(adapter1)
        self.adapter2 = adapter2
        self.adapter2_len = len(adapter2)
        self.match_probability = match_probability or RandomMatchProbability()
        self.insert_max_rmp = insert_max_rmp
        self.adapter_max_rmp = adapter_max_rmp
        self.min_insert_overlap = min_insert_overlap
        self.max_insert_mismatch_frac = float(max_insert_mismatch_frac)
        self.min_adapter_overlap = min_adapter_overlap
        self.max_adapter_mismatch_frac = float(max_adapter_mismatch_frac)
        self.adapter_check_cutoff = adapter_check_cutoff
        self.base_probs = base_probs or dict(match_prob=0.25, mismatch_prob=0.75)
        self.adapter_wildcards = adapter_wildcards
        self.read_wildcards = read_wildcards
        self.aligner = MultiAligner(
            max_insert_mismatch_frac,
            START_WITHIN_SEQ1 | STOP_WITHIN_SEQ2,
            min_insert_overlap,
        )

    def match_insert(self, seq1, seq2, precomputed_matches=False):
        """Try to find the insert overlap between a read pair.

        Returns ``(insert_match, adapter_match1, adapter_match2)`` where the
        adapter matches may be None (overlap too short to verify adapters),
        or None if there is no insert match at all.

        ``precomputed_matches`` carries the candidate alignments of the pair
        that :class:`~atropos_tpu_torch.align.batched.BatchInsertMatcher`
        computed for the batch (``None`` meaning "computed, no
        candidates"); ``False`` (the default) runs the scalar aligner.
        """
        seq_len1 = len(seq1)
        seq_len2 = len(seq2)
        seq_len = min(seq_len1, seq_len2)
        if seq_len1 > seq_len2:
            seq1 = seq1[:seq_len2]
        elif seq_len2 > seq_len1:
            seq2 = seq2[:seq_len1]

        def _match(_insert_match, _offset, _insert_match_size, _):
            if _offset < self.min_adapter_overlap:
                # Overhang too short for a confident adapter match; return
                # the insert match alone (error correction is still valid).
                return (_insert_match, None, None)

            def _adapter_match(insert_seq, adapter_seq, adapter_len):
                amatch = compare_prefixes(
                    insert_seq[_insert_match_size:],
                    adapter_seq,
                    wildcard_ref=self.adapter_wildcards,
                    wildcard_query=self.read_wildcards,
                )
                alen = min(_offset, adapter_len)
                return amatch, alen, round(alen * self.max_adapter_mismatch_frac)

            a1_match, a1_length, a1_max_mismatches = _adapter_match(
                seq1, self.adapter1, self.adapter1_len
            )
            a2_match, a2_length, a2_max_mismatches = _adapter_match(
                seq2, self.adapter2, self.adapter2_len
            )

            if a1_match[5] > a1_max_mismatches and a2_match[5] > a2_max_mismatches:
                return None

            if min(a1_length, a2_length) > self.adapter_check_cutoff:
                a1_prob = self.match_probability(a1_match[4], a1_length)
                a2_prob = self.match_probability(a2_match[4], a2_length)
                if (a1_prob * a2_prob) > self.adapter_max_rmp:
                    return None

            mismatches = min(a1_match[5], a2_match[5])

            def _create_match(alen, slen):
                alen = min(alen, slen - _insert_match_size)
                _mismatches = min(alen, mismatches)
                _matches = alen - _mismatches
                return Match(0, alen, _insert_match_size, slen, _matches, _mismatches)

            return (
                _insert_match,
                _create_match(a1_length, seq_len1),
                _create_match(a2_length, seq_len2),
            )

        if precomputed_matches is False:
            insert_matches = self.aligner.locate(reverse_complement(seq2), seq1)
        else:
            insert_matches = precomputed_matches
        if insert_matches:
            filtered_matches = []
            for insert_match in insert_matches:
                offset = min(insert_match[0], seq_len - insert_match[3])
                insert_match_size = seq_len - offset
                prob = self.match_probability(
                    insert_match[4], insert_match_size, **self.base_probs
                )
                if prob <= self.insert_max_rmp:
                    filtered_matches.append(
                        (insert_match, offset, insert_match_size, prob)
                    )

            if filtered_matches:
                if len(filtered_matches) == 1:
                    return _match(*filtered_matches[0])
                # Try candidates in order of random-match probability.
                filtered_matches.sort(key=lambda x: x[3])
                for match_args in filtered_matches:
                    match = _match(*match_args)
                    if match:
                        return match

        return None
