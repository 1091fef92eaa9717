"""Pair-level modifiers: overlap error correction, insert-match adapter
cutting, read overwriting, pair merging, and the Swift bisulfite cutter.

Counterparts of ``atropos_tpu/commands/trim/modifiers/paired.py``. The
per-record pipeline (:mod:`atropos_tpu_torch.commands.trim.pipeline`)
calls them per pair; the turbo paired runner carries out the flows of
``InsertAdapterCutter`` (:class:`~atropos_tpu_torch.engine.turbo._InsertPair`)
and ``OverwriteRead`` (``TurboPairedRunner._compute_overwrite`` and
``_overwrite_post``) over whole batches and reads only their parameters
and statistics from these objects. ``--merge-overlapping`` aligns each
pair with the scalar :class:`~atropos_tpu_torch.align.Aligner`, as the
reference does.

Error correction here is vectorized over numpy byte arrays (the scalar
reference walks the overlap base by base,
``atropos/commands/trim/modifiers.py:201-357``); every decision rule and
tie-break reproduces the reference bit for bit, including its
odd-but-shipped behaviors (see inline notes). It serves
``--merge-overlapping`` and ``--correct-mismatches`` with either aligner.
"""
import numpy as np

from atropos_tpu_torch import AtroposError
from atropos_tpu_torch.align import (
    Aligner,
    InsertAligner,
    SEMIGLOBAL,
    START_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
)
from atropos_tpu_torch.commands.trim.modifiers.base import ReadPairModifier
from atropos_tpu_torch.commands.trim.modifiers.single import MinCutter
from atropos_tpu_torch.util import (
    BASE_COMPLEMENTS,
    mean,
    quals2ints,
    reverse_complement,
)

# byte-indexed complement table (identity for bytes outside the IUPAC set)
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _base, _comp in BASE_COMPLEMENTS.items():
    _COMP_LUT[ord(_base)] = ord(_comp)
_N = ord("N")


def _bytes_of(text):
    return np.frombuffer(text.encode("ascii"), np.uint8).copy()


class ErrorCorrectorMixin:
    """Resolves mismatches in a read pair's overlap.

    Actions: ``N`` masks both sides; ``conservative`` overwrites the
    lower-quality base when the quality gap is at least
    ``min_qual_difference``; ``liberal`` additionally breaks exact-quality
    ties using the mean quality of each read's overlap region.
    """

    def __init__(self, mismatch_action=None, min_qual_difference=1):
        self.mismatch_action = mismatch_action
        self.r1r2_min_qual_difference = min_qual_difference
        self.r2r1_min_qual_difference = -min_qual_difference
        self.corrected_pairs = 0
        self.corrected_bp = [0, 0]

    def correct_errors(self, read1, read2, insert_match, truncate_seqs=False):
        if read1.corrected > 0 or read2.corrected > 0:
            return

        has_quals = bool(read1.qualities and read2.qualities)
        if not has_quals and self.mismatch_action in ("liberal", "conservative"):
            raise ValueError(
                "Cannot perform quality-based error correction on reads "
                "lacking quality information"
            )

        seq1 = _bytes_of(read1.sequence)
        seq2 = _bytes_of(read2.sequence)
        len1 = seq1.shape[0]
        len2 = seq2.shape[0]
        qual1 = _bytes_of(read1.qualities) if has_quals else None
        qual2 = _bytes_of(read2.qualities) if has_quals else None

        if truncate_seqs:
            # NOTE (reference parity, modifiers.py:250-260): only the
            # read2 truncation updates the tracked length; a truncated
            # read1 keeps seq_len=len1 and therefore loses its tail in
            # the write-back below. Shipped behavior, kept bit-exact.
            if len1 > len2:
                seq1 = seq1[:len2]
                if has_quals:
                    qual1 = qual1[:len2]
            elif len2 > len1:
                seq2 = seq2[:len1]
                if has_quals:
                    qual2 = qual2[:len1]
                len2 = len1

        r1_start, r1_end = insert_match[2], insert_match[3]
        r2_start = len2 - insert_match[1]
        r2_end = len2 - insert_match[0]

        # overlap index maps: position k pairs r1[i[k]] with rc(r2)[.],
        # i.e. r2[j[k]] running backwards
        idx1 = np.arange(r1_start, r1_end)
        idx2 = np.arange(r2_end - 1, r2_start - 1, -1)
        span = min(idx1.shape[0], idx2.shape[0])
        idx1, idx2 = idx1[:span], idx2[:span]

        base1 = seq1[idx1].copy()
        base2 = _COMP_LUT[seq2[idx2]]  # complement = rc-space base
        mismatch = base1 != base2

        r1_changed = r2_changed = 0
        deferred = np.zeros(span, bool)

        if self.mismatch_action == "N":
            hits = idx1[mismatch], idx2[mismatch]
            seq1[hits[0]] = _N
            seq2[hits[1]] = _N
            r1_changed = r2_changed = int(mismatch.sum())
        else:
            fix1 = mismatch & (base1 == _N)  # r1 has the N: copy from r2
            fix2 = mismatch & ~fix1 & (base2 == _N)  # r2 has the N
            rest = mismatch & ~fix1 & ~fix2
            if has_quals:
                qdiff = (
                    qual1[idx1].astype(np.int32)
                    - qual2[idx2].astype(np.int32)
                )
                take1 = rest & (qdiff >= self.r1r2_min_qual_difference)
                take2 = rest & (qdiff <= self.r2r1_min_qual_difference)
                fix2 |= take1  # r1 base wins -> overwrite r2
                fix1 |= take2  # r2 base wins -> overwrite r1
                if self.mismatch_action == "liberal":
                    deferred = rest & ~take1 & ~take2

            if fix1.any():
                pos1 = idx1[fix1]
                seq1[pos1] = base2[fix1]
                if has_quals:
                    qual1[pos1] = qual2[idx2[fix1]]
                r1_changed = int(fix1.sum())
            if fix2.any():
                pos2 = idx2[fix2]
                seq2[pos2] = _COMP_LUT[base1[fix2]]
                if has_quals:
                    qual2[pos2] = qual1[idx1[fix2]]
                r2_changed = int(fix2.sum())

            if deferred.any():
                # tie-break by the mean quality of each overlap region,
                # computed AFTER the per-base corrections above (the
                # reference evaluates it mid-stream with the same state)
                window1 = qual1[r1_start:r1_end]
                window2 = qual2[r2_start:r2_end]
                mean1 = int(window1.sum()) / window1.shape[0]
                mean2 = int(window2.sum()) / window2.shape[0]
                gap = mean1 - mean2
                if gap > 1:
                    pos2 = idx2[deferred]
                    seq2[pos2] = _COMP_LUT[base1[deferred]]
                    qual2[pos2] = qual1[idx1[deferred]]
                    r2_changed += int(deferred.sum())
                elif gap < -1:
                    pos1 = idx1[deferred]
                    seq1[pos1] = base2[deferred]
                    qual1[pos1] = qual2[idx2[deferred]]
                    r1_changed += int(deferred.sum())

        if not (r1_changed or r2_changed):
            return
        self.corrected_pairs += 1
        if r1_changed:
            self._write_back(
                read1, seq1, qual1, len1, 0, r1_changed, truncate_seqs, has_quals
            )
        if r2_changed:
            self._write_back(
                read2, seq2, qual2, len2, 1, r2_changed, truncate_seqs, has_quals
            )

    def _write_back(
        self, read, seq, qual, seq_len, mate, changed, truncate_seqs, has_quals
    ):
        self.corrected_bp[mate] += changed
        read.corrected = changed
        body = seq.tobytes().decode("ascii")
        keep_tail = truncate_seqs and len(read.sequence) > seq_len
        read.sequence = body + read.sequence[seq_len:] if keep_tail else body
        if has_quals:
            qbody = qual.tobytes().decode("ascii")
            read.qualities = (
                qbody + read.qualities[seq_len:] if keep_tail else qbody
            )

    def summarize(self):
        return dict(
            records_corrected=self.corrected_pairs,
            bp_corrected=self.corrected_bp,
        )


class InsertAdapterCutter(ReadPairModifier, ErrorCorrectorMixin):
    """Paired 3' adapter removal driven by insert-overlap matching
    (ref ``modifiers.py:359-509``).

    Flow per pair: insert match (from the ``insert_candidates`` the
    batched engine computed on the device, or the scalar aligner where
    the pipeline runs without the engine) -> fallback independent adapter
    matches ->
    optional symmetric-match duplication when only one side matched ->
    optional error correction -> per-read trim.
    """

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
        ErrorCorrectorMixin.__init__(self, mismatch_action)
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

    @staticmethod
    def _mirror_match(match, read_len):
        """Project one mate's match onto the other mate (symmetric-match
        duplication): same read-relative start, extended to the read end."""
        if match.rstart > read_len:
            return None
        mirrored = match.copy()
        if mirrored.rstop < read_len:
            mirrored.astop -= read_len - mirrored.rstop
            mirrored.rstop = read_len
        return mirrored

    @staticmethod
    def _overlap_frame(rstart, len2):
        """Insert-match coordinate tuple implied by a 3' adapter starting
        at ``rstart`` in both mates."""
        return (len2 - rstart, len2, 0, rstart)

    def __call__(self, read1, read2, insert_candidates=False):
        len1, len2 = len(read1), len(read2)
        if min(len1, len2) < self.min_insert_len:
            return (read1, read2)

        result = self.aligner.match_insert(
            read1.sequence,
            read2.sequence,
            insert_candidates,
        )
        read1.insert_overlap = read2.insert_overlap = result is not None

        insert_match = None
        correct = False
        if result:
            insert_match, match1, match2 = result
            correct = self.mismatch_action is not None and insert_match[5] > 0
        else:
            match1 = self.adapter1.match_to(read1)
            match2 = self.adapter2.match_to(read2)
            if (
                self.mismatch_action
                and match1
                and match2
                and match1.rstart == match2.rstart
            ):
                insert_match = self._overlap_frame(match1.rstart, len2)
                correct = True

        if self.symmetric and bool(match1) != bool(match2):
            if match1:
                match2 = self._mirror_match(match1, len2)
            else:
                match1 = self._mirror_match(match2, len1)
            if self.mismatch_action and not insert_match and match1 and match2:
                insert_match = self._overlap_frame(match1.rstart, len2)
                correct = True

        if correct:
            self.correct_errors(read1, read2, insert_match, truncate_seqs=True)

        return (
            self._trim_mate(read1, self.adapter1, match1, 0),
            self._trim_mate(read2, self.adapter2, match2, 1),
        )

    def _trim_mate(self, read, adapter, match, mate):
        if not match:
            read.match = None
            read.match_info = None
            return read

        match.adapter = adapter
        match.read = read
        match.front = False

        if self.action is None or match.rstart >= len(read):
            trimmed = read
        else:
            trimmed = adapter.trimmed(match)
            if self.action == "mask":
                trimmed.sequence += "N" * (len(read) - len(trimmed))
                trimmed.qualities = read.qualities
            # action == "lower" keeps the trimmed read as-is

        trimmed.match = match
        trimmed.match_info = [match.get_info_record()]
        self.with_adapters[mate] += 1
        return trimmed

    def summarize(self):
        summary = dict(
            records_with_adapters=self.with_adapters,
            adapters=tuple(
                {adapter.name: adapter.summarize()}
                for adapter in (self.adapter1, self.adapter2)
            ),
        )
        if self.mismatch_action:
            summary.update(ErrorCorrectorMixin.summarize(self))
        return summary


class OverwriteRead(ReadPairModifier):
    """``-w``: replace a mate whose leading-window quality is poor with the
    reverse complement of its good partner (ref ``modifiers.py:511-563``)."""

    def __init__(
        self,
        worse_read_min_quality,
        better_read_min_quality,
        window_size,
        base=33,
        summary_fn=mean,
    ):
        self.worse_read_min_quality = worse_read_min_quality
        self.better_read_min_quality = better_read_min_quality
        self.window_size = window_size
        self.base = base
        self.summary_fn = summary_fn

    def _window_quality(self, read):
        window = read.qualities[: self.window_size]
        return self.summary_fn(list(quals2ints(window, self.base)))

    def __call__(self, read1, read2):
        if min(len(read1), len(read2)) < self.window_size:
            return (read1, read2)
        if not (read1.qualities and read2.qualities):
            raise ValueError(
                "OverwriteRead modifier does not work with reads lacking "
                "base qualities."
            )
        score1 = self._window_quality(read1)
        score2 = self._window_quality(read2)

        if (
            score1 < self.worse_read_min_quality
            and score2 >= self.better_read_min_quality
        ):
            read2.corrected = 1
            read1 = read2.reverse_complement()
        elif (
            score2 < self.worse_read_min_quality
            and score1 >= self.better_read_min_quality
        ):
            read1.corrected = 1
            read2 = read1.reverse_complement()
        return (read1, read2)


class MergeOverlapping(ReadPairModifier, ErrorCorrectorMixin):
    """``-R``: stitch overlapping pairs into read1 (read2 -> None)
    (ref ``modifiers.py:864-931``). Four geometries: either read contained
    in the other, or a staggered overlap extended left/right."""

    def __init__(self, min_overlap=0.9, error_rate=0.1, mismatch_action=None):
        ErrorCorrectorMixin.__init__(self, mismatch_action)
        self.min_overlap = int(min_overlap) if min_overlap > 1 else min_overlap
        self.error_rate = error_rate

    def _required_overlap(self, len1, len2):
        if self.min_overlap > 1:
            return self.min_overlap
        return max(2, round(self.min_overlap * min(len1, len2)))

    def __call__(self, read1, read2):
        len1, len2 = len(read1.sequence), len(read2.sequence)
        needed = self._required_overlap(len1, len2)
        if min(len1, len2) < needed:
            return (read1, read2)

        insert_matched = read1.insert_overlap and read2.insert_overlap
        flags = (
            START_WITHIN_SEQ1 | STOP_WITHIN_SEQ2
            if insert_matched
            else SEMIGLOBAL
        )
        read2_rc = reverse_complement(read2.sequence)
        alignment = Aligner(read2_rc, self.error_rate, flags).locate(
            read1.sequence
        )
        if not alignment:
            return (read1, read2)
        r2_start, r2_stop, r1_start, r1_stop, matches, errors = alignment
        if matches < needed:
            return (read1, read2)

        if self.mismatch_action and errors > 0 and not insert_matched:
            self.correct_errors(read1, read2, alignment)

        rev_quals = (
            "".join(reversed(read2.qualities)) if read2.qualities else None
        )
        both_quals = bool(read1.qualities and read2.qualities)
        if r2_start == 0 and r2_stop == len2:
            pass  # read2 sits entirely inside read1
        elif r1_start == 0 and r1_stop == len1:
            # read1 sits entirely inside read2
            read1.sequence = read2_rc
            read1.qualities = rev_quals
        elif r1_start > 0:
            # read1's tail overlaps read2's (rc) head: extend right
            read1.sequence += read2_rc[r2_stop:]
            if both_quals:
                read1.qualities += rev_quals[r2_stop:]
        elif r2_start > 0:
            # read2's (rc) tail overlaps read1's head: extend left
            read1.sequence = read2_rc + read1.sequence[r1_stop:]
            if both_quals:
                read1.qualities = rev_quals + read1.qualities[r1_stop:]
        else:
            raise AtroposError(
                "Invalid alignment while trying to merge read {}: {}".format(
                    read1.name, ",".join(str(i) for i in alignment)
                )
            )
        read1.merged = True
        return (read1, None)


class SwiftBisulfiteTrimmer(ReadPairModifier):
    """Swift Accel-NGS WGBS: cut 10 bp off read1's 3' end and read2's 5'
    end (ref ``modifiers.py:847-862``)."""

    display_str = "Bisulfite-trimmed (Swift)"

    def __init__(self, trim_5p1=0, trim_3p1=10, trim_5p2=10, trim_3p2=0):
        self._read1_cutter = MinCutter(
            (trim_5p1, -trim_3p1), count_trimmed=False, only_trimmed=False
        )
        self._read2_cutter = MinCutter(
            (trim_5p2, -trim_3p2), count_trimmed=False, only_trimmed=False
        )

    def __call__(self, read1, read2):
        return (self._read1_cutter(read1), self._read2_cutter(read2))

    def summarize(self):
        return dict(
            bp_trimmed=(
                self._read1_cutter.trimmed_bases,
                self._read2_cutter.trimmed_bases,
            )
        )
