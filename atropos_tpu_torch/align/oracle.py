"""Scalar reference implementation of the semi-global alignment kernels.

This module is the *executable specification* for the batched DP in
``atropos_tpu_torch.align.batched`` and the CUDA kernels in
``atropos_tpu_torch.align.cuda_kernel``: a plain-Python
implementation of the Cutadapt-style unit-cost semi-global edit-distance DP
with Ukkonen banding, exactly reproducing the observable behavior of the
reference's Cython kernels (``atropos/align/_align.pyx``):

- column-major DP with per-cell (cost, matches, origin) state;
- indels disallowed at matching positions (a match is always taken
  diagonally), tie-break order diagonal > insertion > deletion;
- Ukkonen band: ``last`` tracks the deepest row with cost <= k; rows below
  are not updated in a column and retain stale values (which is semantically
  significant and must be reproduced by any reimplementation);
- best-match selection: max matches, then min cost, then leftmost, with an
  early exit on an exact full-length match;
- final-column scan when the last column of the matrix is reached.

It is deliberately simple and unoptimized: it exists to validate the batched
kernels read by read and to serve the scalar ``Adapter.match_to`` path
and, with :class:`MultiAligner`, the scalar insert match of the pipeline
configurations the reference runs without its batched engine (colorspace,
``--stats``), as the reference does. It is not the plain version of any
kernel, and nothing on the main path calls its ``locate`` per read.
"""

import numpy as np

from atropos_tpu_torch.align.flags import (
    ACGT_TABLE,
    IUPAC_TABLE,
    OVERHANG_MULTIPLIER,
    SEMIGLOBAL,
    START_WITHIN_SEQ1,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
    translate_pair,
)


class DPMatrix:
    """Debug representation of the DP cost matrix (entries not computed due
    to banding stay None). Mirrors the reference's debug facility."""

    def __init__(self, reference, query):
        m = len(reference)
        n = len(query)
        self._rows = [[None] * (n + 1) for _ in range(m + 1)]
        self.reference = reference
        self.query = query

    def set_entry(self, i, j, cost):
        self._rows[i][j] = cost

    def __str__(self):
        rows = ["     " + " ".join(c.rjust(2) for c in self.query)]
        for c, row in zip(" " + self.reference, self._rows):
            rows.append(
                c + " " + " ".join(
                    "  " if v is None else "{0:2d}".format(v) for v in row
                )
            )
        return "\n".join(rows)


class Aligner:
    """Semi-global aligner locating a reference (adapter) within a query
    (read). See module docstring for the exact semantics contract.

    API-compatible with the reference's ``_align.pyx`` Aligner: construct
    with the reference string, then call :meth:`locate` per query.
    """

    def __init__(
        self,
        reference,
        max_error_rate,
        flags=SEMIGLOBAL,
        wildcard_ref=False,
        wildcard_query=False,
        min_overlap=1,
        indel_cost=1,
    ):
        self.max_error_rate = max_error_rate
        self.flags = flags
        self.wildcard_ref = wildcard_ref
        self.wildcard_query = wildcard_query
        self.debug = False
        self._dpmatrix = None
        self._min_overlap = 1
        self._insertion_cost = 1
        self._deletion_cost = 1
        self.reference = reference
        self.min_overlap = min_overlap
        self.indel_cost = indel_cost

    @property
    def min_overlap(self):
        return self._min_overlap

    @min_overlap.setter
    def min_overlap(self, value):
        if value < 1:
            raise ValueError("Minimum overlap must be at least 1")
        self._min_overlap = value

    @property
    def indel_cost(self):
        return self._insertion_cost

    @indel_cost.setter
    def indel_cost(self, value):
        if value < 1:
            raise ValueError("Insertion/deletion cost must be at least 1")
        self._insertion_cost = value
        self._deletion_cost = value

    @property
    def reference(self):
        return self._reference

    @reference.setter
    def reference(self, reference):
        self.str_reference = reference
        ref_b = reference.encode("ascii")
        if self.wildcard_ref:
            ref_b = ref_b.translate(IUPAC_TABLE)
        elif self.wildcard_query:
            ref_b = ref_b.translate(ACGT_TABLE)
        self._reference = ref_b
        self.m = len(reference)

    @property
    def dpmatrix(self):
        return self._dpmatrix

    def enable_debug(self):
        self.debug = True

    def locate(self, query):
        """Locate the reference in ``query``.

        Returns ``(refstart, refstop, querystart, querystop, matches,
        errors)`` or None if no alignment satisfies the error-rate /
        min-overlap constraints.
        """
        s1 = self._reference
        m = self.m
        n = len(query)
        query_b = query.encode("ascii")
        if self.wildcard_query:
            query_b = query_b.translate(IUPAC_TABLE)
        elif self.wildcard_ref:
            query_b = query_b.translate(ACGT_TABLE)
        s2 = query_b
        compare_ascii = not (self.wildcard_query or self.wildcard_ref)

        max_error_rate = self.max_error_rate
        start_in_ref = bool(self.flags & START_WITHIN_SEQ1)
        start_in_query = bool(self.flags & START_WITHIN_SEQ2)
        stop_in_ref = bool(self.flags & STOP_WITHIN_SEQ1)
        stop_in_query = bool(self.flags & STOP_WITHIN_SEQ2)
        ins_cost = self._insertion_cost
        del_cost = self._deletion_cost

        # Maximum number of errors (C-style truncation).
        k = int(max_error_rate * m)

        # Column range that can contain a valid alignment.
        max_n = n
        min_n = 0
        if not start_in_query:
            max_n = min(n, m + k)
        if not stop_in_query:
            min_n = max(0, n - m - k)

        # Per-row column state: cost / matches / origin.
        cost = [0] * (m + 1)
        matches = [0] * (m + 1)
        origin = [0] * (m + 1)

        # Initialize column min_n according to which ends are free.
        if not start_in_ref and not start_in_query:
            for i in range(m + 1):
                cost[i] = max(i, min_n) * ins_cost
        elif start_in_ref and not start_in_query:
            for i in range(m + 1):
                cost[i] = min_n * ins_cost
                origin[i] = min(0, min_n - i)
        elif not start_in_ref and start_in_query:
            for i in range(m + 1):
                cost[i] = i * ins_cost
                origin[i] = max(0, min_n - i)
        else:
            for i in range(m + 1):
                cost[i] = min(i, min_n) * ins_cost
                origin[i] = min_n - i

        if self.debug:
            self._dpmatrix = DPMatrix(self.str_reference, query)
            for i in range(m + 1):
                self._dpmatrix.set_entry(i, min_n, cost[i])

        best_ref_stop = m
        best_query_stop = n
        best_cost = m + n
        best_origin = 0
        best_matches = 0

        # Ukkonen band: deepest row to compute in the next column.
        last = m if start_in_ref else min(m, k + 1)

        for j in range(min_n + 1, max_n + 1):
            # diag source for row 1 is the previous column's row 0
            tmp_cost = cost[0]
            tmp_matches = matches[0]
            tmp_origin = origin[0]
            if start_in_query:
                origin[0] = j
            else:
                cost[0] = j * ins_cost
            qc = s2[j - 1]
            for i in range(1, last + 1):
                if compare_ascii:
                    characters_equal = s1[i - 1] == qc
                else:
                    characters_equal = (s1[i - 1] & qc) != 0
                if characters_equal:
                    # match: forced diagonal, never an indel
                    c = tmp_cost
                    o = tmp_origin
                    mt = tmp_matches + 1
                else:
                    cost_diag = tmp_cost + 1
                    cost_deletion = cost[i] + del_cost
                    cost_insertion = cost[i - 1] + ins_cost
                    if cost_diag <= cost_deletion and cost_diag <= cost_insertion:
                        c = cost_diag
                        o = tmp_origin
                        mt = tmp_matches
                    elif cost_insertion <= cost_deletion:
                        c = cost_insertion
                        o = origin[i - 1]
                        mt = matches[i - 1]
                    else:
                        c = cost_deletion
                        o = origin[i]
                        mt = matches[i]
                tmp_cost = cost[i]
                tmp_matches = matches[i]
                tmp_origin = origin[i]
                cost[i] = c
                matches[i] = mt
                origin[i] = o

            if self.debug:
                for i in range(last + 1):
                    self._dpmatrix.set_entry(i, j, cost[i])

            while last >= 0 and cost[last] > k:
                last -= 1
            if last < m:
                last += 1
            elif stop_in_query:
                # row-m check: a full-reference alignment ends at column j
                length = m + min(origin[m], 0)
                ccost = cost[m]
                cmatches = matches[m]
                if (
                    length >= self._min_overlap
                    and ccost <= length * max_error_rate
                    and (
                        cmatches > best_matches
                        or (cmatches == best_matches and ccost < best_cost)
                    )
                ):
                    best_matches = cmatches
                    best_cost = ccost
                    best_origin = origin[m]
                    best_ref_stop = m
                    best_query_stop = j
                    if ccost == 0 and cmatches == m:
                        break  # exact match

        if max_n == n:
            first_i = 0 if stop_in_ref else m
            for i in range(first_i, m + 1):
                length = i + min(origin[i], 0)
                ccost = cost[i]
                cmatches = matches[i]
                if (
                    length >= self._min_overlap
                    and ccost <= length * max_error_rate
                    and (
                        cmatches > best_matches
                        or (cmatches == best_matches and ccost < best_cost)
                    )
                ):
                    best_matches = cmatches
                    best_cost = ccost
                    best_origin = origin[i]
                    best_ref_stop = i
                    best_query_stop = n

        if best_cost == m + n:
            return None

        if best_origin >= 0:
            start1 = 0
            start2 = best_origin
        else:
            start1 = -best_origin
            start2 = 0

        assert best_ref_stop - start1 > 0
        return (
            start1,
            best_ref_stop,
            start2,
            best_query_stop,
            best_matches,
            best_cost,
        )


def locate(
    reference,
    query,
    max_error_rate,
    flags=SEMIGLOBAL,
    wildcard_ref=False,
    wildcard_query=False,
    min_overlap=1,
):
    aligner = Aligner(reference, max_error_rate, flags, wildcard_ref, wildcard_query)
    aligner.min_overlap = min_overlap
    return aligner.locate(query)


def compare_prefixes(ref, query, wildcard_ref=False, wildcard_query=False):
    """Count matches between the common-length prefixes of ref and query
    (Hamming, wildcard-aware). Returns an Aligner.locate-compatible tuple."""
    length = min(len(ref), len(query))
    ref_b, query_b, compare_ascii = translate_pair(
        ref, query, wildcard_ref, wildcard_query
    )
    # vectorized Hamming count (ref_b is the raw encoding in ascii mode,
    # so byte equality is character equality); this sits on the per-pair
    # insert-overhang path, so it must not be a Python char loop
    a = np.frombuffer(ref_b[:length], np.uint8)
    b = np.frombuffer(query_b[:length], np.uint8)
    if compare_ascii:
        matches = int((a == b).sum())
    else:
        matches = int(((a & b) != 0).sum())
    return (0, length, 0, length, matches, length - matches)


def compare_suffixes(suffix_ref, suffix_query, wildcard_ref=False, wildcard_query=False):
    """Suffix analog of :func:`compare_prefixes` (reverse both, compare)."""
    ref_r = suffix_ref[::-1]
    query_r = suffix_query[::-1]
    _, length, _, _, matches, errors = compare_prefixes(
        ref_r, query_r, wildcard_ref, wildcard_query
    )
    return (
        len(ref_r) - length,
        len(ref_r),
        len(query_r) - length,
        len(query_r),
        matches,
        errors,
    )

class MultiAligner:
    """No-indel, no-wildcard variant returning up to ``max_matches``
    candidate alignments. Overhangs are costed with OVERHANG_MULTIPLIER so
    that the band logic also limits how far an alignment may hang over.
    Used by the paired-end insert matcher."""

    def __init__(self, max_error_rate, flags=SEMIGLOBAL, min_overlap=1):
        self.max_error_rate = max_error_rate
        self.flags = flags
        self._min_overlap = min_overlap

    def locate(self, reference, query, max_matches=100):
        """Return a list of candidate (refstart, refstop, querystart,
        querystop, matches, errors) tuples, or None if there are none."""
        m = len(reference)
        n = len(query)
        s1 = reference.encode("ascii")
        s2 = query.encode("ascii")

        max_error_rate = self.max_error_rate
        start_in_ref = bool(self.flags & START_WITHIN_SEQ1)
        start_in_query = bool(self.flags & START_WITHIN_SEQ2)
        stop_in_ref = bool(self.flags & STOP_WITHIN_SEQ1)
        stop_in_query = bool(self.flags & STOP_WITHIN_SEQ2)

        k = int(max_error_rate * m)
        max_cost = m + n

        max_n = n
        min_n = 0
        if not start_in_query:
            max_n = min(n, m + k)
        if not stop_in_query:
            min_n = max(0, n - m - k)

        cost = [0] * (m + 1)
        matches = [0] * (m + 1)
        origin = [0] * (m + 1)

        if not start_in_ref and not start_in_query:
            for i in range(m + 1):
                cost[i] = max(i, min_n) * OVERHANG_MULTIPLIER
        elif start_in_ref and not start_in_query:
            for i in range(m + 1):
                cost[i] = min_n * OVERHANG_MULTIPLIER
                origin[i] = min(0, min_n - i)
        elif not start_in_ref and start_in_query:
            for i in range(m + 1):
                cost[i] = i * OVERHANG_MULTIPLIER
                origin[i] = max(0, min_n - i)
        else:
            for i in range(m + 1):
                cost[i] = min(i, min_n) * OVERHANG_MULTIPLIER
                origin[i] = min_n - i

        last = m if start_in_ref else min(m, k + 1)

        result_matches = []
        exact_match = -1
        broke = False

        for j in range(min_n + 1, max_n + 1):
            tmp_cost = cost[0]
            tmp_matches = matches[0]
            tmp_origin = origin[0]
            if start_in_query:
                origin[0] = j
            else:
                cost[0] = j * OVERHANG_MULTIPLIER
            qc = s2[j - 1]
            for i in range(1, last + 1):
                if s1[i - 1] == qc:
                    c = tmp_cost
                    o = tmp_origin
                    mt = tmp_matches + 1
                else:
                    c = tmp_cost + 1
                    o = tmp_origin
                    mt = tmp_matches
                tmp_cost = cost[i]
                tmp_matches = matches[i]
                tmp_origin = origin[i]
                cost[i] = c
                matches[i] = mt
                origin[i] = o

            while last >= 0 and cost[last] > k:
                last -= 1
            if last < m:
                last += 1
            elif stop_in_query:
                ccost = cost[m]
                if ccost > max_cost:
                    continue
                length = m + min(origin[m], 0)
                if length >= self._min_overlap and ccost <= length * max_error_rate:
                    result_matches.append((origin[m], ccost, matches[m], m, j))
                    if ccost == 0 and matches[m] == m:
                        exact_match = len(result_matches) - 1
                        broke = True
                        break
                    if len(result_matches) >= max_matches:
                        broke = True
                        break

        if not broke and max_n == n:
            first_i = 0 if stop_in_ref else m
            for i in range(first_i, m + 1):
                ccost = cost[i]
                if ccost > max_cost:
                    continue
                length = i + min(origin[i], 0)
                if length >= self._min_overlap and ccost <= length * max_error_rate:
                    result_matches.append((origin[i], ccost, matches[i], i, n))

        if not result_matches:
            return None
        if exact_match >= 0:
            result_matches = [result_matches[exact_match]]
        return [self._create_match(m_) for m_ in result_matches]

    @staticmethod
    def _create_match(match):
        m_origin, m_cost, m_matches, m_ref_stop, m_query_stop = match
        if m_origin >= 0:
            start1 = 0
            start2 = m_origin
        else:
            start1 = -m_origin
            start2 = 0
        assert m_ref_stop - start1 > 0
        return (start1, m_ref_stop, start2, m_query_stop, m_matches, m_cost)
