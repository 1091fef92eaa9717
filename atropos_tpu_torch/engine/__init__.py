"""The batched engine of the trim pipeline, and the device engine pieces
the turbo runner is built from.

Counterpart of ``atropos_tpu/engine/__init__.py``. For the configurations
the turbo runner declines, :class:`TrimEngine` replaces the per-read
scalar adapter matching of the pipeline with one batched DP per (adapter,
batch) on the run's device: the batch is encoded once into a padded
uint8 array, every adapter's semi-global DP runs over all reads at once
(:class:`~atropos_tpu_torch.align.cuda_kernel.CudaAligner` on a card, the
plain :class:`~atropos_tpu_torch.align.batched.BatchAligner` on ``cpu``),
the insert matcher's diagonal counts run on the diagonal-count kernels,
and the results are injected into the unchanged host modifier chain
(``AdapterCutter.__call__(read, injected_rounds=...)``,
``InsertAdapterCutter.__call__(..., insert_candidates=...)``), so that
every downstream behavior stays that of the scalar path.

Plain adapters match batched; anchored no-indel adapters through the
vectorized host matcher (:class:`_PrefixSuffixMatcher`); linked adapters
as two masked passes (the anchored front part over the full reads, then
the back part over the remainders of the front-matched subset); every
round of ``--times`` re-matches the still-matching subset on its trimmed
forms. Batches are padded to powers of two from 64 reads
(:func:`_bucket_batch`; the DP kernels take whole warps) and lengths to
multiples of 32 (:func:`_bucket_len`). A colorspace run gets no engine
(fallback reason ``"colorspace"``): its adapters match on the host with
the scalar aligner, as in the reference, which runs no kernel there.
"""
import numpy as np
import torch

from atropos_tpu_torch import resolve_device
from atropos_tpu_torch.adapters import (
    PREFIX,
    SUFFIX,
    LinkedAdapter,
    LinkedMatch,
)
from atropos_tpu_torch.align import Match
from atropos_tpu_torch.align.batched import (
    BatchAligner,
    BatchInsertMatcher,
    encode_reads,
)
from atropos_tpu_torch.align.cuda_kernel import CudaAligner
from atropos_tpu_torch.align.flags import (
    ACGT_TABLE,
    IUPAC_TABLE,
    translate_pair,
)
from atropos_tpu_torch.commands.trim.modifiers import (
    AdapterCutter,
    InsertAdapterCutter,
    ReadPairModifier,
)
from atropos_tpu_torch.util import reverse_complement


#: build-dispatch telemetry: how many times TrimEngine.build produced an
#: engine vs left the run to the scalar pipeline, and why the last such
#: fallback happened (the reference's counters, with the same reasons)
BUILD_COUNTS = {"engine": 0, "fallback": 0}
LAST_FALLBACK_REASON = None

#: matching-dispatch telemetry: batches matched through the batched path
#: vs reads that took per-read scalar ``match_to`` inside an engine run
#: (none here: the reference's only such adapters are colorspace ones)
MATCH_COUNTS = {"batched": 0, "scalar_reads": 0}


def engine_enabled():
    """Whether the batched engine is used: always. The per-record scalar
    pipeline runs only where :meth:`TrimEngine.build` declines a
    configuration; no switch selects it."""
    return True


def make_batch_aligner(adapter, device):
    """Device aligner for one adapter: :class:`CudaAligner` (the
    hand-written kernels) for a CUDA device, :class:`BatchAligner` (the
    plain PyTorch DP) for ``cpu``. The device alone decides; both are
    bit-exact against the scalar oracle."""
    cls = CudaAligner if torch.device(device).type == "cuda" else BatchAligner
    return cls(
        adapter.sequence,
        adapter.max_error_rate,
        adapter.where,
        wildcard_ref=adapter.adapter_wildcards,
        wildcard_query=adapter.read_wildcards,
        min_overlap=adapter.min_overlap,
        indel_cost=(adapter.aligner.indel_cost if adapter.indels else 100000),
        device=device,
    )


def _bucket_batch(batch):
    size = 64
    while size < batch:
        size *= 2
    return size


def _bucket_len(length):
    return max(32, ((length + 31) // 32) * 32)


class _PrefixSuffixMatcher:
    """Vectorized no-indel anchored matcher (compare_prefixes/suffixes).

    numpy is sufficient here: the comparison is O(B*m) byte ops.
    Reference semantics: ``_align.pyx:501-544`` +
    ``align/__init__.py:28-44``.
    """

    def __init__(self, adapter):
        self.adapter = adapter
        self.m = len(adapter.sequence)
        ref_b, _, self.compare_ascii = translate_pair(
            adapter.sequence,
            "",
            adapter.adapter_wildcards,
            adapter.read_wildcards,
        )
        self.ref_arr = np.frombuffer(ref_b, dtype=np.uint8)
        self.raw_ref = np.frombuffer(
            adapter.sequence.encode("ascii"), dtype=np.uint8
        )
        if adapter.adapter_wildcards:
            self.query_lut = np.frombuffer(
                IUPAC_TABLE if adapter.read_wildcards else ACGT_TABLE,
                dtype=np.uint8,
            )
        elif adapter.read_wildcards:
            self.query_lut = np.frombuffer(IUPAC_TABLE, dtype=np.uint8)
        else:
            self.query_lut = None

    def locate_batch(self, reads_u8, lengths):
        batch, width = reads_u8.shape
        m = self.m
        lengths = np.asarray(lengths)
        out = {
            "found": np.zeros(batch, bool),
            "start1": np.zeros(batch, np.int32),
            "stop1": np.zeros(batch, np.int32),
            "start2": np.zeros(batch, np.int32),
            "stop2": np.zeros(batch, np.int32),
            "matches": np.zeros(batch, np.int32),
            "cost": np.zeros(batch, np.int32),
        }
        is_prefix = self.adapter.where == PREFIX
        cmp_len = np.minimum(lengths, m)
        idx = np.arange(width)
        if is_prefix:
            window = reads_u8
            pos_valid = idx[None, :] < cmp_len[:, None]
        else:
            # align the last min(n, m) bases to the adapter's tail
            offs = lengths[:, None] - cmp_len[:, None]
            gather_idx = np.clip(offs + idx[None, :], 0, width - 1)
            window = np.take_along_axis(reads_u8, gather_idx, axis=1)
            pos_valid = idx[None, :] < cmp_len[:, None]

        ref = np.zeros(width, dtype=np.uint8)
        raw_ref_pad = np.zeros(width, dtype=np.uint8)
        take = min(m, width)
        if is_prefix:
            ref[:take] = self.ref_arr[:take]
            raw_ref_pad[:take] = self.raw_ref[:take]
        else:
            # suffix compare aligns adapter tail to read tail; per read the
            # compared adapter region is the LAST cmp_len bases
            pass

        if is_prefix:
            if self.compare_ascii:
                eq = window == raw_ref_pad[None, :]
            else:
                q = self.query_lut[window] if self.query_lut is not None else window
                eq = (q & ref[None, :]) != 0
            matches = np.sum(eq & pos_valid, axis=1).astype(np.int32)
            length = cmp_len.astype(np.int32)
            out["found"] = length >= 0  # compare_prefixes always returns
            out["stop1"] = length
            out["stop2"] = length
            out["matches"] = matches
            out["cost"] = length - matches
        else:
            # per-read adapter window: last cmp_len bases of the adapter
            a_offs = (m - cmp_len)[:, None]
            a_idx = np.clip(a_offs + idx[None, :], 0, m - 1)
            ref_rows = self.ref_arr[a_idx]
            raw_rows = self.raw_ref[a_idx]
            if self.compare_ascii:
                eq = window == raw_rows
            else:
                q = self.query_lut[window] if self.query_lut is not None else window
                eq = (q & ref_rows) != 0
            matches = np.sum(eq & pos_valid, axis=1).astype(np.int32)
            length = cmp_len.astype(np.int32)
            out["found"] = length >= 0
            out["start1"] = m - length
            out["stop1"] = np.full(batch, m, np.int32)
            out["start2"] = lengths.astype(np.int32) - length
            out["stop2"] = lengths.astype(np.int32)
            out["matches"] = matches
            out["cost"] = length - matches
        return out


def _encode_batch(read_objs):
    """(enc, lengths) for a list of reads — the shared per-batch
    encoding used by every matcher."""
    sequences = [read.sequence.upper() for read in read_objs]
    width = _bucket_len(max((len(s) for s in sequences), default=1))
    return encode_reads(sequences, pad_to=width)


def _locate_padded(aligner, enc, lengths):
    """``aligner.locate_batch`` over the batch padded with empty reads to
    :func:`_bucket_batch` rows (whole warps for the DP kernels), cut back
    to the batch."""
    batch = enc.shape[0]
    rows = _bucket_batch(batch)
    padded = np.zeros((rows, enc.shape[1]), np.uint8)
    padded[:batch] = enc
    padded_lengths = np.zeros(rows, np.int32)
    padded_lengths[:batch] = lengths
    out = aligner.locate_batch(padded, padded_lengths)
    return {key: np.asarray(val)[:batch] for key, val in out.items()}


class _AdapterMatcher:
    """Per-adapter batched matcher producing Match objects for a batch."""

    def __init__(self, adapter, device):
        self.adapter = adapter
        self.device = device
        self.linked = isinstance(adapter, LinkedAdapter)
        if self.linked:
            # two masked passes: the (anchored) front part over the full
            # reads, then the back part batched over the remainders of
            # the reads whose front matched — the batch image of
            # ``LinkedAdapter.match_to``
            self._front = _AdapterMatcher(adapter.front_adapter, device)
            self._back = _AdapterMatcher(adapter.back_adapter, device)
            return
        self._aligner = None
        self._ps_matcher = None
        if not adapter.indels and adapter.where in (PREFIX, SUFFIX):
            self._ps_matcher = _PrefixSuffixMatcher(adapter)

    def _get_aligner(self):
        if self._aligner is None:
            self._aligner = make_batch_aligner(self.adapter, self.device)
        return self._aligner

    def _match_linked(self, read_objs, enc, lengths):
        front = self._front.match_batch(read_objs, enc, lengths)
        out = [None] * len(read_objs)
        rem_idx = []
        rem_reads = []
        for idx, front_match in enumerate(front):
            if front_match is None:
                continue
            rem_idx.append(idx)
            rem_reads.append(read_objs[idx][front_match.rstop :])
        back = [None] * len(rem_idx)
        nonempty = [
            pos for pos, read in enumerate(rem_reads) if len(read) > 0
        ]
        if nonempty:
            sub = [rem_reads[pos] for pos in nonempty]
            found = self._back.match_batch(sub, *_encode_batch(sub))
            for pos, match in zip(nonempty, found):
                back[pos] = match
        for pos, idx in enumerate(rem_idx):
            out[idx] = LinkedMatch(front[idx], back[pos], self.adapter)
        return out

    def match_batch(self, read_objs, enc, lengths):
        """Return a list of Match|None for every read in the batch."""
        adapter = self.adapter
        MATCH_COUNTS["batched"] += 1
        if self.linked:
            return self._match_linked(read_objs, enc, lengths)

        if self._ps_matcher is not None:
            out = self._ps_matcher.locate_batch(enc, lengths)
        else:
            out = _locate_padded(self._get_aligner(), enc, lengths)

        results = []
        for idx, read in enumerate(read_objs):
            if not out["found"][idx]:
                results.append(None)
                continue
            astart = int(out["start1"][idx])
            astop = int(out["stop1"][idx])
            rstart = int(out["start2"][idx])
            rstop = int(out["stop2"][idx])
            matches = int(out["matches"][idx])
            errors = int(out["cost"][idx])
            size = astop - astart
            # validation identical to Adapter.match_to
            if size <= 0:
                results.append(None)
                continue
            if (
                size >= adapter.min_overlap
                and errors / size <= adapter.max_error_rate
            ) and (
                adapter.max_rmp is None
                or adapter.match_probability(matches, size) <= adapter.max_rmp
            ):
                results.append(
                    Match(
                        astart, astop, rstart, rstop, matches, errors,
                        adapter._front_flag, adapter, read,
                    )
                )
            else:
                results.append(None)
        return results


class BatchMatcher:
    """Best-of-N adapter matching for an AdapterCutter, batched on
    ``device``."""

    def __init__(self, cutter, device):
        self.cutter = cutter
        self.matchers = [_AdapterMatcher(a, device) for a in cutter.adapters]

    def best_matches(self, read_objs):
        """Batched equivalent of ``AdapterCutter._best_match`` per read."""
        if not read_objs:
            return []
        enc, lengths = _encode_batch(read_objs)
        per_adapter = [
            matcher.match_batch(read_objs, enc, lengths)
            for matcher in self.matchers
        ]
        best = [None] * len(read_objs)
        for matches in per_adapter:
            for idx, match in enumerate(matches):
                if match is None:
                    continue
                if best[idx] is None or match.matches > best[idx].matches:
                    best[idx] = match
        return best

    def match_rounds(self, read_objs, times):
        """Batched equivalent of ``AdapterCutter._match_rounds`` for the
        whole batch: up to ``times`` best-match+trim rounds, each round
        re-matching only the reads still matching, on their trimmed
        forms. Returns one ``(matches, final_read)`` tuple per read —
        exactly the scalar loop's state."""
        results = [([], read) for read in read_objs]
        active = [
            idx for idx, read in enumerate(read_objs) if len(read) > 0
        ]
        for _ in range(times):
            if not active:
                break
            found = self.best_matches([results[idx][1] for idx in active])
            next_active = []
            for idx, match in zip(active, found):
                if match is None:
                    continue
                matches, current = results[idx]
                matches.append(match)
                results[idx] = (matches, match.adapter.trimmed(match))
                if len(results[idx][1]) > 0:
                    next_active.append(idx)
            active = next_active
        return results


class TrimEngine:
    """Engine driving batch-level adapter matching inside the pipeline.

    Splits the ordered modifier chain at the cutter stage: the modifiers
    before it are applied per read (cheap host transforms), the adapter
    (or insert) matching runs batched on ``device``, then the cutter (with
    its match rounds or insert candidates injected) and the remaining
    modifiers run per read.
    """

    def __init__(self, modifiers, paired, device):
        self.modifiers = modifiers
        self.paired = paired
        self.device = device
        self.cutter1 = self.cutter2 = None
        self.matcher1 = self.matcher2 = None
        self.insert_cutter = None
        self._insert_matcher = None
        if modifiers.has_modifier(AdapterCutter):
            idx = modifiers.modifier_indexes[AdapterCutter][0]
            entry = modifiers.modifiers[idx]
            self.cutter1, self.cutter2 = entry[0], entry[1]
            self.matcher1 = (
                BatchMatcher(self.cutter1, device) if self.cutter1 else None
            )
            self.matcher2 = (
                BatchMatcher(self.cutter2, device) if self.cutter2 else None
            )
        else:
            idx = modifiers.modifier_indexes[InsertAdapterCutter][0]
            self.insert_cutter = modifiers.modifiers[idx]
            aligner = self.insert_cutter.aligner
            self._insert_matcher = BatchInsertMatcher(
                aligner.max_insert_mismatch_frac,
                min_overlap=aligner.min_insert_overlap,
                max_matches=100,
            )
        self.cutter_index = idx
        self.pre_entries = modifiers.modifiers[:idx]
        self.post_entries = modifiers.modifiers[idx + 1 :]

    @classmethod
    def build(cls, modifiers, options):
        """Return a TrimEngine on the run's device (``options.device``) if
        this configuration is eligible, else None (the pipeline then runs
        fully scalar). Every outcome is counted in :data:`BUILD_COUNTS`;
        fallbacks record their reason."""
        reason = None
        if options.colorspace:
            reason = "colorspace"
        elif modifiers.has_modifier(AdapterCutter):
            if len(modifiers.modifier_indexes[AdapterCutter]) != 1:
                reason = "multiple AdapterCutter stages"
        elif modifiers.has_modifier(InsertAdapterCutter):
            if len(modifiers.modifier_indexes[InsertAdapterCutter]) != 1:
                reason = "multiple InsertAdapterCutter stages"
        else:
            reason = "no adapter cutter stage"
        global LAST_FALLBACK_REASON
        if reason is not None:
            BUILD_COUNTS["fallback"] += 1
            LAST_FALLBACK_REASON = reason
            return None
        BUILD_COUNTS["engine"] += 1
        LAST_FALLBACK_REASON = None
        return cls(modifiers, options.paired, resolve_device(options.device))

    def _insert_candidates(self, staged):
        """Batched insert-overlap matching: for each eligible pair, the
        diagonal matcher on (rc(read2), read1) truncated to equal length —
        exactly the scalar ``InsertAligner.match_insert`` setup — in ONE
        counts launch for the whole batch (per-pair length is data, not
        shape). Returns a per-pair list of candidate lists (``False`` =
        pair not matched here: the cutter leaves it as it is)."""
        candidates = [False] * len(staged)
        min_len = self.insert_cutter.min_insert_len
        items = []
        for idx, (read1, read2) in enumerate(staged):
            if read2 is None:
                continue
            len1, len2 = len(read1), len(read2)
            if len1 < min_len or len2 < min_len:
                continue
            seq_len = min(len1, len2)
            ref = reverse_complement(read2.sequence[:seq_len])
            query = read1.sequence[:seq_len]
            items.append((idx, ref, query, seq_len))
        if not items:
            return candidates
        width = max(8, max(item[3] for item in items))
        batch = len(items)
        refs = np.zeros((batch, width), np.uint8)
        queries = np.zeros((batch, width), np.uint8)
        lengths = np.zeros(batch, np.int32)
        for b, (_, ref, query, seq_len) in enumerate(items):
            refs[b, :seq_len] = np.frombuffer(ref.encode("ascii"), np.uint8)
            queries[b, :seq_len] = np.frombuffer(
                query.encode("ascii"), np.uint8
            )
            lengths[b] = seq_len
        found = self._insert_matcher.candidates(
            refs, queries, lengths, self.device
        )
        for b, (idx, _, _, _) in enumerate(items):
            candidates[idx] = found[b]
        return candidates

    # -- per-read application of a non-cutter modifier entry ----------------

    @staticmethod
    def _apply_entry(entry, read1, read2):
        if isinstance(entry, ReadPairModifier):
            return entry(read1, read2)
        if entry[0] is not None:
            read1 = entry[0](read1)
        if read2 is not None and entry[1] is not None:
            read2 = entry[1](read2)
        return read1, read2

    def modify_batch(self, pairs):
        """Apply the modifier chain to a batch of (read1, read2|None).

        Returns the list of modified (read1, read2) tuples in order.
        """
        # phase 1: pre-cutter modifiers
        staged = []
        for read1, read2 in pairs:
            for entry in self.pre_entries:
                read1, read2 = self._apply_entry(entry, read1, read2)
            staged.append((read1, read2))

        # phase 2: batched matching — ALL ``times`` rounds run batched
        # (each round re-matches the still-matching subset on its
        # trimmed forms); linked adapters batch as front/back passes
        rounds1 = rounds2 = insert_candidates = None
        if self.insert_cutter is not None:
            insert_candidates = self._insert_candidates(staged)
        if self.matcher1:
            rounds1 = self.matcher1.match_rounds(
                [r1 for r1, _ in staged], self.cutter1.times
            )
        if self.matcher2:
            reads2 = [r2 for _, r2 in staged]
            present = [i for i, r in enumerate(reads2) if r is not None]
            sub = self.matcher2.match_rounds(
                [reads2[i] for i in present], self.cutter2.times
            )
            rounds2 = [None] * len(reads2)
            for i, item in zip(present, sub):
                rounds2[i] = item

        # phase 3: cutter with injected match rounds + post modifiers
        out = []
        for idx, (read1, read2) in enumerate(staged):
            if self.insert_cutter is not None:
                read1, read2 = self.insert_cutter(
                    read1, read2, insert_candidates=insert_candidates[idx]
                )
            if self.cutter1 is not None:
                read1 = self.cutter1(read1, injected_rounds=rounds1[idx])
            if self.cutter2 is not None and read2 is not None:
                read2 = self.cutter2(read2, injected_rounds=rounds2[idx])
            for entry in self.post_entries:
                read1, read2 = self._apply_entry(entry, read1, read2)
            out.append((read1, read2))
        return out
