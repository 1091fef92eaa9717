"""The 'detect' command: discover adapter/contaminant sequences in reads.

Counterpart of ``atropos_tpu/commands/detect/__init__.py``, with its three
detection algorithms, all driven by the packed k-mer machinery of
:mod:`.kmers`:

- **known**: score reads against a known-contaminant list by k-mer set
  intersection in both orientations (the whole panel against every read
  in one torch op on the run's device);
- **heuristic**: grow over-represented k-mers (k, k+1, ...) until none
  remain, merge candidates by containment, then identify them against
  the known list with k-mer scoring plus a no-indel semi-global
  alignment check (each round's k-mer sort and count a torch op on the
  run's device);
- **kmer** ('khmer'): single-pass k-mer frequency scan, the khmer
  Countgraph when importable, otherwise the exact packed counter with the
  same over-representation threshold.
"""
import logging
import math
import re
from collections import defaultdict

from atropos_tpu_torch import resolve_device
from atropos_tpu_torch.align.flags import SEMIGLOBAL
from atropos_tpu_torch.align.oracle import Aligner
from atropos_tpu_torch.commands.base import (
    BaseCommandRunner,
    PairedEndPipelineMixin,
    Pipeline,
    SingleEndPipelineMixin,
)
from atropos_tpu_torch.commands.detect.kmers import (
    batch_intersections,
    count_corpus,
    intersection_size,
    packed_kmer_set,
)
from atropos_tpu_torch.util import (
    reverse_complement,
    run_interruptible,
    sequence_complexity,
)


def align(seq1, seq2, min_overlap_frac=0.9):
    """Mismatch-only semi-global check that ``seq2`` overlaps ``seq1``
    well enough; returns the matched slice of seq1 or None."""
    aligner = Aligner(seq1, 0.0, SEMIGLOBAL, False, False)
    aligner.min_overlap = math.ceil(
        min(len(seq1), len(seq2)) * min_overlap_frac
    )
    aligner.indel_cost = 100000
    found = aligner.locate(seq2)
    if found:
        return seq1[found[0] : found[1]]
    return None


class Match:
    """A detected contaminant: candidate sequence + supporting evidence."""

    def __init__(
        self,
        seq_or_contam,
        count=0,
        names=None,
        match_frac=None,
        match_frac2=None,
        abundance=None,
        reads=None,
    ):
        if isinstance(seq_or_contam, ContaminantMatcher):
            self.seq = seq_or_contam.seq
            self.count = int(seq_or_contam.matches)
            self.names = tuple(seq_or_contam.names)
            self.known_seqs = [seq_or_contam.seq]
        else:
            self.seq = seq_or_contam
            self.count = count
            self.names = tuple(names) if names else None
            self.known_seqs = None
        self.match_frac = match_frac
        self.match_frac2 = match_frac2
        self.abundance = abundance
        self.longest_match = None
        if reads:
            self.set_longest_match(reads)

    def __len__(self):
        return len(self.seq)

    def __repr__(self):
        if self.is_known:
            return "{} => {} ({}))".format(
                self.seq, self.names, self.known_seqs
            )
        return self.seq

    @property
    def seq_complexity(self):
        return sequence_complexity(self.seq)

    @property
    def count_is_frequency(self):
        return isinstance(self.count, float)

    @property
    def is_known(self):
        return self.known_seqs is not None

    def set_contaminant(self, contam, match_frac, match_frac2=None):
        self.set_known(contam.names, [contam.seq], match_frac, match_frac2)

    def set_known(self, names, seqs, match_frac, match_frac2=None):
        self.names = tuple(names) if names else None
        self.known_seqs = seqs
        self.match_frac = match_frac
        self.match_frac2 = match_frac2

    def set_longest_match(self, sequences):
        for seq in sequences:
            start = seq.index(self.seq)
            span = len(self.seq) - start
            if self.longest_match is None or self.longest_match[1] < span:
                self.longest_match = (seq[start:], span)

    def estimate_abundance(self, read_sequences):
        self.abundance = sum(
            1 for read_seq in read_sequences if self.seq in read_seq
        )

    def summarize(self):
        summary = dict(
            longest_kmer=self.seq,
            kmer_freq=self.count,
            kmer_freq_type=(
                "frequency" if self.count_is_frequency else "count"
            ),
            abundance=self.abundance,
            is_known=self.is_known,
            known_to_contaminant_match_frac=None,
            contaminant_to_known_match_frac=None,
            longest_match=None,
            known_names=None,
            known_seqs=None,
        )
        if self.longest_match:
            summary.update(longest_match=self.longest_match[0])
        if self.is_known:
            summary.update(
                known_to_contaminant_match_frac=self.match_frac,
                contaminant_to_known_match_frac=self.match_frac2,
                known_names=self.names,
                known_seqs=self.known_seqs,
            )
        return summary


class ContaminantMatcher:
    """k-mer set scorer for one known contaminant.

    Scoring compares the contaminant's k-mer set against a read's, in
    whichever orientation matches better; packed codes make the
    intersection an array operation.
    """

    def __init__(self, seq, names, kmer_size):
        self.seq = seq
        self.names = names
        self.kmer_size = kmer_size
        self.kmers = set(
            seq[i : i + kmer_size] for i in range(len(seq) - kmer_size + 1)
        )
        self.n_kmers = len(self.kmers)
        self.matches = 0
        self._packed = packed_kmer_set(seq, kmer_size)

    def _side_score(self, text, packed):
        """(intersection size, number of distinct k-mers in text)."""
        if self._packed is not None and packed is not None:
            return (
                float(intersection_size(self._packed, packed)),
                packed.shape[0],
            )
        window = set(
            text[i : i + self.kmer_size]
            for i in range(len(text) - self.kmer_size + 1)
        )
        return float(len(self.kmers & window)), len(window)

    def match(self, seq, seqrc, packed_fw=None, packed_rv=None):
        """(frac of contaminant k-mers hit, frac of read k-mers hit,
        best-orientation sequence)."""
        fw_hits, fw_total = self._side_score(seq, packed_fw)
        rv_hits, rv_total = self._side_score(seqrc, packed_rv)
        return self.apply_score(
            fw_hits, fw_total, rv_hits, rv_total, seq, seqrc
        )

    def apply_score(self, fw_hits, fw_total, rv_hits, rv_total, seq, seqrc):
        """Fold one read's precomputed per-orientation scores into the
        matcher's state (the tail of :meth:`match`; lets the batched
        device intersection path feed whole score matrices)."""
        if fw_hits >= rv_hits:
            hits, total, oriented = fw_hits, fw_total, seq
        else:
            hits, total, oriented = rv_hits, rv_total, seqrc
        self.matches += hits
        frac_of_contam = hits / self.n_kmers if self.n_kmers else 0
        frac_of_read = hits / total if total else 0
        return frac_of_contam, frac_of_read, oriented


def create_contaminant_matchers(contaminants, kmer_size):
    return [
        ContaminantMatcher(seq, names, kmer_size)
        for seq, names in contaminants.iter_sequences()
    ]


# -- detectors -------------------------------------------------------------------


class Detector(SingleEndPipelineMixin, Pipeline):
    """Shared streaming/filtering/reporting logic of all detectors."""

    def __init__(
        self,
        kmer_size=12,
        n_reads=10000,
        overrep_cutoff=100,
        include="all",
        known_contaminants=None,
        past_end_bases=("A",),
        device=None,
    ):
        super().__init__()
        #: where the k-mer sorts, counts and intersections run
        self.device = resolve_device(device)
        self.kmer_size = kmer_size
        self.n_reads = n_reads
        self.overrep_cutoff = overrep_cutoff
        self.include = include
        self.known_contaminants = known_contaminants
        self._read_length = None
        self._read_sequences = set()
        self._matches = None
        self._past_end_regexp = self._compile_past_end(past_end_bases)

    @staticmethod
    def _compile_past_end(past_end_bases):
        """Reads sequenced past the template end show base runs (usually
        A); build the pattern that strips them."""
        if not past_end_bases:
            return None
        if len(past_end_bases[0]) > 1:
            return re.compile(past_end_bases[0])
        return re.compile(
            "|".join(
                base + "{8,}.*|" + base + "{2,}$" for base in past_end_bases
            )
        )

    @property
    def min_report_freq(self):
        raise NotImplementedError()

    def set_read_length(self, record):
        assert self._read_length is None
        self._read_length = len(record.sequence)

    def handle_records(self, context, records):
        if context["size"] == 0:
            return
        if self._read_length is None:
            self.set_read_length(records[0])
        super().handle_records(context, records)

    def handle_reads(self, context, read1, read2=None):
        seq = self._filter_seq(read1.sequence)
        if seq:
            self._read_sequences.add(seq)

    def _filter_seq(self, seq):
        if sequence_complexity(seq) <= 1.0:
            return None
        if self._past_end_regexp:
            hit = self._past_end_regexp.search(seq)
            if hit:
                seq = seq[: hit.start()]
        if len(seq) < self.kmer_size:
            return None
        return seq

    def _overrep_threshold(self, kmer_size):
        """Expected chance occurrences of one k-mer, times the cutoff."""
        return (
            self.n_reads
            * (self._read_length - kmer_size + 1)
            * self.overrep_cutoff
            / float(4 ** kmer_size)
        )

    def matches(self, **kwargs):
        if self._matches is None or kwargs:
            self._filter_and_sort(**kwargs)
        return self._matches

    def _filter_and_sort(
        self, min_len=None, min_complexity=1.1, min_match_frac=0.1, limit=20
    ):
        if min_len is None:
            min_len = self.kmer_size
        candidates = self._get_contaminants()
        for match in candidates:
            match.estimate_abundance(self._read_sequences)

        def keep(match):
            if match.count < self.min_report_freq:
                return False
            if min_len and len(match) < min_len:
                return False
            if min_complexity and match.seq_complexity < min_complexity:
                return False
            if self.include == "known" and not match.is_known:
                return False
            if self.include == "unknown" and match.is_known:
                return False
            if (
                min_match_frac
                and match.is_known
                and match.match_frac < min_match_frac
            ):
                return False
            return True

        kept = [match for match in candidates if keep(match)]
        kept.sort(key=lambda m: len(m) * math.log(m.count), reverse=True)
        self._matches = kept[:limit] if limit is not None else kept

    def _get_contaminants(self):
        raise NotImplementedError()

    def finish(self, summary, **kwargs):
        super().finish(summary)
        summary["detect"]["matches"] = (
            [match.summarize() for match in self.matches(**kwargs)],
        )


class PairedDetector(PairedEndPipelineMixin, Pipeline):
    """Independent detector per mate."""

    def __init__(self, detector_class, **kwargs):
        super().__init__()
        self.read1_detector = detector_class(**kwargs)
        self.read2_detector = detector_class(**kwargs)
        self._read_length_set = False

    def handle_records(self, context, records):
        if context["size"] == 0:
            return
        if not self._read_length_set:
            read1, read2 = records[0]
            self.read1_detector.set_read_length(read1)
            self.read2_detector.set_read_length(read2)
            self._read_length_set = True
        super().handle_records(context, records)

    def handle_reads(self, context, read1, read2):
        self.read1_detector.handle_reads(context, read1)
        self.read2_detector.handle_reads(context, read2)

    def finish(self, summary, **kwargs):
        super().finish(summary)
        summary["detect"]["matches"] = (
            [m.summarize() for m in self.read1_detector.matches(**kwargs)],
            [m.summarize() for m in self.read2_detector.matches(**kwargs)],
        )


class KnownContaminantDetector(Detector):
    """Only report known contaminants (linear in reads)."""

    def __init__(self, known_contaminants, min_kmer_match_frac=0.5, **kwargs):
        super().__init__(known_contaminants=known_contaminants, **kwargs)
        self.min_kmer_match_frac = min_kmer_match_frac
        self._min_k = min(len(s) for s in known_contaminants.sequences)

    @property
    def min_report_freq(self):
        return 0.1

    def _filter_seq(self, seq):
        seq = super()._filter_seq(seq)
        if seq and len(seq) >= self._min_k:
            return seq
        return None

    def _get_contaminants(self):
        matchers = create_contaminant_matchers(
            self.known_contaminants, self.kmer_size
        )
        hit_counts = defaultdict(int)
        best_fracs = defaultdict(int)

        seqs = list(self._read_sequences)
        rcs = [reverse_complement(seq) for seq in seqs]
        packed_fw = [packed_kmer_set(seq, self.kmer_size) for seq in seqs]
        packed_rv = [packed_kmer_set(rc, self.kmer_size) for rc in rcs]

        # one batched device op scores the whole contaminant panel
        # against every packable read at once; unpackable reads (and
        # unpackable contaminants) keep the per-pair path
        fw_mat = rv_mat = None
        cols = {}
        contam_sets = [matcher._packed for matcher in matchers]
        if matchers and all(arr is not None for arr in contam_sets):
            rows = [
                i for i in range(len(seqs))
                if packed_fw[i] is not None and packed_rv[i] is not None
            ]
            if rows:
                cols = {read_i: col for col, read_i in enumerate(rows)}
                fw_mat = batch_intersections(
                    contam_sets, [packed_fw[i] for i in rows], self.device
                )
                rv_mat = batch_intersections(
                    contam_sets, [packed_rv[i] for i in rows], self.device
                )

        for i, seq in enumerate(seqs):
            seqrc = rcs[i]
            col = cols.get(i)
            for m_idx, matcher in enumerate(matchers):
                if col is not None:
                    frac, _, _ = matcher.apply_score(
                        float(fw_mat[m_idx, col]), packed_fw[i].shape[0],
                        float(rv_mat[m_idx, col]), packed_rv[i].shape[0],
                        seq, seqrc,
                    )
                else:
                    frac, _, _ = matcher.match(
                        seq, seqrc, packed_fw[i], packed_rv[i]
                    )
                if frac > self.min_kmer_match_frac:
                    hit_counts[matcher] += 1
                    if frac > best_fracs[matcher]:
                        best_fracs[matcher] = frac

        min_count = math.ceil(
            self.n_reads
            * (self._read_length - self._min_k + 1)
            * self.overrep_cutoff
            / float(4 ** self._min_k)
        )
        return [
            Match(
                matcher,
                match_frac=best_fracs[matcher],
                abundance=float(count) / self.n_reads,
            )
            for matcher, count in hit_counts.items()
            if count >= min_count
        ]


class HeuristicDetector(Detector):
    """Grow-and-merge k-mer detector (most accurate, superlinear)."""

    def __init__(
        self, min_frequency=0.001, min_contaminant_match_frac=0.9, **kwargs
    ):
        super().__init__(**kwargs)
        self.min_frequency = min_frequency
        self.min_contaminant_match_frac = min_contaminant_match_frac

    @property
    def min_report_freq(self):
        return 0.1 * self.n_reads

    def _min_count(self, kmer_size):
        return math.ceil(
            self.n_reads
            * max(
                self.min_frequency,
                (self._read_length - kmer_size + 1)
                * self.overrep_cutoff
                / float(4 ** kmer_size),
            )
        )

    def _grow_overrepresented(self):
        """Lengthen over-represented k-mers until none survive; returns
        {kmer: count} of maximal over-represented k-mers plus the sets of
        source sequences per k-mer."""
        kmer_size = self.kmer_size
        table = count_corpus(
            self._read_sequences, kmer_size, with_membership=True,
            device=self.device,
        )
        min_count = self._min_count(kmer_size)
        prev = None
        results = {}
        result_seqs = defaultdict(set)

        while True:
            survivors = {}
            covered = set()
            for kmer, (count, seqs) in table.items():
                if count > min_count:
                    survivors[kmer] = (count, seqs)
                    covered.update(seqs)
            if not covered:
                break
            if prev:
                # a k-mer whose source sequences produced no surviving
                # (k+1)-mer is maximal: record it
                for kmer, (count, seqs) in prev.items():
                    if (
                        not any(seq in survivors for seq in seqs)
                        and sequence_complexity(kmer) > 1.0
                    ):
                        results[kmer] = count
                        result_seqs[kmer].update(seqs)
            kmer_size += 1
            table = count_corpus(
                covered, kmer_size, with_membership=True, device=self.device
            )
            min_count = self._min_count(kmer_size)
            prev = survivors
        return results, result_seqs

    @staticmethod
    def _merge_by_containment(results):
        """Combine candidates where one contains the other, repeatedly
        taking the current best-scoring candidate as the anchor."""
        merged = []
        pending = []
        while len(results) > 1:
            anchor_seq, anchor_count = results[0]
            for other_seq, other_count in results[1:]:
                if len(anchor_seq) >= len(other_seq) and other_seq in anchor_seq:
                    anchor_count += other_count
                elif anchor_seq in other_seq:
                    if anchor_count < 2 * other_count:
                        anchor_seq = other_seq
                    anchor_count += other_count
                else:
                    pending.append((other_seq, other_count))
            merged.append([anchor_seq, anchor_count])
            results = pending
            pending = []
        return merged + results

    def _get_contaminants(self):
        results, result_seqs = self._grow_overrepresented()
        results = sorted(
            results.items(),
            key=lambda r: len(r[0]) * math.log(r[1]),
            reverse=True,
        )
        results = self._merge_by_containment(results)
        if not results:
            return []

        results.sort(key=lambda r: r[1], reverse=True)
        floor = int(results[0][1] * 0.5)  # within 50% of the best hit
        matches = [
            Match(seq, count=count, reads=result_seqs[seq])
            for seq, count in results
            if count >= floor
        ]
        if self.known_contaminants:
            matches = self._identify_known(matches)
        return matches

    def _identify_known(self, matches):
        """Attach known-contaminant identities to candidates; candidates
        matching nothing stay 'unknown'."""
        matchers = create_contaminant_matchers(
            self.known_contaminants, self.kmer_size
        )
        by_contaminant = {}
        unknown = []

        def scan(text, best, best_frac, match):
            seqrc = reverse_complement(text)
            packed_fw = packed_kmer_set(text, self.kmer_size)
            packed_rv = packed_kmer_set(seqrc, self.kmer_size)
            for matcher in matchers:
                frac1, frac2, oriented = matcher.match(
                    text, seqrc, packed_fw, packed_rv
                )
                if frac1 < best_frac[0]:
                    continue
                verified = matcher.seq in oriented or align(
                    oriented, matcher.seq, self.min_contaminant_match_frac
                )
                if not verified:
                    continue
                if frac1 > best_frac[0] or (
                    frac1 == best_frac[0] and frac2 > best_frac[1]
                ):
                    best = {}
                    best_frac = (frac1, frac2)
                best[matcher] = (match, (frac1, frac2))
            return best, best_frac

        for match in matches:
            best, best_frac = scan(
                match.seq, {}, (self.min_contaminant_match_frac, 0), match
            )
            if match.longest_match:
                best, best_frac = scan(
                    match.longest_match[0], best, best_frac, match
                )
            if best:
                for matcher, entry in best.items():
                    if (
                        matcher not in by_contaminant
                        or entry[1] > by_contaminant[matcher][1]
                    ):
                        by_contaminant[matcher] = entry
            else:
                unknown.append(match)

        # invert: collect all contaminants claiming each candidate
        claims = defaultdict(list)
        for matcher, (match, frac) in by_contaminant.items():
            claims[match].append((matcher, frac))

        identified = []
        for match, contams in claims.items():
            contams.sort(key=lambda c: c[1], reverse=True)
            top, top_frac = contams[0]
            ties = [c for c in contams[1:] if c[1] == top_frac]
            if not ties:
                match.set_contaminant(top, *top_frac)
            else:
                names = set(top.names)
                seqs = {(top.seq,)}
                for other, _ in ties:
                    names.update(other.names)
                    seqs.add(other.seq)
                match.set_known(list(names), list(seqs), *top_frac)
            identified.append(match)
        return identified + unknown


class KhmerDetector(Detector):
    """Single-pass k-mer frequency detector.

    Matches the reference's khmer Countgraph behavior when khmer is
    importable; otherwise counts exactly with the packed engine (exact
    counts are strictly more precise than the Countgraph's)."""

    @property
    def min_report_freq(self):
        return 0.0001

    def _get_contaminants(self):
        n_win = self._read_length - self.kmer_size + 1
        tablesize = self.n_reads * n_win
        n_expected = math.ceil(tablesize / float(4 ** self.kmer_size))
        min_count = n_expected * self.overrep_cutoff
        if min_count >= 2 ** 16:
            raise ValueError(
                "The minimum count for an over-represented k-kmer {} is "
                "greater than the max khmer count (2^16)".format(min_count)
            )

        candidates = self._count_candidates(tablesize, min_count)
        if not self.known_contaminants:
            return [
                Match(kmer, count=count / float(tablesize))
                for kmer, count in candidates.items()
            ]

        matches = []
        seen = set()

        def frequency(kmer):
            count = candidates.get(kmer, 0)
            if count > 0:
                seen.add(kmer)
            return count

        for seq, names in self.known_contaminants.iter_sequences():
            if len(seq) < self.kmer_size:
                continue
            n_kmers = len(seq) - self.kmer_size + 1
            hits = []
            for start in range(n_kmers):
                kmer = seq[start : start + self.kmer_size]
                count = max(frequency(kmer), frequency(reverse_complement(kmer)))
                if count > 0:
                    hits.append(count)
            if hits:
                matches.append(
                    Match(
                        seq,
                        count=(sum(hits) / float(n_kmers)) / float(tablesize),
                        names=names,
                        match_frac=float(len(hits)) / n_kmers,
                    )
                )
        for kmer in set(candidates) - seen:
            matches.append(Match(kmer, count=candidates[kmer] / float(tablesize)))
        return matches

    def _count_candidates(self, tablesize, min_count):
        try:
            from khmer import Countgraph, khmer_args
        except ImportError:
            counts = count_corpus(
                self._read_sequences, self.kmer_size, device=self.device
            )
            return {
                kmer: count
                for kmer, count in counts.items()
                if count >= min_count
            }
        countgraph = Countgraph(
            self.kmer_size, tablesize, khmer_args.DEFAULT_N_TABLES
        )
        countgraph.set_use_bigcount(True)
        for seq in self._read_sequences:
            countgraph.consume_and_tag(seq)
        return {
            tag: countgraph.get(tag)
            for tag in countgraph.get_tagset()
            if countgraph.get(tag) >= min_count
        }


# -- command entry ------------------------------------------------------------------


_DETECTOR_LOG = dict(
    known="Detecting contaminants using the known-only algorithm",
    heuristic="Detecting contaminants using the heuristic algorithm",
    khmer="Detecting contaminants using the kmer-based algorithm",
)


class CommandRunner(BaseCommandRunner):
    name = "detect"

    def _choose_detector(self, known_contaminants, include):
        if self.detector:
            return self.detector
        if known_contaminants and include == "known":
            return "known"
        if self.max_reads <= 50000:
            return "heuristic"
        return "khmer"

    def __call__(self):
        kmer_size = self.kmer_size or 12
        n_reads = self.max_reads
        overrep_cutoff = 100
        include = self.include_contaminants or "all"
        known_contaminants = None
        if include != "unknown":
            known_contaminants = self.load_known_adapters()

        name = self._choose_detector(known_contaminants, include)
        if name not in _DETECTOR_LOG:
            raise ValueError("Invalid value for 'detector': {}".format(name))
        logging.getLogger().debug(_DETECTOR_LOG[name])

        detector_args = dict(
            known_contaminants=known_contaminants, device=self.options.device
        )
        if name == "known":
            detector_class = KnownContaminantDetector
            detector_args["min_kmer_match_frac"] = self.min_kmer_match_frac
        elif name == "heuristic":
            detector_class = HeuristicDetector
            detector_args["min_frequency"] = self.min_frequency
            detector_args["min_contaminant_match_frac"] = (
                self.min_contaminant_match_frac
            )
        else:
            detector_class = KhmerDetector

        summary_args = dict(
            kmer_size=kmer_size,
            n_reads=n_reads,
            overrep_cutoff=overrep_cutoff,
            include=include,
            past_end_bases=self.past_end_bases,
        )
        detector_args.update(summary_args)

        if self.paired:
            detector = PairedDetector(detector_class, **detector_args)
        else:
            detector = detector_class(**detector_args)

        self.summary["detect"] = summary_args
        if known_contaminants:
            self.summary["detect"]["known_contaminants"] = (
                known_contaminants.summarize()
            )

        logging.getLogger().info(
            "Detecting adapters and other potential contaminant "
            "sequences based on %d-mers in %d reads",
            kmer_size,
            n_reads,
        )
        self.summary.update(mode="serial", threads=1)
        return run_interruptible(detector, self, raise_on_error=True)
