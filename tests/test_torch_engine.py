"""The batched engine and the pair modifiers of the per-record pipeline
against the JAX package.

``BatchMatcher.best_matches`` and ``match_rounds`` (plain adapters, the
prefix/suffix matcher of anchored no-indel adapters, IUPAC wildcards on
both sides, linked adapters, ``times`` 1 to 3) and
``BatchInsertMatcher.candidates`` (windows up to 255 and above, more than
14 symbols, near-poly-A pairs) give the reference's matches and
candidate lists on the same reads, with the same changes of
``MATCH_COUNTS``; ``TrimEngine.build`` counts the same outcomes with the
same fallback reasons. ``ErrorCorrectorMixin`` (actions N, conservative
and liberal), ``MergeOverlapping`` (all four geometries),
``SwiftBisulfiteTrimmer`` and ``OverwriteRead`` give the reference's reads
and statistics on constructed pairs.

All inputs are made from a seed with numpy; every adapter is named;
tolerance 0.
"""
import types

import numpy as np
import pytest
import torch

from atropos_tpu import engine as jax_engine
from atropos_tpu.adapters import AdapterParser as JaxParser
from atropos_tpu.adapters import LinkedMatch as JaxLinkedMatch
from atropos_tpu.align import SEMIGLOBAL
from atropos_tpu.align import Aligner as JaxAligner
from atropos_tpu.align.batched import BatchInsertMatcher as JaxInsertMatcher
from atropos_tpu.commands.trim import modifiers as jax_mod
from atropos_tpu.io.seqio import Sequence as JaxSequence
from atropos_tpu_torch import engine as port_engine
from atropos_tpu_torch.adapters import AdapterParser as PortParser
from atropos_tpu_torch.align import insert_kernel
from atropos_tpu_torch.align.batched import BatchInsertMatcher as PortInsertMatcher
from atropos_tpu_torch.commands.trim import modifiers as port_mod
from atropos_tpu_torch.io.seqio import Sequence as PortSequence

from .test_torch_align import _bases, seeded
from .test_torch_turbo_se import ANYWHERE, FRONT, TRUSEQ, make_reads

torch.set_num_threads(1)

SIDES = {
    "jax": (JaxParser, JaxSequence, jax_mod, jax_engine),
    "port": (PortParser, PortSequence, port_mod, port_engine),
}


def _match_tuple(match):
    if match is None:
        return None
    if isinstance(match, (JaxLinkedMatch, port_engine.LinkedMatch)):
        return ("linked", _match_tuple(match.front_match),
                _match_tuple(match.back_match), match.adapter.name)
    return (match.astart, match.astop, match.rstart, match.rstop, match.matches,
            match.errors, match.front, match.adapter.sequence, match.adapter.where)


def _read_tuple(read):
    return None if read is None else (read.name, read.sequence, read.qualities)


# -- BatchMatcher ------------------------------------------------------------------

#: (adapter specs as (spec, command-line type), adapter options, reads' alphabet)
MATCHER_CASES = {
    "plain": ([("tru=" + TRUSEQ, "back"), ("front=" + FRONT, "front"),
               ("anyw=" + ANYWHERE, "anywhere")], {}, "ACGTN"),
    "indel_cost": ([("tru=" + TRUSEQ, "back"), ("anyw=" + ANYWHERE, "anywhere")],
                   dict(indel_cost=2, max_error_rate=0.2), "ACGT"),
    "anchored_no_indels": ([("anch=" + TRUSEQ[:12] + "$", "back"),
                            ("pre=^" + FRONT, "front")], dict(indels=False), "ACGTN"),
    "wildcards": ([("wild=ACGTNNNACGTRYK", "back"), ("pre=^ACGTNRAC", "front")],
                  dict(read_wildcards=True, indels=False), "ACGTNRYKMSWBDHV"),
    "wildcards_indels": ([("wild=ACGTNNNACGTRYK", "back")],
                         dict(read_wildcards=True), "ACGTNRYKMSWBDHV"),
    "linked": ([("link=" + FRONT + "..." + ANYWHERE, "back")], {}, "ACGT"),
    "linked_no_indels": ([("link=" + FRONT + "..." + ANYWHERE, "back")],
                         dict(indels=False), "ACGT"),
}


def _matcher_reads(rng, alphabet, linked):
    records = make_reads(
        rng, 160, alphabet, max_len=120,
        adapters=(TRUSEQ, FRONT, ANYWHERE, "ACGTAACGTACGTAA"),
    )
    for i in range(30):
        # anchored copies at the read's start and end, now and then mutated
        body = _bases(rng, int(rng.integers(0, 40)))
        front, back = list(FRONT), list(TRUSEQ[:12])
        if i % 3 == 0:
            front[int(rng.integers(len(front)))] = "N"
            back[int(rng.integers(len(back)))] = "T"
        seq = "".join(front) + body + "".join(back)
        records.append(("a{}".format(i), seq, "I" * len(seq)))
    if linked:
        # front-anchored copies, some with nothing after the front part
        # (an empty remainder), some with the back part after a gap
        for i in range(40):
            tail = ("", ANYWHERE, _bases(rng, 6) + ANYWHERE[:7],
                    _bases(rng, 20))[i % 4]
            seq = FRONT + tail
            records.append(("l{}".format(i), seq, "I" * len(seq)))
    return records


def _build(side, specs, options, times):
    parser_cls, sequence_cls, mod, engine_mod = SIDES[side]
    parser = parser_cls(**options)
    adapters = [parser.parse_from_spec(spec, kind) for spec, kind in specs]
    cutter = mod.AdapterCutter(adapters, times=times)
    if side == "jax":
        matcher = engine_mod.BatchMatcher(cutter)
    else:
        matcher = engine_mod.BatchMatcher(cutter, "cpu")
    return sequence_cls, matcher


@pytest.mark.parametrize("times", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(MATCHER_CASES))
def test_batch_matcher(case, times):
    specs, options, alphabet = MATCHER_CASES[case]
    rng = seeded("engine-matcher", case, times)
    records = _matcher_reads(rng, alphabet, case.startswith("linked"))
    found = {}
    for side in ("jax", "port"):
        sequence_cls, matcher = _build(side, specs, options, times)
        reads = [sequence_cls(*rec) for rec in records]
        counts = dict(SIDES[side][3].MATCH_COUNTS)
        best = [_match_tuple(m) for m in matcher.best_matches(reads)]
        rounds = [
            ([_match_tuple(m) for m in matches], _read_tuple(final))
            for matches, final in matcher.match_rounds(reads, times)
        ]
        delta = {
            key: SIDES[side][3].MATCH_COUNTS[key] - counts[key] for key in counts
        }
        found[side] = (best, rounds, delta)
    assert found["jax"] == found["port"]
    best, rounds, delta = found["port"]
    assert sum(m is not None for m in best) > 10
    assert delta["scalar_reads"] == 0 and delta["batched"] > 0
    if times > 1 and not case.startswith("linked"):
        assert any(len(matches) > 1 for matches, _ in rounds)


def test_batch_matcher_pads_to_whole_warps(monkeypatch):
    """The DP runs over batches padded to powers of two from 64 reads."""
    shapes = []
    real = port_engine.BatchAligner.locate_batch

    def spy(self, reads_u8, lengths):
        shapes.append(reads_u8.shape)
        return real(self, reads_u8, lengths)

    monkeypatch.setattr(port_engine.BatchAligner, "locate_batch", spy)
    rng = seeded("engine-pad")
    for n_reads in (1, 64, 65, 300):
        _, matcher = _build("port", [("tru=" + TRUSEQ, "back")], {}, 1)
        reads = [PortSequence(*rec) for rec in make_reads(rng, n_reads)]
        assert len(matcher.best_matches(reads)) == n_reads
    assert [rows for rows, _ in shapes] == [64, 64, 128, 512]
    assert all(width % 32 == 0 for _, width in shapes)


# -- BatchInsertMatcher ---------------------------------------------------------------

def _insert_batch(rng, n_pairs, width, alphabet, poly_a=0):
    """[B, W] ref (rc of mate 2) and query (mate 1) planes and lengths of
    pairs from both ends of random inserts, as ``TrimEngine`` builds them."""
    refs = np.zeros((n_pairs, width), np.uint8)
    queries = np.zeros((n_pairs, width), np.uint8)
    lengths = np.zeros(n_pairs, np.int32)
    letters = np.frombuffer(alphabet.encode(), np.uint8)
    for b in range(n_pairs):
        length = int(rng.integers(1, width + 1)) if b % 7 else width
        if b < poly_a:
            query = bytearray(b"A" * length)
            query[int(rng.integers(0, length))] = ord("C")
            ref = b"A" * length
        else:
            insert = letters[rng.integers(0, len(letters), length)].tobytes()
            shift = int(rng.integers(0, max(1, length // 3)))
            query = insert
            # diagonal ``shift`` holds the overlap: ref[shift + t] == query[t]
            ref = letters[rng.integers(0, 4, shift)].tobytes() + insert[: length - shift]
            ref = bytearray(ref)
            for pos in rng.integers(0, length, int(rng.integers(0, 4))):
                ref[int(pos)] = int(letters[int(rng.integers(len(letters)))])
        queries[b, :length] = np.frombuffer(bytes(query), np.uint8)
        refs[b, :length] = np.frombuffer(bytes(ref), np.uint8)
        lengths[b] = length
    return refs, queries, lengths


@pytest.mark.parametrize("width,alphabet,poly_a,kernel", [
    (150, "ACGT", 0, "diag_counts_u8"),
    (255, "ACGTN", 4, "diag_counts_u8"),
    (300, "ACGT", 0, "diag_counts_i32"),
    (120, "ACGTNRYKMSWBDHV", 0, "diag_counts_i32"),
])
def test_batch_insert_matcher_candidates(monkeypatch, width, alphabet, poly_a, kernel):
    rng = seeded("engine-insert", width, alphabet)
    refs, queries, lengths = _insert_batch(rng, 90, width, alphabet, poly_a)
    chosen = []
    real = insert_kernel.kernel_for

    def spy(W, n_symbols):
        chosen.append(real(W, n_symbols).name)
        return real(W, n_symbols)

    monkeypatch.setattr(insert_kernel, "kernel_for", spy)
    for err in (0.1, 0.2):
        expected = JaxInsertMatcher(err, min_overlap=1, max_matches=100).candidates(
            refs, queries, lengths
        )
        got = PortInsertMatcher(err, min_overlap=1, max_matches=100).candidates(
            refs, queries, lengths, "cpu"
        )
        assert got == expected
        assert sum(c is not None for c in got) > 20
    assert chosen == [kernel, kernel]


# -- TrimEngine.build -------------------------------------------------------------------


def _chain(side, n_cutters, insert=False):
    parser_cls, _, mod, _ = SIDES[side]
    parser = parser_cls()
    if insert:
        chain = mod.PairedEndModifiers("both")
        chain.add_modifier(
            mod.InsertAdapterCutter,
            adapter1=parser.parse_from_spec("ad1=" + TRUSEQ),
            adapter2=parser.parse_from_spec("ad2=" + FRONT),
        )
        return chain
    chain = mod.SingleEndModifiers()
    chain.add_modifier(mod.UnconditionalCutter, lengths=[2])
    for i in range(n_cutters):
        chain.add_modifier(
            mod.AdapterCutter,
            adapters=[parser.parse_from_spec("ad{}={}".format(i, TRUSEQ))],
        )
    return chain


@pytest.mark.parametrize("n_cutters,insert,outcome", [
    (1, False, "engine"), (0, False, "no adapter cutter stage"),
    (2, False, "multiple AdapterCutter stages"), (0, True, "engine"),
])
def test_trim_engine_build_counts(n_cutters, insert, outcome):
    results = {}
    for side in ("jax", "port"):
        engine_mod = SIDES[side][3]
        options = types.SimpleNamespace(
            colorspace=False, paired="both" if insert else False, device="cpu"
        )
        before = dict(engine_mod.BUILD_COUNTS)
        built = engine_mod.TrimEngine.build(_chain(side, n_cutters, insert), options)
        results[side] = (
            built is None,
            {k: engine_mod.BUILD_COUNTS[k] - before[k] for k in before},
            engine_mod.LAST_FALLBACK_REASON,
        )
    assert results["jax"] == results["port"]
    assert results["port"][2] == (None if outcome == "engine" else outcome)


# -- pair modifiers ------------------------------------------------------------------


def _pair_records(rng, geometry, length=60, mismatches=3, tie=False):
    """(read1, read2) records whose overlap has the ``geometry`` of a merge:
    "read2_inside" and "read1_inside" (one read within the other), "right"
    (read1's tail overlaps read2's head) and "left" (read2's tail overlaps
    read1's head); ``mismatches`` bases of the overlap differ, with equal
    qualities where ``tie``."""
    insert = _bases(rng, 2 * length)
    if geometry == "read2_inside":
        seq1, rc2 = insert[:length], insert[10 : length - 10]
    elif geometry == "read1_inside":
        seq1, rc2 = insert[10 : length - 10], insert[:length]
    elif geometry == "right":
        seq1, rc2 = insert[:length], insert[length // 3 : length // 3 + length]
    else:
        seq1, rc2 = insert[length // 3 : length // 3 + length], insert[:length]
    seq2 = list(rc2.translate(str.maketrans("ACGT", "TGCA"))[::-1])
    qual1 = [chr(33 + int(q)) for q in rng.integers(10, 41, len(seq1))]
    qual2 = [chr(33 + int(q)) for q in rng.integers(10, 41, len(seq2))]
    for pos in rng.permutation(min(len(seq1), len(seq2)) // 2)[:mismatches]:
        pos = int(pos) + min(len(seq1), len(seq2)) // 4
        seq2[pos] = "N" if pos % 5 == 0 else ("A" if seq2[pos] != "A" else "C")
        if tie:
            qual2[pos] = qual1[min(pos, len(qual1) - 1)]
    return (("r1", seq1, "".join(qual1)), ("r2", "".join(seq2), "".join(qual2)))


class _Corrector:
    """A bare ``ErrorCorrectorMixin`` of each package."""

    @staticmethod
    def make(side, action):
        mixin = SIDES[side][2].ErrorCorrectorMixin
        obj = type("Corrector", (mixin,), {})()
        mixin.__init__(obj, action)
        return obj


@pytest.mark.parametrize("action", ["N", "conservative", "liberal"])
@pytest.mark.parametrize("geometry,truncate", [
    ("read2_inside", False), ("read1_inside", False), ("right", False),
    ("left", False), ("right", True), ("left", True),
])
def test_error_corrector(geometry, action, truncate):
    """``truncate_seqs`` (the insert cutter's call) on pairs of equal
    length, whose overlap coordinates hold for the truncated reads."""
    rng = seeded("engine-correct", geometry, action, truncate)
    cases = [_pair_records(rng, geometry, tie=i % 2 == 1) for i in range(6)]
    results = {}
    for side in ("jax", "port"):
        sequence_cls = SIDES[side][1]
        corrector = _Corrector.make(side, action)
        out = []
        for rec1, rec2 in cases:
            read1, read2 = sequence_cls(*rec1), sequence_cls(*rec2)
            rc2 = read2.reverse_complement().sequence
            alignment = JaxAligner(rc2, 0.2, SEMIGLOBAL).locate(read1.sequence)
            corrector.correct_errors(read1, read2, alignment, truncate_seqs=truncate)
            out.append((_read_tuple(read1), _read_tuple(read2), read1.corrected,
                        read2.corrected))
        results[side] = (out, corrector.summarize())
    assert results["jax"] == results["port"]
    assert results["port"][1]["records_corrected"] > 0


@pytest.mark.parametrize("action", [None, "N", "conservative", "liberal"])
def test_merge_overlapping(action):
    rng = seeded("engine-merge", action)
    cases = [
        _pair_records(rng, geometry, tie=i % 3 == 0)
        for i in range(3)
        for geometry in ("read2_inside", "read1_inside", "right", "left")
    ]
    cases.append((("r1", _bases(rng, 50), "I" * 50), ("r2", _bases(rng, 50), "I" * 50)))
    results = {}
    for side in ("jax", "port"):
        sequence_cls, mod = SIDES[side][1], SIDES[side][2]
        merger = mod.MergeOverlapping(min_overlap=0.5, error_rate=0.2,
                                      mismatch_action=action)
        out = []
        for rec1, rec2 in cases:
            read1, read2 = merger(sequence_cls(*rec1), sequence_cls(*rec2))
            out.append((_read_tuple(read1), _read_tuple(read2), read1.merged))
        results[side] = (out, merger.summarize())
    assert results["jax"] == results["port"]
    merged = [item[2] for item in results["port"][0]]
    assert sum(merged) >= 10 and not merged[-1]


def test_swift_bisulfite_and_overwrite():
    rng = seeded("engine-swift")
    cases = [_pair_records(rng, "right", length=int(rng.integers(5, 60))) for _ in range(20)]
    results = {}
    for side in ("jax", "port"):
        sequence_cls, mod = SIDES[side][1], SIDES[side][2]
        swift = mod.SwiftBisulfiteTrimmer()
        overwrite = mod.OverwriteRead(20, 25, 8)
        out = []
        for rec1, rec2 in cases:
            pair = swift(sequence_cls(*rec1), sequence_cls(*rec2))
            out.append(tuple(_read_tuple(read) for read in pair))
            pair = overwrite(sequence_cls(*rec1), sequence_cls(*rec2))
            out.append(tuple(_read_tuple(read) for read in pair))
        results[side] = (out, swift.summarize())
    assert results["jax"] == results["port"]
