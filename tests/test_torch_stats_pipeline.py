"""Per-record ``--stats`` on the per-record pipeline against the JAX package.

The reference collects the statistics of a configuration the turbo runner
declines one record at a time (``StatsRecordHandlerWrapper.handle_record``,
``ReadStatistics.collect_record``). The port notes each record where the
reference collects it and counts a batch's records into each table at
once (``ReadStatistics.collect_records``): one position-count call a table
and batch on the statistics' device. What must still follow the
reference's record order is checked here: the tables, the order in which
tiles and destinations first appear, the rule that turns qualities on at
the first record whose qualities are non-empty, ``round`` beside
``np.rint``. Inputs are made with numpy from a seed; adapters are named;
tolerance 0.
"""
import numpy as np
import pytest

from atropos_tpu.commands import stats as jax_stats
from atropos_tpu_torch.commands import stats as port_stats

from .test_torch_align import seeded
from .test_torch_engine_cli import run_both, tail
from .test_torch_turbo_pe import AD1, AD2, make_pairs, write_pairs
from .test_torch_turbo_se import TRUSEQ, make_reads, write_reads


def illumina_names(rng, n, tiles):
    """Read names in the Illumina format, the fifth field the tile; the
    tiles are drawn so that new ones keep appearing through the input."""
    picks = np.minimum(rng.integers(0, tiles, n), np.arange(n) // 7)
    return ["M0:12:FC{}:1:{}:{}:{}".format(i % 3, 1101 + int(t), int(rng.integers(1, 9999)),
                                           int(rng.integers(1, 9999)))
            for i, t in enumerate(picks)]


def _plain(value):
    """The summary with the count tables rendered, as the report reads them."""
    if isinstance(value, dict):
        return {key: _plain(item) for key, item in value.items()}
    if hasattr(value, "summarize"):
        return _plain(value.summarize())
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(item) for item in value)
    return value


def _records(rng, n, tiles=5, empty_every=0, none_every=0):
    out = []
    for i, name in enumerate(illumina_names(rng, n, tiles)):
        length = 0 if empty_every and i % empty_every == 0 else int(rng.integers(1, 90))
        seq = "".join("ACGTN"[int(b)] for b in rng.integers(0, 5, length))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, length))
        if none_every and i % none_every == 1:
            qual = None
        out.append((name, seq, qual))
    return out


@pytest.mark.parametrize("qualities,tiles,empty_every,none_every,batches", [
    (True, None, 0, 0, 3),
    (True, True, 0, 0, 4),
    (None, True, 50, 0, 2),  # the first record empty: qualities turn on later
    (None, None, 5, 0, 3),
    (True, True, 9, 4, 3),   # records without qualities among those with
    (False, True, 0, 0, 2),
])
def test_collect_records_equals_collect_record(qualities, tiles, empty_every, none_every,
                                               batches):
    """The port's batch collection against the reference's per record, for
    one table of single-end statistics, over batches of a stream."""
    rng = seeded("stats-records", empty_every * 10 + none_every + batches)
    records = _records(rng, 240, empty_every=empty_every, none_every=none_every)
    kwargs = dict(qualities=qualities, quality_base=33, tiles=tiles)
    from atropos_tpu.io.seqio import Sequence

    ref = jax_stats.SingleEndReadStatistics(**kwargs)
    for name, seq, qual in records:
        ref.collect(Sequence(name, seq, qual))
    port = port_stats.SingleEndReadStatistics(device="cpu", **kwargs)
    bounds = np.linspace(0, len(records), batches + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        port.collect_records(records[lo:hi])
    assert _plain(port.summarize()) == _plain(ref.summarize())
    if ref.track_tiles:
        assert list(port.tile_sequence_qualities) == list(ref.tile_sequence_qualities)
        assert list(port.tile_base_qualities.tiles) == list(ref.tile_base_qualities.tiles)
    assert list(port.sequence_qualities or ()) == list(ref.sequence_qualities or ())


def test_collect_records_paired():
    rng = seeded("stats-records-pe", 0)
    reads1 = _records(rng, 150, empty_every=11)
    reads2 = _records(rng, 150, none_every=13)
    from atropos_tpu.io.seqio import Sequence

    ref = jax_stats.PairedEndReadStatistics(qualities=None, quality_base=33, tiles=True)
    for one, two in zip(reads1, reads2):
        ref.collect(Sequence(*one), Sequence(*two))
    port = port_stats.PairedEndReadStatistics(
        qualities=None, quality_base=33, tiles=True, device="cpu")
    pairs = list(zip(reads1, reads2))
    port.collect_records(pairs[:70])
    port.collect_records(pairs[70:])
    assert _plain(port.summarize()) == _plain(ref.summarize())


def test_a_tile_the_names_do_not_carry_fails_as_in_the_reference():
    from atropos_tpu.io.seqio import Sequence

    records = [("M0:1:FC:1:1101:5:5", "ACGT", "IIII"), ("plain", "ACGT", "IIII")]
    ref = jax_stats.SingleEndReadStatistics(qualities=True, tiles=True)
    with pytest.raises(ValueError) as want:
        for record in records:
            ref.collect(Sequence(*record))
    port = port_stats.SingleEndReadStatistics(qualities=True, tiles=True, device="cpu")
    with pytest.raises(ValueError) as got:
        port.collect_records(records)
    assert str(got.value) == str(want.value)


#: (extra argv, statistics) of the single-end command lines; every one is
#: declined by the turbo runner
SE_CASES = [
    (["--times", "2"], "pre"),
    (["--mask-adapter"], "post"),
    (["-n", "2", "-y", "_{name}"], "both"),
    (["--times", "2", "-q", "15", "-m", "20", "--too-short-output", "{tmp}/short.fastq"],
     "both:tiles"),
    (["--no-trim", "--discard-untrimmed"], "both:tiles"),
]


@pytest.mark.parametrize("extra,spec", SE_CASES, ids=lambda e: e if isinstance(e, str)
                         else " ".join(e[:2]))
def test_stats_on_the_pipeline_single_end(tmp_path, monkeypatch, extra, spec):
    rng = seeded("stats-se", len(extra) * 7 + len(spec))
    records = make_reads(rng, 260, "ACGTN", adapters=(TRUSEQ,))
    names = illumina_names(rng, len(records), 6)
    records = [(name,) + record[1:] for name, record in zip(names, records)]
    inp = write_reads(str(tmp_path / "in.fastq"), records)
    out = str(tmp_path / "out.fastq")
    outs = [out] + [x.replace("{tmp}", str(tmp_path)) for x in extra if "{tmp}" in x]
    argv = ["-a", "tru=" + TRUSEQ] + [x.replace("{tmp}", str(tmp_path)) for x in extra]
    argv += ["--stats", spec, "--batch-size", "50", "-se", inp, "-o", out] + tail(tmp_path)
    calls = dict(port_stats.DEVICE_STATS_COUNTS)
    run = run_both(argv, outs, str(tmp_path / "report.txt"), monkeypatch)
    summary = run[2]
    for side in ("pre", "post"):
        assert (side in summary) == (side in spec or spec.startswith("both"))
    if spec.endswith("tiles"):
        (source,) = summary["pre"].values()
        assert len(source["read1"]["tile_sequence_qualities"]["rows"]) == 6
    # a batch's records are counted at once: far fewer calls than records
    assert 0 < port_stats.DEVICE_STATS_COUNTS["cpu"] - calls["cpu"] < len(records)


@pytest.mark.parametrize("aligner,spec", [
    ("adapter", "both:tiles"), ("insert", "both"), ("insert", "pre:tiles"),
])
def test_stats_on_the_pipeline_paired_end(tmp_path, monkeypatch, aligner, spec):
    """Paired-end ``--stats`` on configurations the turbo runner declines;
    with the insert aligner there is no engine (the statistics wrapper is
    no plain record handler), so each pair's insert match runs on the
    scalar aligner, in both packages."""
    rng = seeded("stats-pe", len(aligner) + len(spec))
    pairs = make_pairs(rng, 120, 100, "ACGT", n_rate=0.01)
    names = illumina_names(rng, len(pairs), 4)
    pairs = [
        tuple((name + "/" + str(mate + 1),) + read[1:] for mate, read in enumerate(pair))
        for name, pair in zip(names, pairs)
    ]
    inputs = write_pairs(tmp_path, pairs)
    outs = [str(tmp_path / "o1.fastq"), str(tmp_path / "o2.fastq")]
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "--times", "2",
            "--stats", spec, "--batch-size", "40",
            "-pe1", inputs[0], "-pe2", inputs[1], "-o", outs[0], "-p", outs[1]]
    run = run_both(argv + tail(tmp_path), outs, str(tmp_path / "report.txt"), monkeypatch)
    build, _ = run[4]
    assert build == {"engine": 0, "fallback": 0}
