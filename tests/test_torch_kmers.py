"""The detect command's two k-mer torch ops against the JAX package.

``atropos_tpu_torch.commands.detect.kmers`` sorts and counts k-mer codes
(:func:`unique_counts`) and intersects a contaminant panel with a batch of
read sets (:func:`intersection_counts`) as torch ops on the run's device;
here on CPU tensors, the same code the card runs. They are held, at
tolerance 0, to ``atropos_tpu``'s device functions (``_device_count_fn``
and ``_device_intersect_fn``, which the reference reaches with
``ATROPOS_TPU_DEVICE_KMERS=1`` and int32 codes, so for k <= 13) and to
numpy for every packable k from 12 to 27: both sides of the thresholds,
sentinel pads, empty and one-element sets, all codes equal. Inputs are
made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from atropos_tpu.commands.detect import kmers as jax_kmers
from atropos_tpu_torch.commands.detect import kmers

from .test_torch_align import seeded

torch.set_num_threads(1)

THRESHOLD = kmers.DEVICE_MIN_CODES


def _codes(rng, k, size, distinct=None):
    """``size`` codes of k-mers, drawn from ``distinct`` values (so that
    runs repeat) spread over the whole code range."""
    top = 5 ** k
    pool = rng.integers(0, top, distinct or size, dtype=np.int64)
    pool[:2] = (0, top - 1)
    return pool[rng.integers(0, pool.shape[0], size)]


def _counted(before, kind="batches"):
    return kmers.DEVICE_KMER_COUNTS["cpu"][kind] - before


@pytest.mark.parametrize("k", range(12, 28))
def test_unique_counts_equal_numpy_for_every_packable_k(k):
    rng = seeded("kmer-count", k)
    for size in (THRESHOLD, THRESHOLD + 1, 3 * THRESHOLD + 17):
        flat = _codes(rng, k, size, distinct=size // 3)
        want = np.unique(flat, return_counts=True)
        got = kmers.unique_counts(flat, "cpu")
        assert got[0].dtype == np.int64 and got[1].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [12, 13])
@pytest.mark.parametrize("size", [THRESHOLD - 1, THRESHOLD, THRESHOLD + 1, 5 * THRESHOLD + 3])
def test_count_equals_the_jax_device_function(monkeypatch, k, size):
    """Both packages' counting step on both sides of the threshold: above
    it each runs its device function, below it numpy."""
    monkeypatch.setenv("ATROPOS_TPU_DEVICE_KMERS", "1")
    rng = seeded("kmer-count-jax", k, size)
    flat = _codes(rng, k, size, distinct=max(1, size // 5))
    jax_before = jax_kmers.DEVICE_KMER_COUNTS["batches"]
    before = kmers.DEVICE_KMER_COUNTS["cpu"]["batches"]
    want = jax_kmers._unique_counts(flat)
    got = kmers._unique_counts(flat, "cpu")
    on_device = size >= THRESHOLD
    assert jax_kmers.DEVICE_KMER_COUNTS["batches"] - jax_before == on_device
    assert _counted(before) == on_device
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("case", ["empty", "one", "all-equal", "two-runs", "extremes"])
def test_unique_counts_edges(case):
    top = 5 ** kmers.MAX_PACKED_K - 1
    flat = {
        "empty": np.empty(0, np.int64),
        "one": np.array([12345], np.int64),
        "all-equal": np.full(THRESHOLD + 5, 77, np.int64),
        "two-runs": np.repeat(np.array([top, 0], np.int64), THRESHOLD),
        "extremes": np.array([top, 0, top, 1, 0], np.int64),
    }[case]
    got = kmers.unique_counts(flat, "cpu")
    want = np.unique(flat, return_counts=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _reads(rng, n, length, alphabet="ACGTN"):
    return [
        "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet), int(m)))
        for m in rng.integers(length // 2, length + 1, n)
    ]


@pytest.mark.parametrize("k", [12, 13, 16, 21, 27])
@pytest.mark.parametrize("with_membership", [False, True])
def test_count_corpus_equals_the_reference(monkeypatch, k, with_membership):
    """The whole counting table, with unpackable sequences (a byte outside
    ACGTN) among the rest, above the threshold."""
    rng = seeded("corpus", k, with_membership)
    reads = _reads(rng, 400, 100)
    # repeated reads and an adapter make long runs
    reads += reads[:40] + ["AGATCGGAAGAGCACACGTCTGAACTCCAGTCA" * 2] * 30
    reads += ["ACGTRYACGTACGTACGTACGTACGTACGTAC"]
    monkeypatch.setenv("ATROPOS_TPU_DEVICE_KMERS", "1")
    want = jax_kmers.count_corpus(reads, k, with_membership=with_membership)
    before = kmers.DEVICE_KMER_COUNTS["cpu"]["batches"]
    got = kmers.count_corpus(reads, k, with_membership=with_membership, device="cpu")
    assert _counted(before) == 1
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("k", [12, 14])
def test_unpack_all_equals_unpack(k):
    rng = seeded("unpack", k)
    codes = _codes(rng, k, 500)
    assert kmers.unpack_all(codes, k) == [jax_kmers.unpack(int(c), k) for c in codes]
    assert kmers.unpack_all(np.empty(0, np.int64), k) == []


def _sets(rng, n, low, high, top):
    return [np.unique(rng.integers(0, top, int(m))) for m in rng.integers(low, high, n)]


@pytest.mark.parametrize("n_contam,n_reads", [(24, 64), (16, 16), (15, 17), (1, 300), (255, 1)])
def test_intersections_equal_the_jax_device_function(monkeypatch, n_contam, n_reads):
    """Both packages' panel step on both sides of M x R = 256, with empty
    and one-element read sets among the rest (int32 codes, the
    reference's device range)."""
    monkeypatch.setenv("ATROPOS_TPU_DEVICE_KMERS", "1")
    rng = seeded("intersect-jax", n_contam, n_reads)
    contams = _sets(rng, n_contam, 1, 90, 3000)
    reads = _sets(rng, n_reads, 1, 50, 3000)
    reads[0] = np.empty(0, np.int64)
    if n_reads > 2:
        reads[1] = reads[2][:1]
    jax_before = jax_kmers.DEVICE_KMER_COUNTS["intersect_batches"]
    before = kmers.DEVICE_KMER_COUNTS["cpu"]["intersect_batches"]
    want = jax_kmers.batch_intersections(contams, reads)
    got = kmers.batch_intersections(contams, reads, "cpu")
    on_device = n_contam * n_reads >= kmers.DEVICE_MIN_PAIRS
    assert jax_kmers.DEVICE_KMER_COUNTS["intersect_batches"] - jax_before == on_device
    assert _counted(before, "intersect_batches") == on_device
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [13, 20, 27])
def test_intersections_of_int64_codes_equal_numpy(k):
    """Codes up to 5^27 - 1, the largest below the sentinel; contaminant
    rows of unequal length, so that the short ones carry sentinel pads
    that a read's own pads must not hit."""
    rng = seeded("intersect-int64", k)
    top = 5 ** k
    contams = _sets(rng, 20, 1, 60, top)
    reads = [np.unique(np.concatenate([c[: int(rng.integers(0, c.shape[0] + 1))],
                                       rng.integers(0, top, 5)])) for c in contams]
    reads += [np.array([top - 1]), np.empty(0, np.int64)]
    contams[3] = np.array([top - 1])
    got = kmers.batch_intersections(contams, reads, "cpu")
    want = np.array([[kmers.intersection_size(c, r) for r in reads] for c in contams])
    np.testing.assert_array_equal(got, want)


def test_intersections_sentinel_pads_never_hit():
    """Rows that are all pads on either side count nothing, and a read
    code beyond every code of a row is clipped to the row's last entry."""
    pad = kmers.SENTINEL
    contams = np.array([[1, 5, 9, pad], [pad, pad, pad, pad], [2, 3, pad, pad]], np.int64)
    reads = np.array([[1, 9, 10, pad], [pad, pad, pad, pad], [3, 100, pad, pad]], np.int64)
    got = kmers.intersection_counts(contams, reads, "cpu")
    np.testing.assert_array_equal(got, [[2, 0, 0], [0, 0, 0], [0, 0, 1]])


def test_intersections_in_chunks_of_contaminants(monkeypatch):
    """A panel larger than one chunk's budget gives the same matrix."""
    rng = seeded("intersect-chunks")
    contams = kmers.padded_rows(_sets(rng, 37, 1, 40, 500))
    reads = kmers.padded_rows(_sets(rng, 23, 0, 30, 500))
    whole = kmers.intersection_counts(contams, reads, "cpu")
    monkeypatch.setattr(kmers, "INTERSECT_CHUNK_ELEMENTS", reads.size * 5)
    np.testing.assert_array_equal(kmers.intersection_counts(contams, reads, "cpu"), whole)
    monkeypatch.setattr(kmers, "INTERSECT_CHUNK_ELEMENTS", 1)
    np.testing.assert_array_equal(kmers.intersection_counts(contams, reads, "cpu"), whole)


def test_ops_without_a_card_raise():
    from atropos_tpu_torch import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a card is present: None means cuda there")
    with pytest.raises(DeviceUnavailableError):
        kmers.unique_counts(np.arange(5), None)
    with pytest.raises(DeviceUnavailableError):
        kmers.intersection_counts(np.zeros((1, 1), np.int64), np.zeros((1, 1), np.int64))
    # below the thresholds numpy counts, on the host, as in the reference
    assert kmers.count_corpus(["ACGTACGTACGTACGT"], 12) == jax_kmers.count_corpus(
        ["ACGTACGTACGTACGT"], 12)
