"""Packed-integer k-mer machinery for contaminant detection.

Counterpart of ``atropos_tpu/commands/detect/kmers.py``. Every window is
packed into a base-5 integer code (A,C,G,T,N -> 0..4) with one
sliding-window matrix multiply, and counting and membership reduce to
sorts and run-length scans over flat int64 arrays. Sequences holding
bytes outside ACGTN (or k-mers too long to pack, k > 27) go through
string slicing, so what the detectors see never changes.

Two of these steps are torch ops on the run's device, above the
reference's own thresholds (numpy below them, as there):

- :func:`unique_counts`: sort the codes and count each run
  (``torch.unique(sorted=True, return_counts=True)``), for 2^14 codes and
  more;
- :func:`intersection_counts`: the ``[M, R]`` sizes of the intersections
  of M sorted contaminant code sets with R sorted read code sets, by a
  batched ``torch.searchsorted``, for M x R >= 256 pairs.

Codes are int64 for every packable k; the int64 sentinel that pads the
sets' rows lies above every code (5^27 - 1 < 2^63 - 1), so pads sort last
and never hit. ``DEVICE_KMER_COUNTS`` counts the ops by device type.
"""
import numpy as np
import torch

from atropos_tpu_torch import resolve_device

_CODES = np.full(256, 4, np.int64)
for _i, _base in enumerate(b"ACGT"):
    _CODES[_base] = _i
_ALPHABET = "ACGTN"
_ALPHABET_BYTES = np.frombuffer(_ALPHABET.encode("ascii"), np.uint8)
_VALID = frozenset(_ALPHABET)

#: largest k such that 5**k fits in int64
MAX_PACKED_K = 27

#: the ops that ran on a device, by its type: k-mer sorts and counts
#: (``batches``) and contaminant intersection panels (``intersect_batches``)
DEVICE_KMER_COUNTS = {
    "cuda": {"batches": 0, "intersect_batches": 0},
    "cpu": {"batches": 0, "intersect_batches": 0},
}

#: fewest codes whose count runs as a torch op (the reference's threshold)
DEVICE_MIN_CODES = 1 << 14
#: fewest (contaminant, read) pairs whose intersections run as a torch op
DEVICE_MIN_PAIRS = 256
#: int64 elements of one intersection chunk's intermediates
INTERSECT_CHUNK_ELEMENTS = 1 << 26
SENTINEL = np.iinfo(np.int64).max


def unique_counts(codes, device=None):
    """``(codes, counts)`` of a flat int64 code array, counted on ``device``
    (None means ``cuda``): the distinct codes in ascending order and how
    often each occurs, equal to ``np.unique(codes, return_counts=True)``.
    Returns host int64 arrays."""
    device = resolve_device(device)
    flat = torch.as_tensor(np.ascontiguousarray(codes, np.int64)).to(device)
    values, counts = torch.unique(flat, sorted=True, return_counts=True)
    DEVICE_KMER_COUNTS[device.type]["batches"] += 1
    return values.cpu().numpy(), counts.to(torch.int64).cpu().numpy()


def padded_rows(sets):
    """``[len(sets), max size]`` int64 matrix of sorted code sets, each row
    padded with :data:`SENTINEL`."""
    width = max((arr.shape[0] for arr in sets), default=0)
    out = np.full((len(sets), width), SENTINEL, np.int64)
    for row, arr in enumerate(sets):
        out[row, : arr.shape[0]] = arr
    return out


def intersection_counts(contams, reads, device=None):
    """``[M, R]`` int64 intersection sizes of the rows of ``contams``
    (``[M, C]``) with the rows of ``reads`` (``[R, Q]``), both sorted,
    unique within a row and padded with :data:`SENTINEL`, computed on
    ``device`` (None means ``cuda``): each read code is searched in each
    contaminant row (``side='left'``), the index clipped to the row, and a
    hit is an equal code that is no pad. Contaminants are taken in chunks
    whose ``[m, R x Q]`` intermediates hold at most
    ``INTERSECT_CHUNK_ELEMENTS`` elements. Returns a host array."""
    device = resolve_device(device)
    n_contam, width = contams.shape
    n_reads, r_width = reads.shape
    contam_t = torch.as_tensor(np.ascontiguousarray(contams, np.int64)).to(device)
    read_t = torch.as_tensor(np.ascontiguousarray(reads, np.int64)).to(device)
    flat = read_t.reshape(1, -1)
    live = flat != SENTINEL
    step = max(1, INTERSECT_CHUNK_ELEMENTS // max(1, flat.shape[1]))
    out = torch.empty((n_contam, n_reads), dtype=torch.int64, device=device)
    for lo in range(0, n_contam, step):
        rows = contam_t[lo : lo + step]
        queries = flat.expand(rows.shape[0], -1).contiguous()
        idx = torch.searchsorted(rows, queries).clamp_(max=width - 1)
        hit = (torch.gather(rows, 1, idx) == queries) & live
        out[lo : lo + step] = hit.reshape(rows.shape[0], n_reads, r_width).sum(dim=2)
    DEVICE_KMER_COUNTS[device.type]["intersect_batches"] += 1
    return out.cpu().numpy()


def _unique_counts(flat, device):
    """(codes, counts) over a flat packed-code array: the torch op on
    ``device`` from :data:`DEVICE_MIN_CODES` codes, numpy below."""
    if flat.size >= DEVICE_MIN_CODES:
        return unique_counts(flat, device)
    return np.unique(flat, return_counts=True)


def packable(seq, k):
    """Whether ``seq``'s k-mers can be represented as packed codes."""
    return k <= MAX_PACKED_K and not (set(seq) - _VALID)


def pack_windows(seq, k):
    """int64 codes of every k-window of ``seq`` (caller checks packable)."""
    data = _CODES[np.frombuffer(seq.encode("ascii"), np.uint8)]
    n_windows = data.shape[0] - k + 1
    if n_windows <= 0:
        return np.empty(0, np.int64)
    powers = 5 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(data, k)
    return windows @ powers


def unpack_all(codes, k):
    """The k-mers of an int64 array of codes, as a list of strings: the
    inverse of :func:`pack_windows`."""
    digits = np.empty((codes.shape[0], k), np.uint8)
    rest = codes.astype(np.int64, copy=True)
    for col in range(k - 1, -1, -1):
        digits[:, col] = _ALPHABET_BYTES[rest % 5]
        rest //= 5
    text = digits.tobytes().decode("ascii")
    return [text[i : i + k] for i in range(0, len(text), k)]


def packed_kmer_set(seq, k):
    """Sorted unique packed codes of ``seq`` (or None if unpackable)."""
    if not packable(seq, k):
        return None
    return np.unique(pack_windows(seq, k))


def count_corpus(seqs, k, with_membership=False, device=None):
    """Count every k-mer occurrence across ``seqs``.

    Returns {kmer_string: count} or, with membership,
    {kmer_string: [count, set_of_seqs]}, the structures the detectors
    consume, in the reference's order. Packed counting handles the ACGTN
    sequences in one pass (sorted and counted on ``device``); the rest go
    through string slicing.
    """
    seqs = list(seqs)
    packed_codes = []
    packed_owner = []
    slow = []
    for idx, seq in enumerate(seqs):
        if packable(seq, k):
            codes = pack_windows(seq, k)
            packed_codes.append(codes)
            if with_membership:
                packed_owner.append(np.full(codes.shape[0], idx, np.int64))
        else:
            slow.append(idx)

    table = {}
    if packed_codes:
        flat = np.concatenate(packed_codes)
        codes, counts = _unique_counts(flat, device)
        kmers = unpack_all(codes, k)
        counts = counts.tolist()
        if with_membership:
            owners = np.concatenate(packed_owner)
            # unique (code, owner) pairs -> membership lists per code
            pair_codes, pair_owners = _unique_pairs(flat, owners)
            bounds = np.searchsorted(pair_codes, codes).tolist()
            bounds.append(pair_codes.shape[0])
            pair_owners = pair_owners.tolist()
            for row, kmer in enumerate(kmers):
                table[kmer] = [
                    counts[row],
                    {seqs[owner] for owner in pair_owners[bounds[row] : bounds[row + 1]]},
                ]
        else:
            table.update(zip(kmers, counts))

    for idx in slow:
        seq = seqs[idx]
        for start in range(len(seq) - k + 1):
            kmer = seq[start : start + k]
            if with_membership:
                entry = table.setdefault(kmer, [0, set()])
                entry[0] += 1
                entry[1].add(seq)
            else:
                table[kmer] = table.get(kmer, 0) + 1
    return table


def _unique_pairs(codes, owners):
    """Unique (code, owner) pairs, sorted by code then owner."""
    order = np.lexsort((owners, codes))
    codes = codes[order]
    owners = owners[order]
    keep = np.ones(codes.shape[0], bool)
    keep[1:] = (codes[1:] != codes[:-1]) | (owners[1:] != owners[:-1])
    return codes[keep], owners[keep]


def intersection_size(set_a, set_b):
    """|A ∩ B| for two sorted unique code arrays."""
    return np.intersect1d(set_a, set_b, assume_unique=True).shape[0]


def batch_intersections(contam_sets, read_sets, device=None):
    """[M, R] intersection-size matrix between contaminant and read
    packed-code sets: the torch op on ``device`` from
    :data:`DEVICE_MIN_PAIRS` pairs (and non-empty sets), numpy pair by pair
    below. All inputs are sorted unique int code arrays."""
    n_contam = len(contam_sets)
    n_reads = len(read_sets)
    out = np.zeros((n_contam, n_reads), np.int64)
    if not n_contam or not n_reads:
        return out
    c_max = max(arr.shape[0] for arr in contam_sets)
    r_max = max((arr.shape[0] for arr in read_sets), default=0)
    if c_max > 0 and r_max > 0 and n_contam * n_reads >= DEVICE_MIN_PAIRS:
        return intersection_counts(
            padded_rows(contam_sets), padded_rows(read_sets), device
        )
    for m_idx, contam in enumerate(contam_sets):
        for r_idx, read in enumerate(read_sets):
            out[m_idx, r_idx] = intersection_size(contam, read)
    return out
