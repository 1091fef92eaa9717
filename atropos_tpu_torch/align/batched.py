"""Plain PyTorch version of the batched semi-global adapter DP.

Counterpart of ``atropos_tpu/align/batched.py``: the same DP the scalar
oracle (:mod:`atropos_tpu_torch.align.oracle`) specifies, over a batch of
reads, as a Python loop over the columns on ``[B, m + 1]`` tensors with
the cost, origin and matches of a cell kept as separate fields.

This is the *plain version* of the two CUDA kernels of
:mod:`atropos_tpu_torch.align.cuda_kernel`: the CPU tests and the on-card
comparison hold the kernels against it, and the main path runs it only
when the device is ``cpu``. It is written for clarity, not speed.

- **Band and stale cells.** The scalar kernel is column-sequential with
  Ukkonen banding whose band (``last``) evolves per column from computed
  costs, and abandoned cells keep stale values that are semantically
  observable. All ``m + 1`` rows are computed each column, the write-back
  is masked to ``i <= last[b]``, and ``last`` is carried per read.

- **Insertion chain.** Within a column a cell depends on the cell above it
  through insertions: ``new[i] = eq ? diag : min(diag+1, old[i]+D,
  new[i-1]+I)`` with the tie-break order diagonal > insertion > deletion.
  Candidates compete on the key ``cost * SUB + subkey`` (diagonal-born
  mismatches: ``m - i``; deletion-born and match cells: ``m + i``), which
  reproduces the sequential order for every pair of candidates, and the
  chain is resolved by ``d_max = k // ins_cost`` relaxation passes: a
  longer chain costs more than ``k`` and can never be observed. Only the
  rows the column writes relax (a row takes an insertion from the row above
  it, never from below, so the rows past ``last`` feed none that is
  written), and the passes stop at one that changes no row.

- **No float math.** ``cost <= length * max_error_rate`` is precomputed
  on the host with Python doubles into an integer table indexed by length.
"""
import numpy as np
import torch
from torch import nn

from atropos_tpu_torch.align.flags import (
    ACGT_TABLE,
    IUPAC_TABLE,
    START_WITHIN_SEQ1,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
)

#: names of the first seven result rows, in order
RESULT_ROWS = ("found", "start1", "stop1", "start2", "stop2", "matches", "cost")


def _upper_table():
    table = np.arange(256, dtype=np.uint8)
    for c in range(ord("a"), ord("z") + 1):
        table[c] = c - 32
    return table


_UPPER = _upper_table()


def encode_reads(sequences, pad_to=None, upper=False):
    """Encode a list of read strings into (uint8 array [B, L], lengths).

    Bytes are raw ASCII (optionally uppercased, which is the caller's
    semantic responsibility — the kernel itself is case-sensitive like the
    scalar one); wildcard translation happens later via lookup tables so
    one encoded batch serves all adapters.
    """
    batch = len(sequences)
    max_len = max((len(s) for s in sequences), default=0)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    arr = np.zeros((batch, max_len), dtype=np.uint8)
    lengths = np.zeros(batch, dtype=np.int32)
    for idx, seq in enumerate(sequences):
        encoded = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        arr[idx, : len(encoded)] = encoded
        lengths[idx] = len(encoded)
    if upper:
        arr = _UPPER[arr]
    return arr, lengths


def _translation_lut(wildcard_ref, wildcard_query, for_query):
    """256-entry wildcard-translation LUT, mirroring the scalar kernel's
    rules (``_align.pyx:292-298``): query gets IUPAC if wildcard_query else
    ACGT if wildcard_ref; reference gets IUPAC if wildcard_ref else ACGT if
    wildcard_query; identity if neither."""
    lut = np.arange(256, dtype=np.uint8)
    if for_query:
        table = IUPAC_TABLE if wildcard_query else (
            ACGT_TABLE if wildcard_ref else None
        )
    else:
        table = IUPAC_TABLE if wildcard_ref else (
            ACGT_TABLE if wildcard_query else None
        )
    if table is None:
        return lut
    table_arr = np.frombuffer(table, dtype=np.uint8)
    return table_arr[lut]


def _error_thresholds(m, max_error_rate):
    """thresh[length] = max admissible cost for an alignment of that ref
    length, computed with Python doubles: cost <= length * max_error_rate
    <=> cost <= floor(length * max_error_rate) for integer cost."""
    return np.array(
        [int(np.floor(length * max_error_rate)) for length in range(m + 1)],
        dtype=np.int32,
    )


def _locate_kernel(
    reads_T,
    lengths,
    ref,
    thresholds,
    *,
    m,
    k,
    flags,
    min_overlap,
    ins_cost,
    del_cost,
    compare_ascii,
    count_cells=False,
):
    """Plain batched DP: ``reads_T`` [L, B] uint8 (column-major, already
    wildcard-translated unless ``compare_ascii``), ``lengths`` [B] or
    [1, B] integers, ``ref`` [m] and ``thresholds`` [m + 1] integer
    tensors, all on one device. Returns the [8, B] int32 result rows
    (found, start1, stop1, start2, stop2, matches, cost, 0), equal per
    read to ``oracle.Aligner.locate``.

    With ``count_cells`` it also returns two counts: the cell updates the
    column-sequential algorithm needs on these reads (the sum of ``last``
    over every read's active columns), the work a kernel that walks only
    the band has to do; and the warp-level row slots (over each warp of 32
    neighbouring reads and each column, 32 times the largest ``last`` of
    its active reads), the lanes a kernel that runs a warp's rows in step
    occupies.
    """
    L, B = reads_T.shape
    dev = reads_T.device
    i64 = torch.int64
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & STOP_WITHIN_SEQ1)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)
    M1 = m + 1
    SUB = 2 * m + 2  # sub-keys lie in [0, 2m]

    n = lengths.reshape(-1).to(i64)  # [B]
    max_n = n if start_in_query else n.clamp(max=m + k)
    min_n = torch.zeros_like(n) if stop_in_query else (n - m - k).clamp(min=0)
    rows = torch.arange(M1, device=dev, dtype=i64)[None, :]  # [1, M1]
    mn = min_n[:, None]

    # initial column (reference ``_align.pyx:333-352``)
    if not start_in_ref and not start_in_query:
        cost = torch.maximum(rows, mn) * ins_cost
        origin = torch.zeros((B, M1), dtype=i64, device=dev)
    elif start_in_ref and not start_in_query:
        cost = (mn * ins_cost).expand(B, M1)
        origin = (mn - rows).clamp(max=0)
    elif not start_in_ref and start_in_query:
        cost = (rows * ins_cost).expand(B, M1)
        origin = (mn - rows).clamp(min=0)
    else:
        cost = torch.minimum(rows, mn) * ins_cost
        origin = mn - rows
    cost = cost.contiguous()
    matches = torch.zeros((B, M1), dtype=i64, device=dev)

    last = torch.full(
        (B,), m if start_in_ref else min(m, k + 1), dtype=i64, device=dev
    )
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    b_ref_stop = torch.full((B,), m, dtype=i64, device=dev)
    b_query_stop = n.clone()
    b_cost = m + n
    b_origin = torch.zeros(B, dtype=i64, device=dev)
    b_matches = torch.zeros(B, dtype=i64, device=dev)
    cells = torch.zeros((), dtype=i64, device=dev)
    row_slots = torch.zeros((), dtype=i64, device=dev)
    warps = -(-B // 32)

    ref64 = ref.to(i64)[None, :]  # [1, m]
    thr64 = thresholds.to(i64)
    pos = torch.arange(1, M1, device=dev, dtype=i64)[None, :]  # [1, m]
    sub_mismatch = m - pos   # diagonal-born mismatch candidates
    sub_other = m + pos      # deletion-born candidates and match cells
    d_max = 0 if ins_cost > k else min(m, k // ins_cost)

    for j in range(1, L + 1):
        active = (j > min_n) & (j <= max_n) & ~done  # [B]
        qc = reads_T[j - 1].to(i64)[:, None]  # [B, 1]
        if compare_ascii:
            eq = ref64 == qc  # [B, m]
        else:
            eq = (ref64 & qc) != 0

        # row 0 (reference ``_align.pyx:385-388``)
        if start_in_query:
            cost_0 = cost[:, :1]
            origin_0 = torch.full((B, 1), j, dtype=i64, device=dev)
        else:
            cost_0 = torch.full((B, 1), j * ins_cost, dtype=i64, device=dev)
            origin_0 = origin[:, :1]

        d_cost, d_origin, d_matches = cost[:, :-1], origin[:, :-1], matches[:, :-1]
        # mismatch cell: min(diag + 1, old + D), the diagonal winning ties
        key_mismatch = (d_cost + 1) * SUB + sub_mismatch
        key_del = (cost[:, 1:] + del_cost) * SUB + sub_other
        pick_diag = key_mismatch <= key_del
        # match cell: the forced diagonal, never an indel
        key = torch.where(
            eq,
            d_cost * SUB + sub_other,
            torch.where(pick_diag, key_mismatch, key_del),
        )
        org = torch.where(eq | pick_diag, d_origin, origin[:, 1:])
        mat = torch.where(
            eq, d_matches + 1, torch.where(pick_diag, d_matches, matches[:, 1:])
        )
        key = torch.cat([cost_0 * SUB + m, key], dim=1)
        org = torch.cat([origin_0, org], dim=1)
        mat = torch.cat([matches[:, :1], mat], dim=1)
        # masked write-back: rows 0..last of the active reads
        in_rows = rows <= last[:, None]
        write = active[:, None] & in_rows
        # insertion relaxation over the rows written; match cells are immune
        movable = write[:, 1:] & ~eq
        for _ in range(d_max):
            cand = key[:, :-1] + ins_cost * SUB
            take = (cand < key[:, 1:]) & movable
            if not bool(take.any()):
                break  # a fixed point
            key = torch.cat(
                [key[:, :1], torch.where(take, cand, key[:, 1:])], dim=1
            )
            org = torch.cat(
                [org[:, :1], torch.where(take, org[:, :-1], org[:, 1:])], dim=1
            )
            mat = torch.cat(
                [mat[:, :1], torch.where(take, mat[:, :-1], mat[:, 1:])], dim=1
            )

        cost = torch.where(write, key // SUB, cost)
        origin = torch.where(write, org, origin)
        matches = torch.where(write, mat, matches)
        if count_cells:
            band_rows = last * active
            cells = cells + band_rows.sum()
            warp_rows = band_rows.new_zeros(warps * 32)
            warp_rows[:B] = band_rows
            row_slots = row_slots + 32 * warp_rows.view(warps, 32).amax(dim=1).sum()

        # band update (reference ``_align.pyx:433-439``)
        in_band = in_rows & (cost <= k)
        deepest = torch.where(in_band, rows, -1).max(dim=1).values
        new_last = (deepest + 1).clamp(max=m)

        if stop_in_query:
            # row-m check while the band still reaches row m
            cost_m, origin_m, matches_m = cost[:, m], origin[:, m], matches[:, m]
            length_m = (m + origin_m.clamp(max=0)).clamp(0, m)
            ok = (
                active
                & (deepest == m)
                & (length_m >= min_overlap)
                & (cost_m <= thr64[length_m])
                & (
                    (matches_m > b_matches)
                    | ((matches_m == b_matches) & (cost_m < b_cost))
                )
            )
            b_ref_stop = torch.where(ok, m, b_ref_stop)
            b_query_stop = torch.where(ok, j, b_query_stop)
            b_cost = torch.where(ok, cost_m, b_cost)
            b_origin = torch.where(ok, origin_m, b_origin)
            b_matches = torch.where(ok, matches_m, b_matches)
            done = done | (ok & (cost_m == 0) & (matches_m == m))

        last = torch.where(active, new_last, last)

    # final-column scan (reference ``_align.pyx:461-474``): among the
    # admissible rows the most matches, then the least cost, then the
    # smallest row; it replaces the column-loop candidate only if better
    first_i = 0 if stop_in_ref else m
    lengths_i = rows + origin.clamp(max=0)
    valid = (
        (rows >= first_i)
        & (lengths_i >= min_overlap)
        & (cost <= thr64[lengths_i.clamp(0, m)])
        & (max_n == n)[:, None]
    )
    cost_cap = (1 << 27) - 1  # admissible cells have cost <= k
    score = (
        (matches << 44)
        + ((cost_cap - cost.clamp(max=cost_cap)) << 17)
        + (M1 - rows)
    )
    score = torch.where(valid, score, -1)
    top, idx = score.max(dim=1)
    take = lambda arr: arr.gather(1, idx[:, None])[:, 0]  # noqa: E731
    cand_cost, cand_matches, cand_origin = take(cost), take(matches), take(origin)
    better = (top >= 0) & (
        (cand_matches > b_matches)
        | ((cand_matches == b_matches) & (cand_cost < b_cost))
    )
    b_ref_stop = torch.where(better, idx, b_ref_stop)
    b_query_stop = torch.where(better, n, b_query_stop)
    b_cost = torch.where(better, cand_cost, b_cost)
    b_origin = torch.where(better, cand_origin, b_origin)
    b_matches = torch.where(better, cand_matches, b_matches)

    zero = torch.zeros_like(n)
    out = torch.stack(
        [
            (b_cost != m + n).to(i64),
            torch.where(b_origin >= 0, zero, -b_origin),
            b_ref_stop,
            torch.where(b_origin >= 0, b_origin, zero),
            b_query_stop,
            b_matches,
            b_cost,
            zero,
        ]
    ).to(torch.int32)
    if count_cells:
        return out, cells, row_slots
    return out


class BatchAligner(nn.Module):
    """Batched equivalent of the scalar ``Aligner`` for one adapter, on
    the plain PyTorch DP (:func:`_locate_kernel`).

    The adapter's compiled parameters — the (wildcard-translated)
    reference bytes, the threshold table and the 256-entry query
    translation table — are registered buffers on an explicit device, so
    ``.to(device)`` moves an aligner and nothing is uploaded per batch.
    :meth:`forward` takes the device-resident layout the turbo step
    builds; :meth:`locate_batch` is the numpy convenience form. Results
    are bit-identical to ``oracle.Aligner.locate`` per read.
    """

    def __init__(
        self,
        reference,
        max_error_rate,
        flags,
        wildcard_ref=False,
        wildcard_query=False,
        min_overlap=1,
        indel_cost=1,
        device="cpu",
    ):
        super().__init__()
        self.reference = reference
        self.max_error_rate = max_error_rate
        self.flags = flags
        self.wildcard_ref = wildcard_ref
        self.wildcard_query = wildcard_query
        self.min_overlap = min_overlap
        self.indel_cost = indel_cost
        m = len(reference)
        self.m = m
        self.k = int(max_error_rate * m)
        self._compare_ascii = not (wildcard_ref or wildcard_query)

        ref_b = reference.encode("ascii")
        if wildcard_ref:
            ref_b = ref_b.translate(IUPAC_TABLE)
        elif wildcard_query:
            ref_b = ref_b.translate(ACGT_TABLE)
        self._set_tables(
            np.frombuffer(ref_b, dtype=np.uint8),
            _error_thresholds(m, max_error_rate),
            _translation_lut(wildcard_ref, wildcard_query, for_query=True),
            device,
        )

    @classmethod
    def from_tables(cls, ref_bytes, thresholds, query_lut, *, m, k, flags,
                    min_overlap, indel_cost, compare_ascii, device):
        """An aligner from already compiled adapter parameters (numpy
        arrays: ``ref_bytes`` [m], ``thresholds`` [m + 1], ``query_lut``
        [256]) instead of the adapter's sequence and error rate, so that
        nothing is recomputed."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.reference = None
        self.max_error_rate = None
        self.flags = flags
        self.wildcard_ref = self.wildcard_query = None
        self.min_overlap = min_overlap
        self.indel_cost = indel_cost
        self.m = m
        self.k = k
        self._compare_ascii = bool(compare_ascii)
        if len(ref_bytes) != m or len(thresholds) != m + 1:
            raise ValueError("table sizes do not match m = %d" % m)
        self._set_tables(ref_bytes, thresholds, query_lut, device)
        return self

    def _set_tables(self, ref_bytes, thresholds, query_lut, device):
        """Register the adapter's tables as buffers on ``device``."""
        dev = torch.device(device)
        self.register_buffer(
            "ref_bytes",
            torch.from_numpy(np.ascontiguousarray(ref_bytes, np.uint8).copy()).to(dev),
        )
        self.register_buffer(
            "thresholds",
            torch.from_numpy(np.ascontiguousarray(thresholds, np.int32).copy()).to(dev),
        )
        self.register_buffer(
            "query_lut",
            torch.from_numpy(np.ascontiguousarray(query_lut, np.uint8).copy()).to(dev),
        )

    @property
    def device(self):
        return self.ref_bytes.device

    def _dp_params(self):
        return dict(
            m=self.m,
            k=self.k,
            flags=self.flags,
            min_overlap=self.min_overlap,
            ins_cost=self.indel_cost,
            del_cost=self.indel_cost,
            compare_ascii=self._compare_ascii,
        )

    def forward(self, reads_T, lengths_row):
        """``reads_T`` [L, B] uint8 (already wildcard-translated unless
        ``compare_ascii``), ``lengths_row`` [1, B] int32, both on this
        aligner's device -> the [8, B] int32 result rows."""
        return _locate_kernel(
            reads_T, lengths_row, self.ref_bytes, self.thresholds,
            **self._dp_params(),
        )

    def locate_batch(self, reads_u8, lengths):
        """Align the adapter to every read in the batch.

        Args:
            reads_u8: [B, L] uint8 raw ASCII (padding arbitrary).
            lengths: [B] int32 read lengths.

        Returns:
            dict of [B] numpy arrays: found (bool), start1, stop1, start2,
            stop2, matches, cost — matching ``Aligner.locate``'s tuple.
        """
        dev = self.device
        reads = torch.from_numpy(np.ascontiguousarray(reads_u8, np.uint8)).to(dev)
        if not self._compare_ascii:
            reads = self.query_lut[reads.long()]
        lens = torch.from_numpy(
            np.ascontiguousarray(lengths, np.int32).reshape(1, -1)
        ).to(dev)
        out = self(reads.T.contiguous(), lens).cpu().numpy()
        res = {name: out[i] for i, name in enumerate(RESULT_ROWS)}
        res["found"] = res["found"].astype(bool)
        return res


# ---------------------------------------------------------------------------
# Batched insert-overlap matcher (variable-length, diagonal closed form)
# ---------------------------------------------------------------------------


def _diagonal_match_counts(refs_T, queries_T, lengths_row):
    """Per-diagonal match counts for the no-indel insert configuration.

    ``refs_T``/``queries_T``: [W, B] byte planes (pair-wise truncated to
    the same per-pair length m_b; any integer type), ``lengths_row``: [1, B]
    or [B] integers, all on one device. Returns [W, B] int32 where row s is
    the number of matching positions of the alignment that starts at ref
    offset s: ``sum_t [ref[(s+t) mod W] == query[t]]`` over
    ``t < min(W, m_b - s)`` (the reference rotates the ref plane, so an
    m_b above W wraps around; real inputs have m_b <= W).

    This is the plain version of both diagonal-count kernels of
    :mod:`atropos_tpu_torch.align.insert_kernel`: without indels every DP
    path is a diagonal, so the whole no-indel MultiAligner collapses to W
    shifted compares.
    """
    W, B = queries_T.shape
    rows = torch.arange(W, device=queries_T.device, dtype=torch.int64)[:, None]
    lens = lengths_row.reshape(1, -1).to(torch.int64)
    counts = torch.empty((W, B), dtype=torch.int32, device=queries_T.device)
    ref_cur = refs_T
    for s in range(W):
        eq = (ref_cur == queries_T) & (rows < (lens - s))
        counts[s] = eq.sum(dim=0, dtype=torch.int32)
        ref_cur = torch.roll(ref_cur, -1, dims=0)
    return counts


#: candidate slots carried per pair in the fused-step bundle (typical pairs
#: emit 0-3 candidates); pairs with more candidates are reconstructed on
#: the host from recomputed counts (``SLOT_OVERFLOWS``)
INSERT_CANDIDATE_SLOTS = 8


def insert_step_table(err, W):
    """``tab[s] = floor(s * err)`` for s in [0, W], computed on the host
    with Python doubles (the float admissibility check ``cost <= size *
    err`` of the scalar aligner as an exact integer threshold): int32 [W+1].
    A table for a larger W holds the one for a smaller W as its prefix."""
    return np.array([int(np.floor(s * err)) for s in range(W + 1)], np.int32)


def insert_candidate_slots(
    counts, m_col, ref_plane, query_plane, step_table, min_overlap,
    max_matches, n_slots=INSERT_CANDIDATE_SLOTS,
):
    """Torch ops twin of :meth:`BatchInsertMatcher.candidate_arrays`
    emitting a fixed-size bundle format instead of the full counts plane
    (counterpart of ``atropos_tpu/align/batched.py::insert_candidate_slots``).

    ``counts`` [W, B] (any integer type), ``m_col`` [B] int32 per-pair
    lengths, ``ref_plane``/``query_plane`` [B, w] byte planes,
    ``step_table`` an int32 tensor of at least W + 1 entries from
    :func:`insert_step_table` (never recomputed here), all on one device.
    Returns:

    - ``slots`` [n_slots, B] int32: candidate c in stream order (s
      descending), packed ``(s+1) | count << 8`` biased by -32768 to survive
      the int16 bundle; 0-slot = no candidate.
    - ``meta`` [3, B] int32: [n_cand; final_s + 512*final_ok; final_count].

    Requires W <= 255 (s and counts fit a byte). Pairs with ``n_cand >
    n_slots`` must be reconstructed on the host.
    """
    W, B = counts.shape
    dev = counts.device
    i32 = torch.int32
    counts = counts.to(i32)
    tab = step_table[: W + 1].to(i32)

    def thresh_of(length):
        return tab[length.clamp(0, W).long()]

    s_idx = torch.arange(W, dtype=i32, device=dev)[:, None]
    m_row = m_col.to(i32)[None, :]
    size = m_row - s_idx
    in_range = size > 0
    cost = torch.where(in_range, size - counts, torch.zeros_like(size))
    k_col = thresh_of(m_row)

    # bottom-row mismatch of each diagonal
    w_r = ref_plane.shape[1]
    last_idx = (m_col.long() - 1).clamp(0, w_r - 1)[:, None]
    last_ref = ref_plane.gather(1, last_idx)  # [B, 1]
    q_idx = (
        m_col.long()[:, None] - 1 - torch.arange(W, device=dev)[None, :]
    ).clamp(0, query_plane.shape[1] - 1)
    q_last = query_plane.gather(1, q_idx)  # [B, W]
    mm_last = (q_last.T != last_ref[:, 0][None, :]).to(i32)

    alive_bot = in_range & (cost <= k_col)
    alive_bot_ext = alive_bot | ~in_range
    alive_m1 = in_range & ((cost - mm_last) <= k_col)
    reach = torch.cat(
        [alive_bot_ext[1:], torch.ones((1, B), dtype=torch.bool, device=dev)]
    )
    reach = (reach | alive_m1) & in_range
    rec = (
        reach
        & alive_bot
        & (size >= min_overlap)
        & (cost <= thresh_of(size))
    )
    rec_i = rec.to(i32)
    prefix_incl = torch.cumsum(rec_i, dim=0, dtype=i32)
    total = prefix_incl[-1:]
    rank = total - prefix_incl
    exact = rec[0:1] & (cost[0:1] == 0) & (rank[0:1] < max_matches)
    kept = rec & (rank < max_matches)
    cand = torch.where(exact, (s_idx == 0) & rec, kept)
    rank = torch.where(exact, torch.zeros_like(rank), rank)
    n_cand = cand.to(i32).sum(dim=0, dtype=i32)

    minus1 = torch.full_like(counts, -1)
    zero = torch.zeros_like(counts)
    slot_rows = []
    for c in range(n_slots):
        pick = cand & (rank == c)
        s_c = torch.where(pick, s_idx.expand(W, B), minus1).amax(dim=0)
        cnt_c = torch.where(pick, counts, zero).amax(dim=0)
        val = torch.where(
            s_c >= 0, (s_c + 1) | (cnt_c << 8), torch.zeros_like(s_c)
        ) - 32768
        slot_rows.append(val)
    slots = torch.stack(slot_rows)

    broke = exact[0] | (total[0] >= max_matches)
    any_reach = reach.any(dim=0)
    first_reach = reach.to(torch.uint8).argmax(dim=0).to(i32)
    s_f = torch.where(any_reach, first_reach, (m_col.to(i32) - 1).clamp(min=0))
    onehot_f = s_idx == s_f[None, :]
    cost_f = torch.where(onehot_f, cost, zero).sum(dim=0, dtype=i32)
    size_f = torch.where(onehot_f, size, zero).sum(dim=0, dtype=i32)
    count_f = torch.where(onehot_f, counts, zero).sum(dim=0, dtype=i32)
    final_ok = (
        (~broke)
        & (m_col > 0)
        & (size_f >= min_overlap)
        & (cost_f <= thresh_of(size_f))
    )
    meta = torch.stack(
        [n_cand, s_f + torch.where(final_ok, 512, 0).to(i32), count_f]
    ).to(i32)
    return slots, meta


class BatchInsertMatcher:
    """Variable-length batched equivalent of ``MultiAligner.locate`` for
    the paired-end insert configuration (flags START_WITHIN_SEQ1 |
    STOP_WITHIN_SEQ2, reference and query truncated to the same per-pair
    length — exactly how ``InsertAligner.match_insert`` calls it).

    The device computes the per-diagonal match counts (the diagonal-count
    kernels); :meth:`candidate_arrays` reconstructs the scalar kernel's
    candidate stream from them on the host, in numpy, exactly as
    ``atropos_tpu/align/batched.py::BatchInsertMatcher`` does (see there
    for the banding derivation), and :meth:`reconstruct` turns it into the
    per-pair candidate lists of the scalar format.
    """

    def __init__(self, max_error_rate, min_overlap=1, max_matches=100):
        self.max_error_rate = float(max_error_rate)
        self.min_overlap = min_overlap
        self.max_matches = max_matches

    def candidates(self, refs_u8, reads_u8, lengths, device):
        """Per-pair candidate lists in the scalar ``MultiAligner.locate``
        format. refs_u8/reads_u8: [B, W] uint8 (ref = rc(read2[:m_b]),
        query = read1[:m_b], zero-padded); lengths: [B] per-pair m_b.
        Returns a list of B entries, each a list of (refstart, refstop,
        querystart, querystop, matches, errors) tuples or None.

        The counts run on ``device``: the diagonal-count kernel that ``W``
        and the pairs' combined alphabet select
        (:func:`~atropos_tpu_torch.align.insert_kernel.kernel_for`) on a
        CUDA device, its plain version on the CPU.
        """
        from atropos_tpu_torch.align import insert_kernel

        refs_u8 = np.ascontiguousarray(refs_u8, np.uint8)
        reads_u8 = np.ascontiguousarray(reads_u8, np.uint8)
        lengths = np.ascontiguousarray(lengths, np.int32)
        W = reads_u8.shape[1]
        valid = np.arange(W)[None, :] < lengths[:, None]
        n_symbols = len(
            np.union1d(np.unique(refs_u8[valid]), np.unique(reads_u8[valid]))
        )

        def plane(array):
            return torch.from_numpy(np.ascontiguousarray(array.T)).to(device)

        kernel = insert_kernel.kernel_for(W, n_symbols)
        counts = kernel(
            plane(refs_u8), plane(reads_u8), torch.from_numpy(lengths).to(device)
        )
        counts = counts.cpu().numpy().astype(np.int32)  # [W, B]
        return self.reconstruct(counts, refs_u8, reads_u8, lengths)

    def candidate_arrays(self, counts, refs_u8, reads_u8, lengths):
        """Fully-vectorized candidate-stream reconstruction.

        Returns a dict of arrays describing the scalar kernel's candidate
        stream for every pair at once: ``cand`` [W, B] bool, ``rank`` [W,
        B] int, ``n_cand`` [B], ``final_ok``/``final_s`` [B], and the
        per-diagonal ``cost``/``size`` [W, B].
        """
        B, W = reads_u8.shape
        err = self.max_error_rate
        min_overlap = self.min_overlap
        max_matches = self.max_matches

        m = lengths.astype(np.int32)  # [B]
        s_idx = np.arange(W, dtype=np.int32)[:, None]  # [W, 1]
        size = m[None, :] - s_idx  # [W, B] overlap length per diagonal
        in_range = size > 0
        cost = np.where(in_range, size - counts, 0).astype(np.int32)
        k = (err * m).astype(np.int32)  # int(err*m): C-double truncation
        thresh = insert_step_table(err, W)

        # mismatch at the bottom row of each diagonal (host byte compare)
        last_ref = np.take_along_axis(
            refs_u8, np.maximum(m - 1, 0)[:, None].astype(np.int64), axis=1
        )  # [B, 1]
        q_idx = np.clip(m[None, :] - 1 - s_idx, 0, W - 1).T  # [B, W]
        q_last = np.take_along_axis(reads_u8, q_idx, axis=1).T  # [W, B]
        mm_last = (q_last != last_ref.T).astype(np.int32)

        alive_bot = in_range & (cost <= k[None, :])
        # s >= m_b: zero-length overlap, running cost 0 -> alive
        alive_bot_ext = alive_bot | ~in_range
        alive_m1 = in_range & ((cost - mm_last) <= k[None, :])
        # band reached row m at column j = m - s
        reach = np.empty_like(alive_bot)
        reach[:-1] = alive_bot_ext[1:]
        reach[-1] = True  # s = W-1: zero/negative overlap successor
        reach |= alive_m1
        reach &= in_range

        rec = (
            reach
            & alive_bot
            & (size >= min_overlap)
            & (cost <= thresh[np.clip(size, 0, W)])
        )

        # emission order is s descending; rank(s) = #candidates with
        # s' > s = total - inclusive-prefix-count
        rec_i = rec.astype(np.int32)
        prefix_incl = np.cumsum(rec_i, axis=0)
        total = prefix_incl[-1]
        rank = total[None, :] - prefix_incl
        # exact-match collapse: diagonal 0 with zero cost, if reached
        # before the cap, erases every earlier candidate
        exact = rec[0] & (cost[0] == 0) & (rank[0] < max_matches)
        kept = rec & (rank < max_matches)
        cand = np.where(exact[None, :], (s_idx == 0) & rec, kept)
        rank = np.where(exact[None, :], 0, rank)

        # final-column re-record: only for pairs that neither collapsed
        # nor hit the candidate cap
        broke = exact | (total >= max_matches)
        any_reach = reach.any(axis=0)
        first_reach = np.argmax(reach, axis=0)  # min s with reach
        s_f = np.where(any_reach, first_reach, np.maximum(m - 1, 0))
        rows_b = np.arange(B)
        cost_f = cost[s_f, rows_b]
        size_f = size[s_f, rows_b]
        final_ok = (
            (~broke)
            & (m > 0)
            & (size_f >= min_overlap)
            & (cost_f <= thresh[np.clip(size_f, 0, W)])
        )
        return dict(
            cand=cand,
            rank=rank,
            n_cand=cand.sum(axis=0).astype(np.int64),
            final_ok=final_ok,
            final_s=s_f,
            cost=cost,
            size=size,
        )

    def reconstruct(self, counts, refs_u8, reads_u8, lengths):
        """Scalar-format candidate lists (list-of-tuples per pair) built
        from :meth:`candidate_arrays`; the array form is the turbo path's,
        this converter serves the per-record engine."""
        arrs = self.candidate_arrays(counts, refs_u8, reads_u8, lengths)
        m = lengths.astype(np.int64)
        B = m.shape[0]
        ss, bs = np.nonzero(arrs["cand"])
        # group candidates by pair, s descending
        order = np.lexsort((-ss, bs))
        ss, bs = ss[order], bs[order]
        bounds = np.searchsorted(bs, np.arange(B + 1))
        results = []
        for b in range(B):
            m_b = int(m[b])
            out = [
                (int(s), m_b, 0, m_b - int(s), int(counts[s, b]),
                 int(arrs["cost"][s, b]))
                for s in ss[bounds[b] : bounds[b + 1]]
            ]
            if arrs["final_ok"][b]:
                s_f = int(arrs["final_s"][b])
                out.append(
                    (s_f, m_b, 0, m_b, int(counts[s_f, b]),
                     int(arrs["cost"][s_f, b]))
                )
            results.append(out or None)
        return results
