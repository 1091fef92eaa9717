"""The register instantiations of ``dp_locate_word32``, checked on the CPU.

``csrc/dp_align.cu::dp_body_reg`` keeps a read's DP column in registers
and computes a cell as one minimum of keyed words instead of ``dp_body``'s
ordered compares; a CUDA kernel cannot run here. What can is checked here,
in numpy:

- the keyed form of the cell rule against ``dp_body``'s ordered compares,
  exhaustively over small costs, both match states, every tie key a stored
  cell may carry and the indel units 1, 2, 3 and a clamped 100000, in the
  kernel's 32-bit words with the tightest field layout the wrapper lets
  through and in a roomy one: the same word wherever the cell costs k or
  less, and cost k + 1 (dead) wherever it does not;
- the 256-entry match-mask table a block builds against the byte compare
  of the plain version, in both compare modes;
- the wrapper's choice of instantiation;
- the register body's whole column walk (stale rows kept by a select, the
  row-m pick, the unrolled final scan) against the port's plain version and
  the JAX package's ``BatchAligner`` on the same reads, and the warp-level
  row slots it runs against the plain version's count of them.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools
import zlib

import numpy as np
import pytest
import torch

from atropos_tpu.align.batched import BatchAligner as JaxBatchAligner
from atropos_tpu.align.pallas_kernel import PallasAligner
from atropos_tpu_torch.align import cuda_kernel
from atropos_tpu_torch.align.batched import _locate_kernel
from atropos_tpu_torch.align.flags import (
    START_WITHIN_SEQ1,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
)

from .test_batched_align import BACK, FLAG_CASES, FRONT, PREFIX, SUFFIX

torch.set_num_threads(1)

U32 = np.uint32
INDEL_COSTS = (1, 2, 3, 100000)


def seeded(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def ordered_rule(diag, old, prev, eq, *, k, ins_unit, del_unit, cost_shift):
    """``dp_body``'s rule: for a mismatch the diagonal if it is no dearer
    than both others, else the insertion if no dearer than the deletion,
    else the deletion, the cost clamped at k + 1 and the winner's payload
    kept; for a match the diagonal with one match more. Words as Python
    ints in int64 arrays (no overflow)."""
    low = (1 << cost_shift) - 1
    c_diag = (diag >> cost_shift) + 1
    c_del = (old >> cost_shift) + del_unit
    c_ins = (prev >> cost_shift) + ins_unit
    take_diag = (c_diag <= c_del) & (c_diag <= c_ins)
    take_ins = c_ins <= c_del
    cost = np.where(take_diag, c_diag, np.where(take_ins, c_ins, c_del))
    pay = np.where(take_diag, diag, np.where(take_ins, prev, old))
    cost = np.minimum(cost, k + 1)
    return np.where(eq, diag + 1, (cost << cost_shift) | (pay & low))


def keyed_rule(diag, old, prev, eq, *, k, ins_unit, del_unit, key_shift):
    """``dp_body_reg``'s rule in the kernel's uint32 words, whose 2-bit tie
    key (0 diagonal, 1 insertion, 2 deletion) sits between the cost (from
    ``key_shift + 2`` up) and the payload: the minimum of the keyed
    candidate words and of the clamp word, its key cleared, or for a match
    diag + 1. Stored words (the three inputs) carry no key."""
    cost_shift = key_shift + 2
    clamp_w = U32((k + 1) << cost_shift)
    best = np.minimum(
        old + U32((del_unit << cost_shift) | (2 << key_shift)),
        np.minimum(diag + U32(1 << cost_shift), clamp_w),
    )
    ins = prev + U32((ins_unit << cost_shift) | (1 << key_shift))
    cleared = np.minimum(ins, best) & ~U32(3 << key_shift)
    return np.where(eq, diag + U32(1), cleared).astype(U32)


def _bits(x):
    return max(1, int(x).bit_length())


@pytest.mark.parametrize("layout", ["tight", "roomy"])
@pytest.mark.parametrize("k", range(7))
def test_keyed_rule_equals_ordered_compares(k, layout):
    """Every triple of costs 0..k + 2 (0..k + 1 in the tight layout, the
    most a stored cell holds), both match states, insertion and deletion
    units from 1, 2, 3 and 100000 (clamped at k + 1 as the kernel clamps
    them), payloads drawn at random. The tight layout leaves exactly the
    three bits the wrapper asks for above the fields, so an overflow would
    show. Where dp_body's cell costs k or less the keyed rule gives
    dp_body's word; elsewhere both cost k + 1."""
    if layout == "tight":
        key_shift = 32 - 3 - _bits(k + 1)
        top = k + 1
    else:
        key_shift = 14
        top = k + 2
    cost_shift = key_shift + 2
    low = (1 << key_shift) - 1
    rng = seeded(k, layout)
    costs = np.arange(top + 1)
    grid = np.array(list(itertools.product(costs, costs, costs, (0, 1))), np.int64)
    grid = np.repeat(grid, 8, axis=0)
    pays = rng.integers(0, low + 1, (len(grid), 3))
    pays[:, 0] = np.minimum(pays[:, 0], low - 1)  # the match count never wraps
    diag, old, prev = (
        (grid[:, col] << cost_shift) | pays[:, col] for col in range(3)
    )
    eq = grid[:, 3].astype(bool)
    for ins_cost, del_cost in itertools.product(INDEL_COSTS, INDEL_COSTS):
        units = dict(k=k, ins_unit=min(ins_cost, k + 1), del_unit=min(del_cost, k + 1))
        want = ordered_rule(diag, old, prev, eq, cost_shift=cost_shift, **units)
        got = keyed_rule(
            diag.astype(U32), old.astype(U32), prev.astype(U32), eq,
            key_shift=key_shift, **units,
        ).astype(np.int64)
        live = (want >> cost_shift) <= k
        assert not (got & (3 << key_shift)).any()
        assert np.array_equal(got[live], want[live]), (ins_cost, del_cost)
        assert np.array_equal(got >> cost_shift, want >> cost_shift), (ins_cost, del_cost)
        if layout == "tight":
            assert int((got >> cost_shift).max()) <= k + 1


def match_table(ref, compare_ascii, row_cap):
    """The 256 match masks a block of ``dp_body_reg`` builds: bit i - 1 of
    entry v is set iff adapter byte i - 1 matches read byte v; 32-bit masks
    for row caps up to 32, 64-bit ones above."""
    dtype = np.uint32 if row_cap <= 32 else np.uint64
    table = np.zeros(256, dtype)
    for v in range(256):
        bits = 0
        for i, rc in enumerate(ref.tolist()):
            eq = rc == v if compare_ascii else (rc & v) != 0
            bits |= int(eq) << i
        table[v] = bits
    return table


@pytest.mark.parametrize("compare_ascii", [True, False])
@pytest.mark.parametrize("m", [1, 15, 16, 31, 32, 47, 48, 63])
def test_match_masks_equal_byte_compare(m, compare_ascii):
    """The table of the row cap that serves m, against the plain version's
    compare (``ref == qc``, or ``(ref & qc) != 0`` for IUPAC bytes) for
    every read byte; the adapter's wildcard bytes translated by the port's
    own tables."""
    rng = seeded(m, compare_ascii)
    letters = "ACGT" if compare_ascii else "ACGTNRYKMSWBDHV"
    adapter = "".join(letters[i] for i in rng.integers(0, len(letters), m))
    aligner = cuda_kernel.CudaAligner(
        adapter, 0.1, 14, wildcard_ref=not compare_ascii, device="cpu"
    )
    assert aligner._compare_ascii == compare_ascii
    how = cuda_kernel.dp_locate_word32.instantiation(m, aligner.k, 160)
    assert how.kind == "registers"
    table = match_table(aligner.ref_bytes.numpy(), compare_ascii, how.row_cap)
    if how.row_cap <= 32:
        assert table.dtype == np.uint32
    ref = aligner.ref_bytes.numpy().astype(np.int64)[None, :]
    qc = np.arange(256)[:, None]
    want = (ref == qc) if compare_ascii else ((ref & qc) != 0)
    got = (table.astype(np.uint64)[:, None] >> np.arange(m, dtype=np.uint64)) & 1
    assert np.array_equal(got.astype(bool), want)


@pytest.mark.parametrize("m,k,L,kind,row_cap", [
    (1, 0, 160, "registers", 16),
    (15, 1, 160, "registers", 16),
    (16, 1, 160, "registers", 32),
    (31, 3, 160, "registers", 32),
    (32, 3, 160, "registers", 48),
    (33, 3, 160, "registers", 48),  # TruSeq on the main path
    (47, 4, 320, "registers", 48),
    (48, 4, 320, "registers", 64),
    (63, 6, 32, "registers", 64),
    (64, 6, 160, "shared", 0),
    (120, 12, 320, "shared", 0),
    (2000, 200, 2048, "global", 0),
    # m 6 + origin 17 + cost 6 bits: three bits to spare
    (63, 31, (1 << 17) - 64, "registers", 64),
    # m 6 + origin 18 + cost 6 bits: two bits to spare, too few
    (63, 31, (1 << 18) - 64, "shared", 0),
])
def test_instantiation_follows_the_shape(m, k, L, kind, row_cap):
    kernel = cuda_kernel.dp_locate_word32
    assert kernel.fits(m, k, L)
    how = kernel.instantiation(m, k, L)
    assert (how.kind, how.row_cap) == (kind, row_cap)
    if kind == "registers":
        assert how.threads == cuda_kernel.REGISTER_THREADS
    else:
        assert (how.threads, kind == "global") == kernel.block_layout(m)
        if m + 1 <= max(cuda_kernel.ROW_CAPS):
            # a register column named for a shape without three spare bits
            # is refused before anything reaches the card
            with pytest.raises(ValueError, match="three bits"):
                kernel.launch(
                    torch.zeros((L, 32), dtype=torch.uint8),
                    torch.zeros((1, 32), dtype=torch.int32),
                    torch.zeros((m,), dtype=torch.uint8),
                    torch.zeros((m + 1,), dtype=torch.int32),
                    cuda_kernel.Instantiation("registers", 64, 128),
                    m=m, k=k, flags=14, min_overlap=3, ins_cost=1, del_cost=1,
                    compare_ascii=True,
                )
    # the 64-bit kernel keeps its one device function
    assert cuda_kernel.dp_locate_wide.instantiation(m, k, L).kind != "registers"


def emulate_register_body(reads_T, lengths, ref, thr, *, m, k, flags, min_overlap,
                          ins_cost, del_cost, compare_ascii):
    """``dp_body_reg`` for every lane at once, in numpy uint32 words: the
    row cap's column, the match table, rows above a lane's band kept by a
    select, row m picked from the column, the final scan over the column.
    Returns the [8, B] int32 result and the warp-level row slots (32 times
    the deepest row a warp of 32 lanes runs, over the columns)."""
    L, B = reads_T.shape
    kernel = cuda_kernel.dp_locate_word32
    R = kernel.instantiation(m, k, L).row_cap
    assert R >= m + 1
    mat_bits, org_bits = cuda_kernel.cell_layout(m, k, L, 32)
    org_shift, key_shift = mat_bits, mat_bits + org_bits
    cost_shift = key_shift + 2
    assert cost_shift + _bits(2 * k + 2) <= 32
    mat_mask, org_mask = (1 << mat_bits) - 1, (1 << org_bits) - 1
    low = U32((1 << key_shift) - 1)
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & STOP_WITHIN_SEQ1)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)
    clamp = k + 1
    units = dict(k=k, ins_unit=min(ins_cost, clamp), del_unit=min(del_cost, clamp),
                 key_shift=key_shift)
    live_w = U32((k + 1) << cost_shift)
    table = match_table(ref, compare_ascii, R)

    n = lengths.astype(np.int64)
    max_n = n if start_in_query else np.minimum(n, m + k)
    min_n = np.zeros_like(n) if stop_in_query else np.maximum(0, n - m - k)
    cell = np.zeros((R, B), U32)
    for i in range(m + 1):
        if not start_in_ref and not start_in_query:
            c, o = np.maximum(i, min_n) * ins_cost, np.zeros_like(n)
        elif start_in_ref and not start_in_query:
            c, o = min_n * ins_cost, np.minimum(0, min_n - i)
        elif not start_in_ref and start_in_query:
            c, o = np.full_like(n, i * ins_cost), np.maximum(0, min_n - i)
        else:
            c, o = np.minimum(i, min_n) * ins_cost, min_n - i
        cell[i] = (np.minimum(c, clamp) << cost_shift) | ((o + m) << org_shift)

    best_ref_stop = np.full(B, m)
    best_query_stop = n.copy()
    best_cost = m + n
    best_origin = np.zeros(B, np.int64)
    best_matches = np.zeros(B, np.int64)
    last = np.full(B, m if start_in_ref else min(m, k + 1))
    done = np.zeros(B, bool)
    row_slots = 0

    def fields(w):
        w = w.astype(np.int64)
        return w >> cost_shift, ((w >> org_shift) & org_mask) - m, w & mat_mask

    def better(ok, cmat, ccost):
        return ok & ((cmat > best_matches) | ((cmat == best_matches) & (ccost < best_cost)))

    for j in range(1, L + 1):
        active = ~(done | (j > max_n)) & (j > min_n)
        lim = np.where(active, last, -1)
        row_slots += 32 * int(np.maximum(lim.reshape(-1, 32).max(axis=1), 0).sum())
        mask = table[reads_T[j - 1]].astype(np.uint64)
        diag = cell[0].copy()
        if start_in_query:
            prev = (diag & ~U32(org_mask << org_shift)) | U32((j + m) << org_shift)
        else:
            prev = (diag & low) | U32(min(j * units["ins_unit"], clamp) << cost_shift)
        cell[0] = np.where(active, prev, diag)
        band = np.where(prev < live_w, 0, -1)
        for i in range(1, R):
            old = cell[i].copy()
            eq = ((mask >> np.uint64(i - 1)) & np.uint64(1)).astype(bool)
            cur = keyed_rule(diag, old, prev, eq, **units)
            write = i <= lim
            cell[i] = np.where(write, cur, old)
            band = np.where(write & (cur < live_w), i, band)
            diag, prev = old, cur
        last = np.where(active & (band < m), band + 1, last)
        if stop_in_query:
            ccost, corg, cmat = fields(cell[m])
            length = m + np.minimum(corg, 0)
            ok = better(
                active & (band >= m) & (length >= min_overlap)
                & (ccost <= thr[np.clip(length, 0, m)]),
                cmat, ccost,
            )
            best_matches = np.where(ok, cmat, best_matches)
            best_cost = np.where(ok, ccost, best_cost)
            best_origin = np.where(ok, corg, best_origin)
            best_ref_stop = np.where(ok, m, best_ref_stop)
            best_query_stop = np.where(ok, j, best_query_stop)
            done |= ok & (ccost == 0) & (cmat == m)

    first_i = 0 if stop_in_ref else m
    for i in range(R):
        ccost, corg, cmat = fields(cell[i])
        length = i + np.minimum(corg, 0)
        ok = better(
            (max_n == n) & (first_i <= i <= m) & (length >= min_overlap)
            & (ccost <= thr[np.clip(length, 0, m)]),
            cmat, ccost,
        )
        best_matches = np.where(ok, cmat, best_matches)
        best_cost = np.where(ok, ccost, best_cost)
        best_origin = np.where(ok, corg, best_origin)
        best_ref_stop = np.where(ok, i, best_ref_stop)
        best_query_stop = np.where(ok, n, best_query_stop)

    return row_slots, np.stack([
        best_cost != m + n,
        np.where(best_origin >= 0, 0, -best_origin),
        best_ref_stop,
        np.where(best_origin >= 0, best_origin, 0),
        best_query_stop,
        best_matches,
        best_cost,
        np.zeros(B, np.int64),
    ]).astype(np.int32)


#: (m, error rate, indel cost, wildcard adapter) for each walk case: m on
#: both sides of every row cap, every indel cost, both compare modes
WALK_CASES = [
    (15, 0.2, 1, False), (16, 0.1, 2, True), (31, 0.2, 3, False),
    (32, 0.1, 100000, True), (33, 0.1, 1, False), (47, 0.3, 3, True),
    (48, 0.2, 2, False), (63, 0.1, 1, True),
]


@pytest.mark.parametrize("name,flags", FLAG_CASES)
@pytest.mark.parametrize("case", range(len(WALK_CASES)))
def test_register_walk_equals_plain_version(case, name, flags):
    m, e, indel_cost, wild = WALK_CASES[case]
    rng = seeded(case, name, "walk")
    letters = "ACGTN" if wild else "ACGT"
    adapter = "".join(letters[i] for i in rng.integers(0, len(letters), m))
    args = dict(wildcard_ref=wild, min_overlap=3, indel_cost=indel_cost)
    tables = PallasAligner(adapter, e, flags, **args)
    aligner = cuda_kernel.aligner_from_numpy(
        tables._ref_np, tables._thresholds_np, tables._query_lut_np,
        m=tables.m, k=tables.k, flags=flags, min_overlap=3, indel_cost=indel_cost,
        compare_ascii=tables._compare_ascii, device="cpu",
    )
    B, L = 96, 80
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, L))].copy()
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    ad = np.frombuffer(adapter.replace("N", "A").encode(), np.uint8)
    for row in range(3, B):
        # where an adapter of this kind sits: its tail at a read's start
        # (front), its head at the end (back), all of it at the start or
        # the end (prefix, suffix: anchored), or anywhere
        take = m if flags in (PREFIX, SUFFIX) else int(rng.integers(3, m + 1))
        frag = (ad[-take:] if flags == FRONT else ad[:take]).copy()
        frag[rng.random(take) < 0.05] = ord("C")
        if flags in (FRONT, PREFIX):
            at = 0
        elif flags in (BACK, SUFFIX):
            at = max(0, int(lengths[row]) - take)
        else:
            at = int(rng.integers(0, max(1, int(lengths[row]) - take + 1)))
        reads[row, at : at + take] = frag[: max(0, L - at)]
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 0

    dev_reads = torch.from_numpy(reads)
    if not aligner._compare_ascii:
        dev_reads = aligner.query_lut[dev_reads.long()]
    reads_T = dev_reads.T.contiguous()
    lens = torch.from_numpy(lengths)[None, :].contiguous()
    params = aligner._dp_params()
    plain = cuda_kernel.dp_locate_word32(
        reads_T, lens, aligner.ref_bytes, aligner.thresholds, **params
    ).numpy()
    row_slots, got = emulate_register_body(
        reads_T.numpy(), lengths, aligner.ref_bytes.numpy().astype(np.int64),
        aligner.thresholds.numpy().astype(np.int64), **params,
    )
    assert np.array_equal(got, plain)
    # the plain version counts the same warp-level row slots
    counted, cells, slots = _locate_kernel(
        reads_T, lens, aligner.ref_bytes, aligner.thresholds, count_cells=True, **params
    )
    assert np.array_equal(counted.numpy(), plain)
    assert int(slots) == row_slots and int(cells) <= row_slots
    assert int(plain[0].sum()) > 0
    jax_rows = JaxBatchAligner(adapter, e, flags, **args).locate_batch(reads, lengths)
    for row, key in enumerate(("found", "start1", "stop1", "start2", "stop2",
                               "matches", "cost")):
        assert np.array_equal(got[row], np.asarray(jax_rows[key]).astype(np.int32)), key
