"""The warp instantiation of ``dp_locate_wide``, checked on the CPU.

``csrc/dp_align.cu::dp_body_warp`` runs one read a warp: lane l holds rows
1 + l R .. (l + 1) R of the read's column in registers, a cell is two
32-bit planes (cost << 2 | tie key, and the payload), and the insertion
chain crosses the lanes by speculation and fix-up: each lane first walks
its strip as if no insertion came from the lane above, then warp-voted
rounds re-walk the lanes whose incoming row changed, until a round changes
no lane's last row. A CUDA kernel cannot run here; this file runs the same
steps in numpy, with the rows a lane R as a parameter:

- strips, the shuffled diagonal, the speculative walk, the voted fix-up
  rounds, the band as a maximum over the lanes, row m broadcast from its
  lane, the final column as a per-lane scan and a warp arg-reduction;
- held against the port's plain ``_locate_kernel`` and the JAX package's
  ``BatchAligner`` on the same reads at tolerance 0, for all five flag
  sets, indel costs 1, 2, 3 and 100000, both compare modes, and adapters
  on both sides of strip boundaries (m + 1 = 32 R - 1, 32 R, 32 R + 1);
- a constructed batch whose insertion chain crosses more than three lanes
  in one column takes more than one round, and ``--no-indels`` exactly
  one a column;
- the wrapper's choice of the strips, and ``launch`` refusing them where
  they do not hold the adapter.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
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

LANES = np.arange(32)


def seeded(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def lane_match_table(ref, compare_ascii, R):
    """The [256, 32] match masks a block builds: bit r of entry (v, l) is
    set iff adapter byte l R + r exists and matches read byte v."""
    m = len(ref)
    at = LANES[:, None] * R + np.arange(R)[None, :]  # [32, R]
    padded = np.zeros(32 * R, np.int64)
    padded[:m] = ref
    v = np.arange(256)[:, None, None]
    eq = (padded[at][None] == v) if compare_ascii else ((padded[at][None] & v) != 0)
    eq &= (at < m)[None]
    return (eq.astype(np.int64) << np.arange(R)).sum(axis=-1)


def emulate_warp_body(reads_T, lengths, ref, thr, *, R, m, k, flags, min_overlap,
                      ins_cost, del_cost, compare_ascii):
    """``dp_body_warp`` with R rows a lane, for every read (warp) at once,
    in numpy: the cell planes as int64 holding the kernel's uint32 values.
    Returns the [8, B] int32 result and the counts the kernel adds to its
    ``stats``: columns, fix-up rounds, fix-up row steps, and beside them
    the most rounds any column took."""
    L, B = reads_T.shape
    assert m <= 32 * R
    mat_bits, org_bits = cuda_kernel.strip_layout(m, k, L)
    org_shift = mat_bits
    mat_mask, org_mask = (1 << mat_bits) - 1, (1 << org_bits) - 1
    org_field = org_mask << org_shift
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & STOP_WITHIN_SEQ1)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)
    clamp = k + 1
    ins_unit, del_unit = min(ins_cost, clamp), min(del_cost, clamp)
    del_w = (del_unit << 2) | 2
    ins_w = (ins_unit << 2) | 1
    ins_c = ins_unit << 2
    clamp_h = dead_h = clamp << 2
    table = lane_match_table(ref, compare_ascii, R)

    n = lengths.astype(np.int64)
    max_n = n if start_in_query else np.minimum(n, m + k)
    min_n = np.zeros_like(n) if stop_in_query else np.maximum(0, n - m - k)
    j_end = np.minimum(max_n, L)
    row0 = 1 + LANES * R  # [32]
    rows = row0[:, None] + np.arange(R)[None, :]  # [32, R]

    def initial(i):  # i: row indices of any shape, broadcast against reads
        i = np.asarray(i)[None]
        mn = min_n.reshape((B,) + (1,) * (i.ndim - 1))
        if not start_in_ref and not start_in_query:
            c, o = np.maximum(i, mn) * ins_cost, np.zeros_like(mn + i)
        elif start_in_ref and not start_in_query:
            c, o = mn * ins_cost + 0 * i, np.minimum(0, mn - i)
        elif not start_in_ref and start_in_query:
            c, o = i * ins_cost + 0 * mn, np.maximum(0, mn - i)
        else:
            c, o = np.minimum(i, mn) * ins_cost, mn - i
        return np.minimum(c, clamp) << 2, (o + m) << org_shift

    cell_h, cell_l = initial(rows)  # [B, 32, R]
    cell_h = np.where(rows[None] > m, 0, cell_h)
    cell_l = np.where(rows[None] > m, 0, cell_l)
    r0_h, r0_l = (x[:, 0] for x in initial([0]))

    best_ref_stop = np.full(B, m)
    best_query_stop = n.copy()
    best_cost = m + n
    best_origin = np.zeros(B, np.int64)
    best_matches = np.zeros(B, np.int64)
    last = np.full(B, m if start_in_ref else min(m, k + 1))
    done = np.zeros(B, bool)
    columns = rounds = fix_rows = max_rounds = 0

    def better(ok, cmat, ccost):
        return ok & ((cmat > best_matches) | ((cmat == best_matches) & (ccost < best_cost)))

    def shfl_up(x):  # [B, 32]: lane l gets lane l - 1's value, lane 0 its own
        return np.concatenate([x[:, :1], x[:, :-1]], axis=1)

    for j in range(1, L + 1):
        act = (j > min_n) & (j <= j_end) & ~done
        if not act.any():
            continue
        columns += int(act.sum())
        mask = table[reads_T[j - 1]]  # [B, 32]
        d0_h, d0_l = r0_h.copy(), r0_l.copy()
        if start_in_query:
            r0_l = np.where(act, (r0_l & ~org_field) | ((j + m) << org_shift), r0_l)
        else:
            r0_h = np.where(act, min(j * ins_unit, clamp) << 2, r0_h)
        band0 = np.where(r0_h < clamp_h, 0, -1)

        dh = shfl_up(cell_h[:, :, R - 1])
        dl = shfl_up(cell_l[:, :, R - 1])
        dh[:, 0], dl[:, 0] = d0_h, d0_l
        lim = np.where(act[:, None], last[:, None] - row0[None, :], -1)  # [B, 32]

        # step 1: the best off the chain, then the walk
        bk = np.empty_like(cell_h)
        bl = np.empty_like(cell_l)
        for r in range(R):
            oh, ol = cell_h[:, :, r], cell_l[:, :, r]
            c_diag, c_del = dh + 4, oh + del_w
            take_diag = c_diag < c_del
            wh = np.minimum(np.where(take_diag, c_diag, c_del), clamp_h)
            eq = ((mask >> r) & 1).astype(bool)
            bk[:, :, r] = np.where(eq, dh, wh)
            bl[:, :, r] = np.where(eq, dl + 1, np.where(take_diag, dl, ol))
            dh, dl = oh, ol

        def step(r, ph, pl):
            eq = ((mask >> r) & 1).astype(bool)
            win = (ph + ins_w) < np.where(eq, 0, bk[:, :, r])
            return (np.where(win, ph + ins_c, bk[:, :, r] & ~3),
                    np.where(win, pl, bl[:, :, r]))

        in_h = np.where(LANES == 0, r0_h[:, None], dead_h)
        in_l = np.where(LANES == 0, r0_l[:, None], 0)
        band_r = np.full((B, 32), -1)
        ph, pl = in_h, in_l
        for r in range(R):
            ch, cl = step(r, ph, pl)
            write = r <= lim
            cell_h[:, :, r] = np.where(write, ch, cell_h[:, :, r])
            cell_l[:, :, r] = np.where(write, cl, cell_l[:, :, r])
            band_r = np.where(write & (ch < clamp_h), r, band_r)
            ph, pl = ch, cl

        # step 2: the voted fix-up rounds
        going = act.copy()
        taken = np.zeros(B, np.int64)
        while going.any():
            taken += going
            gh = shfl_up(cell_h[:, :, R - 1])
            gl = shfl_up(cell_l[:, :, R - 1])
            walking = (going[:, None] & (LANES >= 1) & (lim >= 0)
                       & ((gh != in_h) | (gl != in_l)))
            in_h = np.where(walking, gh, in_h)
            in_l = np.where(walking, gl, in_l)
            ph, pl = gh, gl
            changed_last = np.zeros((B, 32), bool)
            for r in range(R):
                warp_walks = walking.any(axis=1)
                if not warp_walks.any():
                    break
                fix_rows += int(warp_walks.sum())
                ch, cl = step(r, ph, pl)
                walking = (walking & (r <= lim)
                           & ((ch != cell_h[:, :, r]) | (cl != cell_l[:, :, r])))
                cell_h[:, :, r] = np.where(walking, ch, cell_h[:, :, r])
                cell_l[:, :, r] = np.where(walking, cl, cell_l[:, :, r])
                band_r = np.where(walking & (ch < clamp_h), np.maximum(band_r, r), band_r)
                if r == R - 1:
                    changed_last = walking
                ph, pl = ch, cl
            going &= changed_last.any(axis=1)
        rounds += int(taken.sum())
        max_rounds = max(max_rounds, int(taken.max()))

        # step 3: the band; row m broadcast from its lane
        lane_band = np.where(band_r >= 0, row0[None, :] + band_r, -1).max(axis=1)
        band = np.maximum(band0, lane_band)
        last = np.where(act & (band < m), band + 1, last)
        if stop_in_query:
            owner, rm = divmod(m - 1, R)
            wh, wl = cell_h[:, owner, rm], cell_l[:, owner, rm]
            ccost, cmat = wh >> 2, wl & mat_mask
            corg = ((wl >> org_shift) & org_mask) - m
            length = m + np.minimum(corg, 0)
            ok = better(act & (band >= m) & (length >= min_overlap)
                        & (ccost <= thr[np.clip(length, 0, m)]), cmat, ccost)
            best_matches = np.where(ok, cmat, best_matches)
            best_cost = np.where(ok, ccost, best_cost)
            best_origin = np.where(ok, corg, best_origin)
            best_ref_stop = np.where(ok, m, best_ref_stop)
            best_query_stop = np.where(ok, j, best_query_stop)
            done |= ok & (ccost == 0) & (cmat == m)

    # the final column: each lane's first row with the most matches, then
    # the least cost; the warp's first such row of all
    first_i = 0 if stop_in_ref else m
    scan_rows = np.concatenate([[0], rows[0]])  # lane 0 considers row 0 first
    key = np.full((B, 32), -1)
    key_i = np.zeros((B, 32), np.int64)
    key_org = np.zeros((B, 32), np.int64)
    for lane in range(32):
        lane_rows = scan_rows if lane == 0 else rows[lane]
        for idx, i in enumerate(lane_rows):
            if lane == 0 and idx == 0:
                h, lo = r0_h, r0_l
            else:
                r = i - row0[lane]
                h, lo = cell_h[:, lane, r], cell_l[:, lane, r]
            ccost, cmat = h >> 2, lo & mat_mask
            corg = ((lo >> org_shift) & org_mask) - m
            length = i + np.minimum(corg, 0)
            c = (cmat << 16) | (0xFFFF - np.minimum(ccost, 0xFFFF))
            ok = ((first_i <= i <= m) & (length >= min_overlap)
                  & (ccost <= thr[np.clip(length, 0, m)]) & (c > key[:, lane]))
            key[:, lane] = np.where(ok, c, key[:, lane])
            key_i[:, lane] = np.where(ok, i, key_i[:, lane])
            key_org[:, lane] = np.where(ok, corg, key_org[:, lane])
    top = key.max(axis=1)
    i = np.where(key == top[:, None], key_i, np.iinfo(np.int64).max).min(axis=1)
    owner = np.where(i == 0, 0, (i - 1) // R)
    org = key_org[np.arange(B), np.clip(owner, 0, 31)]
    cmat, ccost = top >> 16, 0xFFFF - (top & 0xFFFF)
    ok = better((max_n == n) & (top >= 0), cmat, ccost)
    best_matches = np.where(ok, cmat, best_matches)
    best_cost = np.where(ok, ccost, best_cost)
    best_origin = np.where(ok, org, best_origin)
    best_ref_stop = np.where(ok, i, best_ref_stop)
    best_query_stop = np.where(ok, n, best_query_stop)

    out = np.stack([
        best_cost != m + n,
        np.where(best_origin >= 0, 0, -best_origin),
        best_ref_stop,
        np.where(best_origin >= 0, best_origin, 0),
        best_query_stop,
        best_matches,
        best_cost,
        np.zeros(B, np.int64),
    ]).astype(np.int32)
    return out, dict(columns=columns, rounds=rounds, fix_rows=fix_rows,
                     max_rounds=max_rounds)


def make_reads(rng, adapter, flags, B, L):
    """Random reads, most of them with a fragment of ``adapter`` where an
    adapter of this kind sits, 5 % of its bases changed; a tenth of the
    fragments lose a run of 2-9 bases (an insertion chain in the DP)."""
    m = len(adapter)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, L))].copy()
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    ad = np.frombuffer(adapter.replace("N", "A").encode(), np.uint8)
    for row in range(3, B):
        take = m if flags in (PREFIX, SUFFIX) else int(rng.integers(3, m + 1))
        frag = (ad[-take:] if flags == FRONT else ad[:take]).copy()
        frag[rng.random(take) < 0.05] = ord("C")
        if take > 20 and rng.random() < 0.1:
            cut = int(rng.integers(5, take - 12))
            frag = np.concatenate([frag[:cut], frag[cut + int(rng.integers(2, 10)):]])
        take = len(frag)
        if flags in (FRONT, PREFIX):
            at = 0
        elif flags in (BACK, SUFFIX):
            at = max(0, int(lengths[row]) - take)
        else:
            at = int(rng.integers(0, max(1, int(lengths[row]) - take + 1)))
        reads[row, at : at + take] = frag[: max(0, L - at)]
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return reads, lengths


def run_case(adapter, e, flags, indel_cost, wild, R, reads, lengths):
    """The emulation, the plain version and the JAX package's
    ``BatchAligner`` on the same reads; returns the emulation's counts."""
    args = dict(wildcard_ref=wild, min_overlap=3, indel_cost=indel_cost)
    tables = PallasAligner(adapter, e, flags, **args)
    aligner = cuda_kernel.aligner_from_numpy(
        tables._ref_np, tables._thresholds_np, tables._query_lut_np,
        m=tables.m, k=tables.k, flags=flags, min_overlap=3, indel_cost=indel_cost,
        compare_ascii=tables._compare_ascii, device="cpu",
    )
    dev_reads = torch.from_numpy(reads)
    if not aligner._compare_ascii:
        dev_reads = aligner.query_lut[dev_reads.long()]
    reads_T = dev_reads.T.contiguous()
    lens = torch.from_numpy(lengths)[None, :].contiguous()
    params = aligner._dp_params()
    plain = _locate_kernel(
        reads_T, lens, aligner.ref_bytes, aligner.thresholds, **params
    ).numpy()
    got, counts = emulate_warp_body(
        reads_T.numpy(), lengths, aligner.ref_bytes.numpy().astype(np.int64),
        aligner.thresholds.numpy().astype(np.int64), R=R, **params,
    )
    assert np.array_equal(got, plain)
    assert int(plain[0].sum()) > 0
    jax_rows = JaxBatchAligner(adapter, e, flags, **args).locate_batch(reads, lengths)
    for row, key in enumerate(("found", "start1", "stop1", "start2", "stop2",
                               "matches", "cost")):
        assert np.array_equal(got[row], np.asarray(jax_rows[key]).astype(np.int32)), key
    return counts, params


#: (R, m): adapters on both sides of the strips' boundary, m + 1 = 32 R - 1,
#: 32 R and 32 R + 1 (row m the last but one, the last row of lane 31, or
#: itself in a lane whose other rows lie past m)
BOUNDARY = [(R, 32 * R + d) for R in (2, 3, 4) for d in (-2, -1, 0)]


@pytest.mark.parametrize("name,flags", FLAG_CASES)
@pytest.mark.parametrize("case", range(len(BOUNDARY)))
def test_warp_walk_equals_plain_version(case, name, flags):
    """Every flag set at every boundary shape; the indel cost, error rate
    and compare mode in turn over the cases, so that each indel cost meets
    each R and both compare modes meet each m."""
    R, m = BOUNDARY[case]
    turn = case + [f for _, f in FLAG_CASES].index(flags)
    indel_cost = (1, 2, 3, 100000)[turn % 4]
    e = {1: (0.1, 0.2, 0.3)[turn % 3], 2: 0.2, 3: 0.3, 100000: (0.3, 0.1)[turn % 2]}[indel_cost]
    wild = bool((case + turn) % 2)
    rng = seeded(case, name, "warp walk")
    letters = "ACGTN" if wild else "ACGT"
    adapter = "".join(letters[i] for i in rng.integers(0, len(letters), m))
    reads, lengths = make_reads(rng, adapter, flags, 64, 2 * m + 40)
    counts, params = run_case(adapter, e, flags, indel_cost, wild, R, reads, lengths)
    assert counts["rounds"] >= counts["columns"] > 0
    if params["ins_cost"] > params["k"]:
        assert counts["rounds"] == counts["columns"]


def chain_adapter(rng, m, before, gap):
    """An adapter whose ``gap`` bases after base ``before`` are none of
    base ``before - 1`` (an A): in a read that lacks them, the column after
    that A has no diagonal match in the gap's rows, so they follow one
    another by insertions, a chain of ``gap`` rows."""
    ad = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)].copy()
    ad[before - 1] = ord("A")
    ad[before : before + gap] = np.frombuffer(b"CGT", np.uint8)[rng.integers(0, 3, gap)]
    return ad.tobytes().decode()


def test_insertion_chain_crosses_lanes():
    """Reads that lack nine bases of the adapter: rows 31-39 of one column
    follow one another by insertions. With two rows a lane that chain
    crosses four lane boundaries, so the fix-up takes several rounds in
    that column; the result still equals the plain version's."""
    R, m = 2, 64
    rng = seeded("chain")
    adapter = chain_adapter(rng, m, 30, 9)
    L = 120
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (32, L))].copy()
    lengths = np.full(32, L, np.int32)
    gapped = adapter[:30] + adapter[39:]  # 55 bases
    for row in range(32):
        reads[row, 40 + row % 8 : 40 + row % 8 + len(gapped)] = np.frombuffer(
            gapped.encode(), np.uint8)
    counts, _ = run_case(adapter, 0.3, BACK, 1, False, R, reads, lengths)
    assert counts["max_rounds"] >= 4, counts
    assert counts["rounds"] > counts["columns"], counts


@pytest.mark.parametrize("R,m", [(2, 62), (28, 200)])
def test_no_indels_settle_in_one_round(R, m):
    """``--no-indels`` (indel cost 100000, so the insertion costs k + 1 and
    never wins): every column takes exactly one round, in which each lane
    that walks recomputes its first row once and finds it stored."""
    rng = seeded("no indels", R, m)
    adapter = "".join("ACGT"[i] for i in rng.integers(0, 4, m))
    reads, lengths = make_reads(rng, adapter, BACK, 64, m + 60)
    counts, params = run_case(adapter, 0.3, BACK, 100000, False, R, reads, lengths)
    assert params["ins_cost"] > params["k"]
    assert counts["rounds"] == counts["columns"] > 0, counts
    assert counts["max_rounds"] == 1
    assert counts["fix_rows"] <= counts["columns"], counts


@pytest.mark.parametrize("m,k,L,kind,row_cap", [
    # the long path's shape: cost 9 + matches 10 + origin 14 bits
    (880, 264, 7328, "warps", 28),
    (896, 268, 7328, "warps", 28),  # row m the last row of lane 31
    (897, 269, 7328, "global", 0),  # past the strips, past one warp's shared column
    (1200, 360, 3072, "global", 0),
    # shapes a 32-bit cell holds reach this kernel only when a caller names
    # it, and keep one read a thread
    (880, 264, 1024, "shared", 0),
    (880, 88, 7328, "shared", 0),
    (33, 3, 1 << 20, "shared", 0),
    # short adapters against very long reads: only 64 bits hold the cell
    (33, 3, 1 << 24, "warps", 28),
    # either side of the 32-bit word: origin 23 bits, then 24
    (33, 3, (1 << 23) - 34, "shared", 0),
    (33, 3, (1 << 23) - 33, "warps", 28),
    (120, 36, 1 << 22, "warps", 28),
    # the payload plane must fit 32 bits: mat 10 + origin 23 bits
    (880, 264, (1 << 23) - 900, "shared", 0),
])
def test_instantiation_picks_the_strips(m, k, L, kind, row_cap):
    """The strips serve the shapes that only the 64-bit word holds, where
    they hold the adapter and the payload fits 32 bits."""
    kernel = cuda_kernel.dp_locate_wide
    assert kernel.fits(m, k, L)
    how = kernel.instantiation(m, k, L)
    assert (how.kind, how.row_cap) == (kind, row_cap)
    if kind == "warps":
        assert how.threads == cuda_kernel.STRIP_THREADS
        assert m <= 32 * cuda_kernel.STRIP_ROWS
        assert not cuda_kernel.dp_locate_word32.fits(m, k, L)
    else:
        assert (how.threads, kind == "global") == kernel.block_layout(m)
    # the 32-bit kernel has no strips
    if cuda_kernel.dp_locate_word32.fits(m, k, L):
        assert cuda_kernel.dp_locate_word32.instantiation(m, k, L).kind != "warps"


@pytest.mark.parametrize("m,k,L", [(1200, 360, 3072), (897, 269, 7328),
                                   (880, 264, (1 << 23) - 900)])
def test_launch_refuses_strips_that_do_not_hold_the_shape(m, k, L):
    """Named by a timing tool for an adapter longer than 32 R bases, or a
    payload wider than 32 bits, the strips are refused before anything
    reaches the card."""
    with pytest.raises(ValueError, match="strips"):
        cuda_kernel.dp_locate_wide.launch(
            torch.zeros((L, 32), dtype=torch.uint8),
            torch.zeros((1, 32), dtype=torch.int32),
            torch.zeros((m,), dtype=torch.uint8),
            torch.zeros((m + 1,), dtype=torch.int32),
            cuda_kernel.Instantiation("warps", cuda_kernel.STRIP_ROWS, 64),
            m=m, k=k, flags=14, min_overlap=3, ins_cost=1, del_cost=1,
            compare_ascii=True,
        )
