"""The bit-plane rule of ``csrc/diag_counts.cu`` in numpy, against the
diagonal counts of both packages and the two Pallas kernels.

The CUDA kernels behind ``diag_counts_u8`` and ``diag_counts_i32`` run only
on the card. Their arithmetic is emulated here in the kernel's own split:
the steps over slabs of diagonals and query words (one step where a slab
holds the window), each step's staged rows (the ref rows mod W, so the ref
slab twice, noise in the rows that hold no bytes of a pair, which must
never be counted), each pair's windows packed into
eight bit planes of 32 positions a word by four 8 x 8 bit transposes and a
byte gather (checked against the planes by definition), ``PAIR_LANES``
lanes a pair with lane r taking the
diagonals ``32 d + r + PAIR_LANES i`` (emulated for all 32 shifts at
once), query words in chunks of ``QWORDS``, the ref words funnel-shifted
across word edges, the positions past a diagonal's end masked, and a
popcount a word. The emulation is held
against ``atropos_tpu``'s ``_diagonal_match_counts``, the port's plain
version and, where they compute the same function, the Pallas kernels in
interpret mode: ``_packed_diag_kernel`` pads past W with sentinels and
does not wrap, so it is compared only for m_b <= W and at most 14
symbols; the wrap (m_b > W) is compared with ``_diagonal_match_counts``
and ``_diag_counts_kernel``.

All inputs are made from a seed with numpy; tolerance 0 (integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atropos_tpu.align import batched as jax_batched
from atropos_tpu.align import pallas_kernel
from atropos_tpu_torch.align import batched as port_batched
from atropos_tpu_torch.align import insert_kernel

from .test_torch_align import seeded

torch.set_num_threads(1)

FULL = np.uint64(0xFFFFFFFF)
ALL_BYTES = bytes(range(256))
U8_WIDTHS = (31, 32, 33, 63, 64, 65, 96, 97, 255)
I32_WIDTHS = (256, 288, 289, 320, 512)


def stage(ref_T, query_T, rng, S, d0, dn, j0, jn):
    """The staged rows of one step of ``diag_body`` ([96 S, B] uint8) at a
    slab of S words: the ref rows of the ref words from d0 + j0 on (ref
    position u < 2W is row u mod W) at row 0, the query rows of the query
    words from j0 on at row 64 S, and noise in the rows that hold no bytes
    (packing reads them; the count must never count them)."""
    W, B = query_T.shape
    rows = rng.integers(0, 256, (96 * S, B), dtype=np.uint8)
    base = d0 + j0
    n_ref = max(min(32 * (dn + jn), 2 * W - 32 * base), 0)
    u = 32 * base + np.arange(n_ref)
    rows[:n_ref] = ref_T[np.where(u < W, u, u - W)]
    n_query = min(32 * jn, W - 32 * j0)
    rows[64 * S:64 * S + n_query] = query_T[32 * j0:32 * j0 + n_query]
    return rows


M1, M2, M3 = (np.uint64(m) for m in (0x00AA00AA00AA00AA, 0x0000CCCC0000CCCC, 0x00000000F0F0F0F0))


def transpose8(x):
    """``transpose8``: three delta swaps."""
    for k, m in ((7, M1), (14, M2), (28, M3)):
        k = np.uint64(k)
        t = (x ^ (x >> k)) & m
        x = x ^ t ^ (t << k)
    return x


def pack_word(column):
    """``pack_word`` for all pairs: [32, B] bytes (positions u) -> [B, 8]
    plane words. Four groups of 8 bytes as 64-bit words, each transposed;
    plane p gathers byte p of every group, group g at byte g."""
    groups = column.astype(np.uint64).reshape(4, 8, -1)
    x = (groups << (np.uint64(8) * np.arange(8, dtype=np.uint64))[None, :, None]).sum(axis=1)
    x = transpose8(x)  # [4, B]
    planes = [sum(((x[g] >> np.uint64(8 * p)) & np.uint64(0xFF)) << np.uint64(8 * g)
                  for g in range(4)) for p in range(8)]
    return np.stack(planes, axis=1)  # [B, 8]


def plain_pack(plane_T, c):
    """The plane words of positions 32c .. 32c + 31 by definition: bit u of
    plane p is bit p of byte 32c + u (positions past the plane: 0), and the
    mask of the positions the plane holds."""
    window = plane_T[32 * c:32 * c + 32].astype(np.uint64)[:, :, None]
    bits = (window >> np.arange(8, dtype=np.uint64)) & np.uint64(1)
    words = (bits << np.arange(bits.shape[0], dtype=np.uint64)[:, None, None]).sum(axis=0)
    return words, np.uint64((1 << bits.shape[0]) - 1)


def funnel_r(lo, hi, sh):
    return ((hi << np.uint64(32) | lo) >> sh) & FULL


def past_end(rem):
    """``__funnelshift_lc(0, ~0, max(rem, 0))``: ones at bits >= rem."""
    n = np.minimum(np.maximum(rem, 0), 32).astype(np.uint64)
    return ((FULL << np.uint64(32)) << n >> np.uint64(32)) & FULL


def bitplane_counts(ref_T, query_T, lengths, qwords=4, seed=0, slab=None):
    """The kernel's rule as ``diag_body`` steps through it and
    ``count_pair`` walks it, for all pairs and all 32 shifts at once (a
    lane's share of the shifts changes which lane does the arithmetic, not
    the arithmetic): [W, B] int64 counts. ``slab`` is the slab S in words
    (None: one slab holds the window, S = NW); the steps past the longest
    pair are skipped, as the kernel skips those past its block's."""
    W, B = query_T.shape
    NW = -(-W // 32)
    S = NW if slab is None else slab
    m = np.minimum(np.maximum(lengths.astype(np.int64), 0), 2 * W)
    mw = np.minimum(W, m)
    m_max = int(m.max())
    rng = np.random.default_rng(seed)
    doubled = np.concatenate([ref_T, ref_T])
    sh = np.arange(32, dtype=np.uint64)
    counts = np.zeros((W, B), np.int64)
    for d0 in range(0, NW, S):
        dn = min(S, NW - d0)
        if 32 * d0 >= m_max:
            break  # these rows stay 0, as the kernel writes them
        j0 = 0
        while j0 < NW and (j0 == 0 or 32 * (d0 + j0) < m_max):
            jn = min(S, NW - j0)
            base = d0 + j0
            rows = stage(ref_T, query_T, rng, S, d0, dn, j0, jn)
            r4 = np.stack([pack_word(rows[32 * k:32 * k + 32]) for k in range(dn + jn)], axis=1)
            q4 = np.stack([pack_word(rows[64 * S + 32 * k:64 * S + 32 * k + 32])
                           for k in range(jn)], axis=1)
            # within the planes the words are the planes by definition
            for k in range(jn):
                words, mask = plain_pack(query_T, j0 + k)
                assert np.array_equal(q4[:, k] & mask, words & mask)
            for k in range(dn + jn):
                words, mask = plain_pack(doubled, base + k)
                assert np.array_equal(r4[:, k] & mask, words & mask)
            # count_pair in the step's coordinates: diagonals sl and query
            # positions tl from 32 d0 and 32 j0, ml the ref positions left
            ml = m - 32 * base
            Wl = min(W - 32 * j0, 32 * jn)
            Sl = min(W - 32 * d0, 32 * dn)
            mw = np.minimum(Wl, ml)
            for jj in range(0, jn, qwords):
                for dd in range(dn):
                    lim = np.minimum(Wl, ml - 32 * dd) - 32 * jj
                    live_d = (32 * jj < mw) & (lim > 0)
                    if not live_d.any():
                        break
                    sl = 32 * dd + np.arange(32)
                    rem = np.minimum(Wl, ml[:, None] - sl[None, :]) - 32 * jj
                    acc = np.zeros((B, 32), np.int64)
                    lo = r4[:, dd + jj]
                    for j in range(qwords):
                        live = live_d & (32 * j < lim)
                        if not live.any():
                            break
                        # a live pair reads words this step packed
                        assert dd + jj + j + 1 < dn + jn and jj + j < jn
                        hi = r4[:, dd + jj + j + 1]
                        qj = q4[:, jj + j]
                        x = past_end(rem - 32 * j)
                        for p in range(8):
                            x = x | (qj[:, p, None] ^ funnel_r(lo[:, p, None], hi[:, p, None], sh))
                        acc += np.where(live[:, None], np.bitwise_count(~x & FULL), 0)
                        lo = hi
                    keep = sl < Sl
                    counts[32 * d0 + sl[keep]] += acc[:, keep].T
            j0 += S
    return counts


def planes(rng, W, B, alphabet, lengths):
    """[W, B] uint8 ref and query planes over ``alphabet``, a quarter of
    the pairs with the query read from the ref at a random diagonal (the
    ref wraps), 5 % of its bytes replaced."""
    syms = np.frombuffer(alphabet, np.uint8)
    ref = syms[rng.integers(0, len(syms), (B, W))]
    query = syms[rng.integers(0, len(syms), (B, W))]
    shift = rng.integers(0, W, B)[:, None]
    shifted = np.take_along_axis(ref, (np.arange(W)[None, :] + shift) % W, axis=1)
    shifted = np.where(rng.random((B, W)) < 0.05, query, shifted)
    query = np.where((rng.random(B) < 0.25)[:, None], shifted, query)
    return (np.ascontiguousarray(ref.T), np.ascontiguousarray(query.T),
            lengths.astype(np.int32))


def lengths_for(rng, W, B, case):
    """``within``: m_b in [0, W] with 0, W, 1 and W - 1 among them;
    ``wrap``: m_b in (W, 2W], 2W and W + 1 among them, and a few 0s."""
    if case == "within":
        lengths = rng.integers(0, W + 1, B)
        lengths[:4] = (0, W, 1, max(W - 1, 0))
    else:
        lengths = rng.integers(W + 1, 2 * W + 1, B)
        lengths[:3] = (2 * W, W + 1, 0)
    return lengths


def jax_counts(ref_T, query_T, lengths):
    return np.asarray(
        jax_batched._diagonal_match_counts(
            jnp.asarray(ref_T.astype(np.int32)),
            jnp.asarray(query_T.astype(np.int32)),
            jnp.asarray(lengths[None, :]),
        )
    )


def port_counts(ref_T, query_T, lengths):
    return port_batched._diagonal_match_counts(
        torch.from_numpy(ref_T), torch.from_numpy(query_T),
        torch.from_numpy(lengths),
    ).numpy()


@pytest.mark.parametrize("case", ["within", "wrap"])
@pytest.mark.parametrize("W", U8_WIDTHS + I32_WIDTHS)
def test_bitplanes_equal_both_packages_on_every_byte(W, case):
    """Every byte value, widths at the word edges of both kernels, m_b = 0,
    m_b = W and m_b in (W, 2W]; 300 pairs (no multiple of a tile)."""
    rng = seeded("bitplanes", W, case)
    B = 300
    ref_T, query_T, lengths = planes(rng, W, B, ALL_BYTES, lengths_for(rng, W, B, case))
    got = bitplane_counts(ref_T, query_T, lengths, seed=W)
    expected = jax_counts(ref_T, query_T, lengths)
    assert np.array_equal(got, expected)
    assert np.array_equal(port_counts(ref_T, query_T, lengths), expected)
    assert expected.max() > W // 4  # the planted diagonals are found


@pytest.mark.parametrize("qwords", [1, 2, 3, 8])
@pytest.mark.parametrize("W", [65, 289])
def test_bitplanes_in_other_query_chunks(W, qwords):
    """Query chunks of one to three words, and of eight (a single chunk at
    W = 65), give the same counts as the kernel's four, within and past
    W."""
    rng = seeded("chunks", W, qwords)
    lengths = np.concatenate([lengths_for(rng, W, 40, "within"),
                              lengths_for(rng, W, 20, "wrap")])
    ref_T, query_T, lengths = planes(rng, W, 60, ALL_BYTES, lengths)
    got = bitplane_counts(ref_T, query_T, lengths, qwords, seed=qwords)
    assert np.array_equal(got, jax_counts(ref_T, query_T, lengths))


@pytest.mark.parametrize("slab", [1, 2, 3, 5])
@pytest.mark.parametrize("W", [65, 289, 330])
def test_bitplanes_in_slabs(W, slab):
    """The window cut into slabs of one to five words, as the 32-bit kernel
    cuts the windows that a tile does not hold in one slab (each step
    stages and packs afresh, noise in the rows without bytes), gives the
    same counts, within and past W."""
    rng = seeded("slabs", W, slab)
    lengths = np.concatenate([lengths_for(rng, W, 40, "within"),
                              lengths_for(rng, W, 20, "wrap")])
    ref_T, query_T, lengths = planes(rng, W, 60, ALL_BYTES, lengths)
    got = bitplane_counts(ref_T, query_T, lengths, seed=slab, slab=slab)
    assert np.array_equal(got, jax_counts(ref_T, query_T, lengths))


@pytest.mark.parametrize("slab", [2, 3])
def test_bitplanes_in_slabs_skip_past_the_longest_pair(slab):
    """Short pairs only (m_b <= 70 at W = 300): the steps past the longest
    pair are skipped and their diagonals' rows stay 0."""
    rng = seeded("slab-skip", slab)
    W = 300
    lengths = rng.integers(0, 71, 50)
    lengths[:2] = (70, 0)
    ref_T, query_T, lengths = planes(rng, W, 50, ALL_BYTES, lengths)
    got = bitplane_counts(ref_T, query_T, lengths, seed=slab, slab=slab)
    assert np.array_equal(got, jax_counts(ref_T, query_T, lengths))
    assert not got[70:].any()


def test_bitplanes_at_negative_and_huge_lengths():
    """m_b < 0 counts nothing, m_b > 2W counts as 2W: as the plain
    versions do."""
    rng = seeded("extreme")
    W = 70
    lengths = np.array([-5, -1, 0, 3 * W, 10 ** 6, 2 * W, 2 * W + 1, W], np.int64)
    ref_T, query_T, lengths = planes(rng, W, len(lengths), ALL_BYTES, lengths)
    got = bitplane_counts(ref_T, query_T, lengths)
    assert np.array_equal(got, jax_counts(ref_T, query_T, lengths))
    assert np.array_equal(got, port_counts(ref_T, query_T, lengths))
    assert not got[:, :3].any()


@pytest.mark.parametrize("W", [31, 33, 64, 97, 255])
def test_bitplanes_equal_packed_pallas_kernel(W):
    """Against ``_packed_diag_kernel`` in interpret mode, where it computes
    the same function: m_b <= W, at most 14 symbols."""
    alphabet = b"ACGTNacgtnRYKM"
    rng = seeded("packed-bitplanes", W)
    ref_T, query_T, lengths = planes(rng, W, 256, alphabet, lengths_for(rng, W, 256, "within"))
    matcher = pallas_kernel.PallasPackedInsertMatcher(alphabet)
    matcher.INTERPRET = True
    matcher.BLOCK = 128
    assert matcher.usable(W)
    expected = np.asarray(matcher.counts(
        jnp.asarray(ref_T.astype(np.int32)), jnp.asarray(query_T.astype(np.int32)),
        jnp.asarray(lengths[None, :]),
    ))
    assert np.array_equal(bitplane_counts(ref_T, query_T, lengths), expected)
    got = insert_kernel.diag_counts_u8(
        torch.from_numpy(ref_T), torch.from_numpy(query_T), torch.from_numpy(lengths))
    assert np.array_equal(got.numpy().astype(np.int64), expected)


@pytest.mark.parametrize("case", ["within", "wrap"])
@pytest.mark.parametrize("W", [33, 255, 289])
def test_bitplanes_equal_unpacked_pallas_kernel(W, case):
    """Against ``_diag_counts_kernel`` in interpret mode (it rolls the ref
    plane, so it wraps as the plain versions do), on every byte value."""
    rng = seeded("unpacked-bitplanes", W, case)
    ref_T, query_T, lengths = planes(rng, W, 128, ALL_BYTES, lengths_for(rng, W, 128, case))
    matcher = pallas_kernel.PallasInsertMatcher()
    matcher.INTERPRET = True
    matcher.BLOCK = 128
    expected = np.asarray(matcher.counts(
        jnp.asarray(ref_T.astype(np.int32)), jnp.asarray(query_T.astype(np.int32)),
        jnp.asarray(lengths[None, :]),
    ))
    assert np.array_equal(bitplane_counts(ref_T, query_T, lengths), expected)
    got = insert_kernel.diag_counts_i32(
        torch.from_numpy(ref_T), torch.from_numpy(query_T), torch.from_numpy(lengths))
    assert np.array_equal(got.numpy(), expected)
