"""The 16-bit probe kernel's rule on 32-bit words, emulated in numpy.

``dtype_probe_i16x2`` (``atropos_tpu_torch/csrc/dtype_probe.cu``) keeps
two reads' 16-bit cells in each 32-bit word and computes the column body
of ``tools/perf_dtype_probe.py::body_full`` as addends, DPX minima and
selects by halfword masks (the note at the top of the source). This file
writes the kernel's steps on words held in int64 numpy arrays: every
plain 32-bit add, subtract and multiply, and each DPX intrinsic, is a
function that asserts what the kernel's head note proves, that no
halfword reaches 65,536 or goes below 0 (so nothing carries or borrows
across halfwords and no DPX sum wraps). Split over ``lanes`` lanes a pair
as the kernel's ``PAIR_LANES`` splits it, the emulation is held against
``body_full`` in interpret mode with int16 and int32 state, against the
port's plain version ``probe_columns``, and from any start state against
the scalar rule.

With the zero start of the probe, pack never leaves 0 and 1 after a
column, so no relaxation pass ever takes and no compare ties: whole-probe
runs exercise the cell step only. The relaxation (takes and ties among
them) is covered by the runs from random start states, held against
``body_full`` itself made to start from them, and by the exhaustive
checks of one cell step and one pass over every pair of pack values in
0..530.
"""
import ast
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from atropos_tpu_torch.tools import dtype_probe
from atropos_tpu_torch.tools.dtype_probe import M1, OUT_ROWS, probe_columns
from tests.test_torch_dtype_probe import TOOL, _body_full_node, reference

torch.set_num_threads(1)

M = M1 - 1
SEEDS = (0, 1, 2)
LANES = (1, 2)  # one lane a read pair, and the rows split over two
ONES = 0x00010001
NEVER = 0x4000
NEVER2 = NEVER * ONES
KEEP, CAP = 0xFF80FF80, 0x02000200


# -- words and the instructions on them ---------------------------------------


def halves(word):
    word = np.asarray(word, np.int64)
    return word & 0xFFFF, word >> 16


def join(lo, hi):
    """The word of two halfwords, each of which must lie in 0..65,535."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    assert (lo >= 0).all() and (hi >= 0).all(), "a halfword borrowed"
    assert (lo < 65536).all() and (hi < 65536).all(), "a halfword carried"
    return lo | (hi << 16)


def add(a, b):
    """A plain 32-bit add (``IADD3``): no halfword may carry."""
    (al, ah), (bl, bh) = halves(a), halves(b)
    return join(al + bl, ah + bh)


def sub(a, b):
    """A plain 32-bit subtract: no halfword may borrow."""
    (al, ah), (bl, bh) = halves(a), halves(b)
    return join(al - bl, ah - bh)


def mul(a, k):
    """A 32-bit multiply by a constant (``IMAD``): no halfword may carry."""
    al, ah = halves(a)
    return join(al * k, ah * k)


def vminu2(a, b):
    """``__vminu2``: the halfwords' unsigned minimum."""
    (al, ah), (bl, bh) = halves(a), halves(b)
    return join(np.minimum(al, bl), np.minimum(ah, bh))


def viaddmin_u16x2(a, b, c):
    """``__viaddmin_u16x2``: min(a + b, c) a halfword; the sum must not wrap."""
    (al, ah), (bl, bh), (cl, ch) = halves(a), halves(b), halves(c)
    sl, sh = al + bl, ah + bh
    assert (sl < 65536).all() and (sh < 65536).all(), "a DPX sum wrapped"
    return join(np.minimum(sl, cl), np.minimum(sh, ch))


def select(mask, a, b):
    """``(a & mask) | (b & ~mask)``: one ``LOP3``."""
    return (a & mask) | (b & ~mask & 0xFFFFFFFF)


def words_of(low, high):
    """Words of two reads' values (``__byte_perm`` of the two bytes)."""
    return join(np.asarray(low, np.int64), np.asarray(high, np.int64))


# -- the kernel's steps --------------------------------------------------------


def cell_step(up_pack, up_pay, pack, pay, rd, q):
    """One row of the cell step: (pack, pay, relax addend) of the row."""
    ne = vminu2(rd ^ q, ONES)
    ne_mask = mul(ne, 0xFFFF)
    relax = sub(NEVER2, mul(ne, NEVER - 2))
    dele = add(pack, sub(NEVER2 + 3 * ONES, mul(ne, NEVER)))
    new_pack = viaddmin_u16x2(up_pack, ne, dele)
    new_pay = select(ne_mask, pay, add(up_pay, ONES))
    return new_pack, new_pay, relax


def pass_step(up_pack, up_pay, pack, pay, relax):
    """One row of a relaxation pass: (pack, pay, take mask) of the row."""
    low = viaddmin_u16x2(up_pack, relax, pack)
    take = mul(vminu2(sub(pack, low), ONES), 0xFFFF)
    return low, select(take, up_pay, pay), take


def kernel_words(reads, dyn, lanes, start=None):
    """``dtype_probe_i16x2`` on a [L, N] uint8 plane, its rows split over
    ``lanes`` lanes a pair: -> [8, N] out and [2, M1, N] state, int64.
    ``start`` ([2, M1, N]: pack, then pay) replaces the zero start."""
    L, N = reads.shape
    rl = M1 // lanes
    plane = words_of(reads[:, 0::2], reads[:, 1::2])  # [L, pairs]
    pairs = N // 2
    if start is None:
        start = np.zeros((2, M1, N), np.int64)
    pack = words_of(start[0][:, 0::2], start[0][:, 1::2]).reshape(lanes, rl, pairs)
    pay = words_of(start[1][:, 0::2], start[1][:, 1::2]).reshape(lanes, rl, pairs)
    rd = np.stack([
        np.stack([plane[max(part * rl + r - 1, 0)] for r in range(rl)]) for part in range(lanes)
    ])
    first = plane[0]

    def up(rows):
        # each row's row above, as the descending row loop reads it: the
        # values before the step (the row above is written after it). A
        # part's first row takes part p - 1's last by __shfl_up_sync; part
        # 0 takes the previous pair's last part, a result nothing keeps
        last = rows[:, rl - 1]
        above = np.concatenate([np.roll(last[lanes - 1:], 1, axis=-1), last[:lanes - 1]])
        return np.concatenate([above[:, None], rows[:, :rl - 1]], axis=1)

    for j in range(1, L + 1):
        q = plane[j - 1] if dyn else first
        keep_pack, keep_pay = pack[0, 0].copy(), pay[0, 0].copy()
        pack, pay, relax = cell_step(up(pack), up(pay), pack, pay, rd, q)
        pack[0, 0], pay[0, 0], relax[0, 0] = keep_pack, keep_pay, NEVER2
        for _ in range(3):
            pack, pay, _take = pass_step(up(pack), up(pay), pack, pay, relax)
        pack = vminu2(pack & KEEP, CAP)
    pack, pay = pack.reshape(M1, pairs), pay.reshape(M1, pairs)
    out = add(pack[:OUT_ROWS], pay[:OUT_ROWS])

    def unpack(words):
        values = np.empty(words.shape[:-1] + (N,), np.int64)
        values[..., 0::2], values[..., 1::2] = halves(words)
        return values

    return unpack(out), np.stack([unpack(pack), unpack(pay)])


def scalar_columns(reads, dyn, start=None):
    """The rule of ``body_full`` a cell at a time in int64 from ``start``
    ([2, M1, N], zero if None): -> ([8, N], [2, M1, N], takes, ties)."""
    L, N = reads.shape
    reads = reads.astype(np.int64)
    if start is None:
        start = np.zeros((2, M1, N), np.int64)
    pack, pay = start[0].copy(), start[1].copy()
    takes = ties = 0
    for j in range(1, L + 1):
        q = reads[j - 1] if dyn else reads[0]
        eq = reads[:M] == q
        elem = np.where(eq, pack[:M], np.minimum(pack[:M] + 1, pack[1:] + 3))
        pay_e = np.where(eq, pay[:M] + 1, pay[1:])
        pack = np.concatenate([pack[:1], elem])
        pay = np.concatenate([pay[:1], pay_e])
        for _ in range(3):
            cand, tail = pack[:M] + 2, pack[1:]
            take = (cand < tail) & ~eq
            takes += int(take.sum())
            ties += int(((cand == tail) & ~eq).sum())
            pack = np.concatenate([pack[:1], np.where(take, cand, tail)])
            pay = np.concatenate([pay[:1], np.where(take, pay[:M], pay[1:])])
        pack = np.minimum(pack & ~127, 512)
    return pack[:OUT_ROWS] + pay[:OUT_ROWS], np.stack([pack, pay]), takes, ties


def random_reads(seed, symbols, n_columns, n_reads):
    rng = np.random.default_rng([seed, symbols, n_columns, n_reads])
    return rng.integers(0, symbols, (n_columns, n_reads), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def body_full_out(seed, symbols, dyn, int16):
    """``body_full`` in interpret mode on ``random_reads(seed, symbols,
    104, 128)``, int16 or int32 state (once for both lane counts)."""
    reads = random_reads(seed, symbols, 104, 128)
    return reference(reads, jnp.int16 if int16 else jnp.int32, True, dyn)


class _FromStart(ast.NodeTransformer):
    """``body_full`` made to start from given planes and to store its final
    state: ``pack0`` and ``pay0`` are read from two more inputs instead of
    being zeros, and the final ``pack`` and ``pay`` go to two more outputs.
    The column rule itself is the tool's source, untouched."""

    def __init__(self):
        self.replaced = []

    def visit_FunctionDef(self, node):
        if node.name != "body_full":  # the column body inside it
            return self.generic_visit(node)
        node.args.args[1:1] = [ast.arg("pack0_ref"), ast.arg("pay0_ref")]
        node.args.args[4:4] = [ast.arg("pack_ref"), ast.arg("pay_ref")]
        self.generic_visit(node)
        node.body += ast.parse("pack_ref[...] = pack.astype(jnp.int32)\n"
                               "pay_ref[...] = pay.astype(jnp.int32)").body
        return node

    def visit_Assign(self, node):
        (target,) = node.targets
        if isinstance(target, ast.Name) and target.id in ("pack0", "pay0"):
            self.replaced.append(target.id)
            node.value = ast.parse("{}_ref[...].astype(dt)".format(target.id),
                                   mode="eval").body
        return node


def body_full_from(reads, start, int16, dyn):
    """``body_full`` in interpret mode from ``start`` ([2, M1, N]: pack, then
    pay) instead of zeros: -> ([8, N] out, [2, M1, N] final state)."""
    n_columns, n_reads = reads.shape
    change = _FromStart()
    node = change.visit(_body_full_node())
    assert sorted(change.replaced) == ["pack0", "pay0"]
    namespace = dict(jnp=jnp, lax=lax, pl=pl, M1=M1, B=n_reads, L=n_columns)
    exec(compile(ast.fix_missing_locations(ast.Module(body=[node], type_ignores=[])),
                 TOOL, "exec"), namespace)
    kern = functools.partial(namespace["body_full"], dt=jnp.int16 if int16 else jnp.int32,
                             use_concat=True, use_dyn=dyn)
    plane = jax.ShapeDtypeStruct((M1, n_reads), jnp.int32)
    call = pl.pallas_call(
        kern, out_shape=(jax.ShapeDtypeStruct((OUT_ROWS, n_reads), jnp.int32), plane, plane),
        interpret=True,
    )
    out, pack, pay = call(jnp.asarray(reads).astype(jnp.int32),
                          jnp.asarray(start[0], jnp.int32), jnp.asarray(start[1], jnp.int32))
    return np.asarray(out), np.stack([np.asarray(pack), np.asarray(pay)])


# -- the tests -----------------------------------------------------------------


def test_the_instructions_assert_their_range():
    with pytest.raises(AssertionError, match="carried"):
        add(0xFFFF, 1)
    with pytest.raises(AssertionError, match="borrowed"):
        sub(0x00010000, 1)
    with pytest.raises(AssertionError, match="carried"):
        mul(0x00020000, 0xFFFF)
    with pytest.raises(AssertionError, match="wrapped"):
        viaddmin_u16x2(0xFFFF0000, 0x00010000, 0)
    assert add(0x7FFF0001, 0x00020003) == 0x80010004
    assert viaddmin_u16x2(0x00050001, 0x00010001, 0x00040007) == 0x00040002


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("symbols", [4, 256], ids=["bytes0-3", "bytes0-255"])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
def test_words_equal_body_full(dyn, symbols, lanes):
    """Against the TPU tool's kernel in interpret mode, int16 and int32."""
    for seed in SEEDS:
        out, _ = kernel_words(random_reads(seed, symbols, 104, 128), dyn, lanes)
        for int16 in (True, False):
            assert np.array_equal(out, body_full_out(seed, symbols, dyn, int16)), (seed, int16)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("symbols", [4, 256, *dtype_probe.PLANES])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
def test_words_equal_probe_columns(dyn, symbols, lanes):
    """Against the port's plain version, the whole final state compared,
    on a few hundred reads of random bytes and of the planes of
    ``dtype_probe.PLANES``."""
    for seed in SEEDS:
        if symbols in dtype_probe.PLANES:
            reads = dtype_probe.make_plane(symbols, seed, 120, 300)
        else:
            reads = torch.from_numpy(random_reads(seed, symbols, 120, 300))
        expected, expected_state = probe_columns(reads, torch.int16, dyn, state=True)
        out, state = kernel_words(reads.numpy(), dyn, lanes)
        assert np.array_equal(out, expected.numpy()), seed
        assert np.array_equal(state, expected_state.numpy()), seed


def test_the_scalar_rule_is_probe_columns():
    reads = torch.from_numpy(random_reads(5, 4, 60, 64))
    for dyn in (True, False):
        out, state, takes, ties = scalar_columns(reads.numpy(), dyn)
        expected, expected_state = probe_columns(reads, torch.int32, dyn, state=True)
        assert np.array_equal(out, expected.numpy())
        assert np.array_equal(state, expected_state.numpy())
        # the zero start never lets a pass take (see the module docstring)
        assert takes == ties == 0
        assert int(expected_state[0].max()) <= 1


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("symbols", [4, 256, *dtype_probe.PLANES])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
def test_words_from_any_start_equal_the_scalar_rule(dyn, symbols, lanes):
    """From random start states (pack 0..512, pay 0..L) the passes take
    and tie, and the words still equal the scalar rule."""
    L, N = 40, 200
    for seed in SEEDS:
        rng = np.random.default_rng([seed, 17, lanes])
        if symbols in dtype_probe.PLANES:
            reads = dtype_probe.make_plane(symbols, seed, L, N).numpy()
        else:
            reads = random_reads(seed, symbols, L, N)
        start = np.stack([rng.integers(0, 513, (M1, N)), rng.integers(0, L + 1, (M1, N))])
        out, state, takes, ties = scalar_columns(reads, dyn, start)
        got_out, got_state = kernel_words(reads, dyn, lanes, start)
        assert np.array_equal(got_out, out) and np.array_equal(got_state, state), seed
        # every compare of the equal plane is equal: nothing to take
        assert (takes > 0 and ties > 0) == (symbols != "equal"), (takes, ties)


@pytest.mark.parametrize("int16", [True, False], ids=["int16", "int32"])
@pytest.mark.parametrize("symbols", [4, 256], ids=["bytes0-3", "bytes0-255"])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
def test_the_scalar_rule_from_any_start_is_body_full(dyn, symbols, int16):
    """From one random non-zero start (pack 0..512, pay 0..L), where the
    passes take and tie, the scalar rule and the words (both lane counts)
    equal ``body_full`` in interpret mode, the whole final state compared:
    the strict ``<`` of a take and the tie that keeps the tail come from
    the TPU tool's kernel, not from this file."""
    L, N = 40, 128
    rng = np.random.default_rng([23, symbols])
    reads = random_reads(7, symbols, L, N)
    start = np.stack([rng.integers(0, 513, (M1, N)), rng.integers(0, L + 1, (M1, N))])
    want_out, want_state = body_full_from(reads, start, int16, dyn)
    out, state, takes, ties = scalar_columns(reads, dyn, start)
    assert takes > 0 and ties > 0, (takes, ties)
    assert np.array_equal(out, want_out) and np.array_equal(state, want_state)
    for lanes in LANES:
        got_out, got_state = kernel_words(reads, dyn, lanes, start)
        assert np.array_equal(got_out, want_out), lanes
        assert np.array_equal(got_state, want_state), lanes


def _pair_grid(limit, seed):
    """Every (a, b) in 0..limit, in the low halfwords, and a shuffle of
    them in the high halfwords."""
    a, b = (v.ravel() for v in np.meshgrid(np.arange(limit + 1), np.arange(limit + 1)))
    order = np.random.default_rng(seed).permutation(a.size)
    return (a, b), (a[order], b[order])


@pytest.mark.parametrize("eq", [0, 1], ids=["differ", "equal"])
def test_one_cell_step_over_every_pack_pair(eq):
    """Every (pack[i], pack[i+1]) in 0..530 with pay pairs drawn in 0..L,
    in both halfwords, against the scalar rule of one cell."""
    L = 160
    (a_lo, b_lo), (a_hi, b_hi) = _pair_grid(530, 1 + eq)
    rng = np.random.default_rng(eq)
    pays = rng.integers(0, L + 1, (4, a_lo.size))
    byte = rng.integers(0, 256, (2, a_lo.size))
    other = (byte + rng.integers(1, 256, byte.shape)) % 256
    q = words_of(byte[0], byte[1])
    rd = q if eq else words_of(other[0], other[1])
    got = [halves(w) for w in cell_step(words_of(a_lo, a_hi), words_of(pays[0], pays[1]),
                                        words_of(b_lo, b_hi), words_of(pays[2], pays[3]),
                                        rd, q)]
    for half, (up, tail, up_pay, tail_pay) in enumerate(
        ((a_lo, b_lo, pays[0], pays[2]), (a_hi, b_hi, pays[1], pays[3]))
    ):
        got_pack, got_pay, got_relax = (g[half] for g in got)
        want_pack = up if eq else np.minimum(up + 1, tail + 3)
        want_pay = up_pay + 1 if eq else tail_pay
        assert np.array_equal(got_pack, want_pack)
        assert np.array_equal(got_pay, want_pay)
        assert (got_relax == (NEVER if eq else 2)).all()


@pytest.mark.parametrize("eq", [0, 1], ids=["differ", "equal"])
def test_one_pass_step_over_every_pack_pair(eq):
    """Every (pack[i], pack[i+1]) in 0..530 with pay pairs drawn in 0..L,
    in both halfwords, against the scalar rule of one relaxation pass:
    take only where pack[i] + 2 < pack[i+1] strictly, a tie keeps the
    tail's pay."""
    L = 160
    (a_lo, b_lo), (a_hi, b_hi) = _pair_grid(530, 3 + eq)
    pays = np.random.default_rng(10 + eq).integers(0, L + 1, (4, a_lo.size))
    relax = np.full(a_lo.shape, NEVER2 if eq else 2 * ONES, np.int64)
    got = [halves(w) for w in pass_step(words_of(a_lo, a_hi), words_of(pays[0], pays[1]),
                                        words_of(b_lo, b_hi), words_of(pays[2], pays[3]),
                                        relax)]
    ties = 0
    for half, (up, tail, up_pay, tail_pay) in enumerate(
        ((a_lo, b_lo, pays[0], pays[2]), (a_hi, b_hi, pays[1], pays[3]))
    ):
        got_pack, got_pay, got_take = (g[half] for g in got)
        want_take = (up + 2 < tail) & (eq == 0)
        assert np.array_equal(got_take, np.where(want_take, 0xFFFF, 0))
        assert np.array_equal(got_pack, np.where(want_take, up + 2, tail))
        assert np.array_equal(got_pay, np.where(want_take, up_pay, tail_pay))
        ties += int(((up + 2 == tail) & (up_pay != tail_pay)).sum())
    assert ties > 0
