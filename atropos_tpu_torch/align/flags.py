"""Alignment flag constants (shared by oracle, batched engine, and adapters).

Flag semantics (reference ``atropos/align/_align.pyx:12-16``):
  START_WITHIN_SEQ1: a prefix of the reference (adapter) may be skipped free.
  START_WITHIN_SEQ2: a prefix of the query (read) may be skipped free.
  STOP_WITHIN_SEQ1 / STOP_WITHIN_SEQ2: same for suffixes.
"""

START_WITHIN_SEQ1 = 1
START_WITHIN_SEQ2 = 2
STOP_WITHIN_SEQ1 = 4
STOP_WITHIN_SEQ2 = 8
SEMIGLOBAL = (
    START_WITHIN_SEQ1 | START_WITHIN_SEQ2 | STOP_WITHIN_SEQ1 | STOP_WITHIN_SEQ2
)

# Cost multiplier used by the no-indel multi-aligner to penalize overhangs
# while still tracking them (reference ``_align.pyx:546``).
OVERHANG_MULTIPLIER = 100000


def _acgt_table():
    """Translation table mapping A/C/G/T (and lowercase, U=T) to one-hot
    low bits; all other characters to 0 (reference ``_align.pyx:31-44``)."""
    d = dict(A=1, C=2, G=4, T=8, U=8)
    t = bytearray(256)
    for c, v in d.items():
        t[ord(c)] = v
        t[ord(c.lower())] = v
    return bytes(t)


def _iupac_table():
    """Translation table mapping IUPAC codes to 4-bit base sets so that two
    characters x, y match iff ``x & y != 0`` (reference ``_align.pyx:46-83``)."""
    A, C, G, T = 1, 2, 4, 8
    d = dict(
        X=0, A=A, C=C, G=G, T=T, U=T,
        R=A | G, Y=C | T, S=G | C, W=A | T, K=G | T, M=A | C,
        B=C | G | T, D=A | G | T, H=A | C | T, V=A | C | G,
        N=A | C | G | T,
    )
    t = bytearray(256)
    for c, v in d.items():
        t[ord(c)] = v
        t[ord(c.lower())] = v
    return bytes(t)


ACGT_TABLE = _acgt_table()
IUPAC_TABLE = _iupac_table()


def translate_pair(ref, query, wildcard_ref, wildcard_query):
    """Return (ref_bytes, query_bytes, compare_ascii) applying the wildcard
    translation rules: if the ref has wildcards it is IUPAC-translated and the
    query ACGT-translated (and vice versa); if neither, raw ASCII compare."""
    ref_b = ref.encode("ascii")
    query_b = query.encode("ascii")
    if wildcard_ref:
        ref_b = ref_b.translate(IUPAC_TABLE)
    elif wildcard_query:
        ref_b = ref_b.translate(ACGT_TABLE)
    if wildcard_query:
        query_b = query_b.translate(IUPAC_TABLE)
    elif wildcard_ref:
        query_b = query_b.translate(ACGT_TABLE)
    compare_ascii = not (wildcard_ref or wildcard_query)
    return ref_b, query_b, compare_ascii
