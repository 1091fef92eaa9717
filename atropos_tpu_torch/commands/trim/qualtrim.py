"""Quality trimming index computation (scalar spec versions).

Semantics are the BWA-style partial-sum trim used by the reference
(``atropos/commands/trim/_qualtrim.pyx``): running sum of ``cutoff - q``
from each end, trim at the argmax, stopping as soon as the sum goes
negative. The batched device version (a masked prefix-scan over the quality
tensor) lives in :mod:`atropos_tpu_torch.align.batched`; this module is its oracle
and the host fallback.
"""


def quality_trim_index(qualities, cutoff_front, cutoff_back, base=33):
    """Return (start, stop) delimiting the good-quality segment.

    The 5' scan accumulates ``cutoff_front - q`` left-to-right; the trim
    point is one past the position of the maximum positive sum; the scan
    stops early once the sum goes negative. The 3' scan is symmetric.
    """
    stop = len(qualities)
    start = 0

    s = 0
    max_qual = 0
    for i in range(len(qualities)):
        s += cutoff_front - (ord(qualities[i]) - base)
        if s < 0:
            break
        if s > max_qual:
            max_qual = s
            start = i + 1

    max_qual = 0
    s = 0
    for i in reversed(range(len(qualities))):
        s += cutoff_back - (ord(qualities[i]) - base)
        if s < 0:
            break
        if s > max_qual:
            max_qual = s
            stop = i
    if start >= stop:
        start, stop = 0, 0
    return (start, stop)


def nextseq_trim_index(sequence, cutoff, base=33):
    """3'-end quality trim for NextSeq two-color chemistry: 'G' bases are
    treated as having quality ``cutoff - 1`` (dark-cycle artifact)."""
    bases = sequence.sequence
    qualities = sequence.qualities
    s = 0
    max_qual = 0
    max_i = len(qualities)
    for i in reversed(range(len(qualities))):
        q = ord(qualities[i]) - base
        if bases[i] == "G":
            q = cutoff - 1
        s += cutoff - q
        if s < 0:
            break
        if s > max_qual:
            max_qual = s
            max_i = i
    return max_i
