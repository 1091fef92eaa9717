"""FastQC-style read statistics over fixed-shape count tensors.

Counterpart of ``atropos_tpu/commands/stats.py``, pruned to what the
turbo runners' ``--stats`` uses: statistics accumulate into dense count
matrices — ``[Lmax, 256]`` per-position byte composition for bases and
qualities, dense histogram vectors for length and GC content — straight
from the padded ``[B, W]`` byte matrices the runners already hold
(:meth:`ReadStatistics.collect_matrices`). Summaries render to the exact
dict schema of the reference, so reports are unchanged.

The per-position byte counts run where the run runs:
:func:`position_byte_counts` is one torch function on the statistics'
device (the reference counts with a nibble one-hot product on its
accelerator and with a host bincount below 256 reads or on the CPU; both
give the same integers). ``DEVICE_STATS_COUNTS`` counts its calls by
device type, so a run can show that the counts ran on the card.
"""
import numpy as np
import torch

from atropos_tpu_torch import resolve_device
from atropos_tpu_torch.util import (
    Histogram,
    Mergeable,
    Summarizable,
    ordered_dict,
)

_ASCII = 256

#: calls of :func:`position_byte_counts`, by the type of the device they
#: ran on
DEVICE_STATS_COUNTS = {"cuda": 0, "cpu": 0}


def position_byte_counts(matrix, lengths, device):
    """``[W, 256]`` int64 counts of each byte at each position of a padded
    ``[B, W]`` uint8 matrix, over the positions below each row's length,
    computed on ``device``: one scatter-add of the in-length positions into
    a flat ``W * 256`` table (integer atomics on a card, so exact in any
    order)."""
    width = matrix.shape[1]
    data = torch.from_numpy(np.ascontiguousarray(matrix)).to(device)
    lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int64)).to(device)
    pos = torch.arange(width, device=device, dtype=torch.int64)
    index = (pos[None, :] * _ASCII + data.to(torch.int64)).reshape(-1)
    valid = (pos[None, :] < lens[:, None]).reshape(-1).to(torch.int64)
    counts = torch.zeros(width * _ASCII, dtype=torch.int64, device=device)
    counts.scatter_add_(0, index, valid)
    DEVICE_STATS_COUNTS[torch.device(device).type] += 1
    return counts.reshape(width, _ASCII).cpu().numpy()


def _grow_rows(matrix, rows):
    """Return ``matrix`` with at least ``rows`` rows (zero-padded)."""
    if matrix.shape[0] >= rows:
        return matrix
    grown = np.zeros((rows,) + matrix.shape[1:], dtype=matrix.dtype)
    grown[: matrix.shape[0]] = matrix
    return grown


class DenseHistogram(Mergeable, Summarizable):
    """Histogram over small non-negative integers, stored densely.

    Renders through :class:`~atropos_tpu_torch.util.Histogram` so the
    summary schema (sorted hist + mean/stdev/median/modes) is unchanged.
    """

    def __init__(self, size=128):
        self.counts = np.zeros(size, np.int64)

    def add_vector(self, values):
        top = int(values.max()) if values.size else 0
        if top >= self.counts.shape[0]:
            self.counts = _grow_rows(self.counts, top + 1)
        self.counts += np.bincount(values, minlength=self.counts.shape[0])

    def merge(self, other):
        if not isinstance(other, DenseHistogram):
            raise ValueError("cannot merge {}".format(type(other)))
        rows = max(self.counts.shape[0], other.counts.shape[0])
        self.counts = _grow_rows(self.counts, rows)
        self.counts[: other.counts.shape[0]] += other.counts
        return self

    def as_histogram(self):
        rendered = Histogram()
        for value in np.nonzero(self.counts)[0]:
            rendered[int(value)] = int(self.counts[value])
        return rendered

    def summarize(self):
        return self.as_histogram().summarize()


class PositionByteCounts(Mergeable, Summarizable):
    """``[positions, 256]`` count matrix: how often each byte (base char or
    quality char) occurs at each read position."""

    def __init__(self, is_qualities=False, quality_base=33, device="cpu"):
        self.counts = np.zeros((0, _ASCII), np.int64)
        self.is_qualities = is_qualities
        self.quality_base = quality_base
        self.device = device

    def add_batch(self, matrix, lengths):
        """Accumulate a padded ``[B, L]`` byte matrix, masking padding, by
        :func:`position_byte_counts` on this table's device."""
        width = matrix.shape[1]
        self.counts = _grow_rows(self.counts, width)
        self.counts[:width] += position_byte_counts(matrix, lengths, self.device)

    def merge(self, other):
        if not isinstance(other, PositionByteCounts):
            raise ValueError("cannot merge {}".format(type(other)))
        rows = max(self.counts.shape[0], other.counts.shape[0])
        self.counts = _grow_rows(self.counts, rows)
        self.counts[: other.counts.shape[0]] += other.counts
        return self

    def observed_bytes(self):
        return np.nonzero(self.counts.any(axis=0))[0]

    def column_order(self):
        """(column labels, byte codes) in report order: qualities sort by
        character; bases render as A,C,G,T,<others>,N with A/C/G/T/N
        always present."""
        seen = self.observed_bytes()
        if self.is_qualities:
            keys = [int(code) for code in seen]
            return tuple(code - self.quality_base for code in keys), keys
        named = [chr(code) for code in seen]
        acgt = ["A", "C", "G", "T"]
        extras = sorted(set(named) - set(acgt + ["N"]))
        labels = acgt + extras + ["N"]
        return tuple(labels), [ord(ch) for ch in labels]

    def summarize(self):
        columns, codes = self.column_order()
        return dict(
            columns=columns,
            rows=ordered_dict(
                (pos + 1, tuple(int(c) for c in self.counts[pos, codes]))
                for pos in range(self.counts.shape[0])
            ),
        )


class TilePositionCounts(Mergeable, Summarizable):
    """Per-tile :class:`PositionByteCounts` (``--stats :tiles`` mode). The
    turbo runners decline per-tile statistics, which need every record's
    name; what is kept here is how a table of tiles merges and renders."""

    def __init__(self, is_qualities=False, quality_base=33):
        self.tiles = {}
        self.is_qualities = is_qualities
        self.quality_base = quality_base

    def merge(self, other):
        if not isinstance(other, TilePositionCounts):
            raise ValueError("cannot merge {}".format(type(other)))
        for tile, table in other.tiles.items():
            if tile in self.tiles:
                self.tiles[tile].merge(table)
            else:
                self.tiles[tile] = table
        return self

    def summarize(self):
        tiles = tuple(sorted(self.tiles))
        seen = set()
        for table in self.tiles.values():
            seen.update(int(code) for code in table.observed_bytes())
        codes = sorted(seen)
        if self.is_qualities:
            columns = tuple(code - self.quality_base for code in codes)
        else:
            columns = tuple(chr(code) for code in codes)
        positions = max(
            (table.counts.shape[0] for table in self.tiles.values()), default=0
        )

        def row(pos):
            cells = ordered_dict([])
            for tile in tiles:
                counts = self.tiles[tile].counts
                if pos < counts.shape[0]:
                    cells[tile] = tuple(int(c) for c in counts[pos, codes])
                else:
                    cells[tile] = tuple(0 for _ in codes)
            return cells

        return dict(
            columns=columns,
            columns2=tiles,
            rows=ordered_dict((pos + 1, row(pos)) for pos in range(positions)),
        )


class ReadStatistics:
    """Read-level and position-level statistics for one input source,
    without per-tile tables. ``device`` is where the position counts run
    (``None`` means ``cuda``)."""

    def __init__(self, qualities=None, quality_base=33, device=None):
        self.device = resolve_device(device)
        self.count = 0
        self.sequence_lengths = DenseHistogram()
        self.sequence_gc = DenseHistogram(101)
        self.bases = PositionByteCounts(device=self.device)

        self.qualities = qualities
        self.quality_base = quality_base
        self.sequence_qualities = None
        self.base_qualities = None
        if qualities:
            self._init_qualities()

    def _init_qualities(self):
        self.sequence_qualities = Histogram()
        self.base_qualities = PositionByteCounts(
            is_qualities=True, quality_base=self.quality_base,
            device=self.device,
        )

    # -- collection ----------------------------------------------------------

    def collect_matrices(self, seqs, quals, lengths):
        """Vectorized collection straight from padded uint8 matrices
        (``[B, W]`` sequences/qualities + a length vector), the form the
        turbo runners hold. Bytes beyond each read's length are ignored."""
        count = lengths.shape[0]
        if count == 0:
            return
        if self.qualities is None and quals is not None:
            self.qualities = True
            self._init_qualities()

        self.count += count
        self.sequence_lengths.add_vector(lengths)

        nonempty = lengths > 0
        if not nonempty.any():
            return
        # clip padded matrices to the longest read so position tables
        # never grow all-zero rows beyond the observed lengths
        width = int(lengths.max())
        if seqs.shape[1] > width:
            seqs = seqs[:, :width]
            if quals is not None:
                quals = quals[:, :width]
        else:
            width = seqs.shape[1]
        valid = np.arange(width)[None, :] < lengths[:, None]
        gc = (((seqs == ord("C")) | (seqs == ord("G"))) & valid).sum(axis=1)
        live = lengths[nonempty]
        gc_pct = np.rint(gc[nonempty] * 100 / live).astype(np.int64)
        self.sequence_gc.add_vector(gc_pct)
        self.bases.add_batch(seqs[nonempty], live)

        if not (self.qualities and quals is not None):
            return
        quals = quals[nonempty]
        sums = (quals * valid[nonempty]).sum(axis=1, dtype=np.int64)
        mean_quality = np.rint(
            (sums - live.astype(np.int64) * self.quality_base) / live
        ).astype(np.int64)
        for value in mean_quality:
            self.sequence_qualities[int(value)] += 1
        self.base_qualities.add_batch(quals, live)

    # -- rendering -----------------------------------------------------------

    def summarize(self):
        summary = dict(
            counts=self.count,
            lengths=self.sequence_lengths.summarize(),
            gc=self.sequence_gc.summarize(),
            bases=self.bases,
        )
        if self.sequence_qualities is not None:
            summary["qualities"] = self.sequence_qualities
        if self.base_qualities is not None:
            summary["base_qualities"] = self.base_qualities
        return summary


class SingleEndReadStatistics(ReadStatistics):
    def summarize(self):
        return dict(read1=super().summarize())


class PairedEndReadStatistics:
    def __init__(self, **kwargs):
        self.read1 = ReadStatistics(**kwargs)
        self.read2 = ReadStatistics(**kwargs)

    def summarize(self):
        return dict(read1=self.read1.summarize(), read2=self.read2.summarize())
