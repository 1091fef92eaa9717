"""FastQC-style read statistics over fixed-shape count tensors.

Counterpart of ``atropos_tpu/commands/stats.py`` for ``trim --stats`` and
the qc command:
statistics accumulate into dense count matrices — ``[Lmax, 256]``
per-position byte composition for bases and qualities, dense histogram
vectors for length and GC content — straight from the padded ``[B, W]``
byte matrices the turbo runners already hold
(:meth:`ReadStatistics.collect_matrices`). The per-record pipeline, which
the reference feeds one record at a time (``collect_record``), hands over
a batch's records at once (:meth:`ReadStatistics.collect_records`), with
the reference's per-record order and rules kept, including the per-tile
tables of ``--stats :tiles``; the qc command's record pipeline collects a
batch as the reference's does (:meth:`ReadStatistics.collect_batch`).
Summaries render to the exact dict schema of the reference, so reports are
unchanged.

The per-position byte counts run where the run runs:
:func:`position_byte_counts` is one torch function on the statistics'
device (the reference counts with a nibble one-hot product on its
accelerator and with a host bincount below 256 reads or on the CPU; both
give the same integers). ``DEVICE_STATS_COUNTS`` counts its calls by
device type, so a run can show that the counts ran on the card.
"""
import re

import numpy as np
import torch

from atropos_tpu_torch import resolve_device
from atropos_tpu_torch.util import (
    Histogram,
    Mergeable,
    NestedDict,
    Summarizable,
    ordered_dict,
)

DEFAULT_TILE_KEY_REGEXP = r"^(?:[^\:]+\:){4}([^\:]+)"
"""Tile id extractor for the standard Illumina read-name format."""

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
    """Per-tile :class:`PositionByteCounts` (``--stats :tiles`` mode), in
    the order the tiles first appear. The turbo runners decline per-tile
    statistics, which need every record's name; the per-record pipeline
    fills them."""

    def __init__(self, is_qualities=False, quality_base=33, device="cpu"):
        self.tiles = {}
        self.is_qualities = is_qualities
        self.quality_base = quality_base
        self.device = device

    def table_for(self, tile):
        table = self.tiles.get(tile)
        if table is None:
            table = PositionByteCounts(
                self.is_qualities, self.quality_base, self.device
            )
            self.tiles[tile] = table
        return table

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
    """Read-level and position-level statistics for one input source.
    ``device`` is where the position counts run (``None`` means
    ``cuda``); ``tiles`` (``True`` or a regular expression) adds the
    per-tile quality tables when the input has qualities."""

    def __init__(self, qualities=None, quality_base=33, tiles=None,
                 device=None):
        self.device = resolve_device(device)
        self.count = 0
        self.sequence_lengths = DenseHistogram()
        self.sequence_gc = DenseHistogram(101)
        self.bases = PositionByteCounts(device=self.device)

        self.qualities = qualities
        self.quality_base = quality_base
        self.tile_key_regexp = None
        self.sequence_qualities = None
        self.base_qualities = None
        self.tile_base_qualities = None
        self.tile_sequence_qualities = None
        if qualities:
            pattern = DEFAULT_TILE_KEY_REGEXP if tiles is True else tiles
            if isinstance(pattern, str):
                pattern = re.compile(pattern)
            self.tile_key_regexp = pattern
            self._init_qualities()

    def _init_qualities(self):
        self.sequence_qualities = Histogram()
        self.base_qualities = PositionByteCounts(
            is_qualities=True, quality_base=self.quality_base,
            device=self.device,
        )
        if self.tile_key_regexp:
            self.tile_base_qualities = TilePositionCounts(
                is_qualities=True, quality_base=self.quality_base,
                device=self.device,
            )
            self.tile_sequence_qualities = NestedDict()

    @property
    def track_tiles(self):
        return self.qualities and self.tile_key_regexp is not None

    def _tile_of_name(self, name):
        found = self.tile_key_regexp.match(name)
        if not found:
            raise ValueError(
                "{} did not match {}".format(self.tile_key_regexp, name)
            )
        return found.group(1)

    # -- collection ----------------------------------------------------------

    def collect_records(self, records):
        """Collect a batch of records, each a (name, sequence, qualities)
        triple, with the reference's per-record ``collect_record`` rules:
        the qualities switch on at the first record whose qualities are
        non-empty (when the table started without knowing), a record
        without qualities adds none, and every histogram sees the records
        in their order. Each table's position counts are one call a batch
        (one a tile for the tile tables)."""
        if self.qualities is None:
            first = next(
                (row for row, record in enumerate(records) if record[2]),
                len(records),
            )
            self._collect_record_rows(records[:first])
            if first == len(records):
                return
            self.qualities = True
            self._init_qualities()
            records = records[first:]
        self._collect_record_rows(records)

    def _collect_record_rows(self, records):
        count = len(records)
        if count == 0:
            return
        lengths = np.fromiter(
            (len(record[1]) for record in records), np.int64, count
        )
        width = int(lengths.max())
        seqs = _pad_bytes([record[1] for record in records], lengths, width)
        self._collect_bases(seqs, lengths)
        if not self.qualities:
            return
        rows = [row for row, record in enumerate(records) if record[2] is not None]
        if not rows:
            return
        quals = _pad_bytes([records[row][2] for row in rows], lengths[rows], width)
        names = [records[row][0] for row in rows] if self.track_tiles else None
        self._collect_qualities(quals, lengths[rows], names)

    def collect_batch(self, records):
        """Collect a batch of records (objects with ``name``, ``sequence``
        and ``qualities``) as the reference's qc command does: the
        qualities of the whole batch count when its first record has
        qualities, and switch the tables on then."""
        if not records:
            return
        seqs, quals, lengths = _encode_batch(records)
        names = (
            [record.name for record in records] if self.track_tiles else None
        )
        self.collect_matrices(seqs, quals, lengths, names=names)

    def collect_matrices(self, seqs, quals, lengths, names=None):
        """Vectorized collection straight from padded uint8 matrices
        (``[B, W]`` sequences/qualities + a length vector), the form the
        turbo runners hold. Bytes beyond each read's length are ignored.
        ``names`` is needed only when per-tile statistics are tracked."""
        count = lengths.shape[0]
        if count == 0:
            return
        if self.qualities is None and quals is not None:
            self.qualities = True
            self._init_qualities()
        self._collect_bases(seqs, lengths)
        if self.qualities and quals is not None:
            self._collect_qualities(quals, lengths, names)

    def _collect_bases(self, seqs, lengths):
        self.count += lengths.shape[0]
        self.sequence_lengths.add_vector(lengths)
        nonempty = lengths > 0
        if not nonempty.any():
            return
        seqs, valid = _clip_to_longest(seqs, lengths)
        gc = (((seqs == ord("C")) | (seqs == ord("G"))) & valid).sum(axis=1)
        live = lengths[nonempty]
        gc_pct = np.rint(gc[nonempty] * 100 / live).astype(np.int64)
        self.sequence_gc.add_vector(gc_pct)
        self.bases.add_batch(seqs[nonempty], live)

    def _collect_qualities(self, quals, lengths, names=None):
        nonempty = lengths > 0
        if not nonempty.any():
            return
        quals, valid = _clip_to_longest(quals, lengths)
        live = lengths[nonempty]
        quals = quals[nonempty]
        sums = (quals * valid[nonempty]).sum(axis=1, dtype=np.int64)
        mean_quality = np.rint(
            (sums - live.astype(np.int64) * self.quality_base) / live
        ).astype(np.int64)
        for value in mean_quality:
            self.sequence_qualities[int(value)] += 1
        self.base_qualities.add_batch(quals, live)
        if not self.track_tiles:
            return
        if names is None:
            raise ValueError("per-tile statistics require record names")
        kept = [name for name, keep in zip(names, nonempty) if keep]
        by_tile = {}
        for row, name in enumerate(kept):
            tile = self._tile_of_name(name)
            self.tile_sequence_qualities[tile][int(mean_quality[row])] += 1
            by_tile.setdefault(tile, []).append(row)
        for tile, rows in by_tile.items():
            tile_live = live[rows]
            self.tile_base_qualities.table_for(tile).add_batch(
                quals[rows, : int(tile_live.max())], tile_live
            )

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
        if self.track_tiles:
            summary["tile_base_qualities"] = self.tile_base_qualities
            summary["tile_sequence_qualities"] = self.tile_sequence_qualities
        return summary


def _encode_batch(records):
    """Pack record sequences and qualities into padded uint8 matrices; the
    qualities are None when the first record has none."""
    count = len(records)
    lengths = np.fromiter(
        (len(record.sequence) for record in records), np.int32, count
    )
    width = int(lengths.max()) if count else 0
    seqs = _pad_bytes([record.sequence for record in records], lengths, width)
    quals = None
    if records and records[0].qualities is not None:
        quals = _pad_bytes([record.qualities for record in records], lengths, width)
    return seqs, quals, lengths


def _pad_bytes(texts, lengths, width):
    """``[len(texts), width]`` uint8 matrix of ASCII strings, each row
    zero-padded past its length."""
    out = np.zeros((len(texts), width), np.uint8)
    for row, text in enumerate(texts):
        out[row, : lengths[row]] = np.frombuffer(text.encode("ascii"), np.uint8)
    return out


def _clip_to_longest(matrix, lengths):
    """The matrix clipped to its longest row (so that position tables never
    grow all-zero rows beyond the observed lengths) and the mask of the
    positions below each row's length."""
    width = min(int(lengths.max()), matrix.shape[1])
    matrix = matrix[:, :width]
    return matrix, np.arange(width)[None, :] < lengths[:, None]


class SingleEndReadStatistics(ReadStatistics):
    def collect_batch(self, records):
        super().collect_batch(
            [r[0] if isinstance(r, tuple) else r for r in records]
        )

    def summarize(self):
        return dict(read1=super().summarize())


class PairedEndReadStatistics:
    def __init__(self, **kwargs):
        self.read1 = ReadStatistics(**kwargs)
        self.read2 = ReadStatistics(**kwargs)

    def collect_records(self, records):
        """``records``: a pair of (name, sequence, qualities) triples a
        pair."""
        self.read1.collect_records([pair[0] for pair in records])
        self.read2.collect_records([pair[1] for pair in records])

    def collect_batch(self, records):
        """``records``: a pair of record objects a pair."""
        self.read1.collect_batch([pair[0] for pair in records])
        self.read2.collect_batch([pair[1] for pair in records])

    def summarize(self):
        return dict(read1=self.read1.summarize(), read2=self.read2.summarize())
