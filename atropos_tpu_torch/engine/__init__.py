"""Device engine pieces the turbo runner is built from.

Counterpart of ``atropos_tpu/engine/__init__.py``: the per-adapter aligner
dispatch (:func:`make_batch_aligner`), the vectorized host matcher for
anchored no-indel adapters (:class:`_PrefixSuffixMatcher`) and the shape
bucketing helpers. The batched ``TrimEngine`` of that module, which serves
the configurations the turbo runner declines, has no counterpart here yet
(:class:`~atropos_tpu_torch.NotPortedError`).
"""
import numpy as np
import torch

from atropos_tpu_torch.adapters import PREFIX
from atropos_tpu_torch.align.batched import BatchAligner
from atropos_tpu_torch.align.cuda_kernel import CudaAligner
from atropos_tpu_torch.align.flags import (
    ACGT_TABLE,
    IUPAC_TABLE,
    translate_pair,
)


def engine_enabled():
    """Whether the device engine is used: always. The turbo runner is the
    only execution mode of this package; there is no scalar pipeline to
    switch to."""
    return True


def make_batch_aligner(adapter, device):
    """Device aligner for one adapter: :class:`CudaAligner` (the
    hand-written kernels) for a CUDA device, :class:`BatchAligner` (the
    plain PyTorch DP) for ``cpu``. The device alone decides; both are
    bit-exact against the scalar oracle."""
    cls = CudaAligner if torch.device(device).type == "cuda" else BatchAligner
    return cls(
        adapter.sequence,
        adapter.max_error_rate,
        adapter.where,
        wildcard_ref=adapter.adapter_wildcards,
        wildcard_query=adapter.read_wildcards,
        min_overlap=adapter.min_overlap,
        indel_cost=(adapter.aligner.indel_cost if adapter.indels else 100000),
        device=device,
    )


def _bucket_batch(batch):
    size = 64
    while size < batch:
        size *= 2
    return size


def _bucket_len(length):
    return max(32, ((length + 31) // 32) * 32)


class _PrefixSuffixMatcher:
    """Vectorized no-indel anchored matcher (compare_prefixes/suffixes).

    numpy is sufficient here: the comparison is O(B*m) byte ops.
    Reference semantics: ``_align.pyx:501-544`` +
    ``align/__init__.py:28-44``.
    """

    def __init__(self, adapter):
        self.adapter = adapter
        self.m = len(adapter.sequence)
        ref_b, _, self.compare_ascii = translate_pair(
            adapter.sequence,
            "",
            adapter.adapter_wildcards,
            adapter.read_wildcards,
        )
        self.ref_arr = np.frombuffer(ref_b, dtype=np.uint8)
        self.raw_ref = np.frombuffer(
            adapter.sequence.encode("ascii"), dtype=np.uint8
        )
        if adapter.adapter_wildcards:
            self.query_lut = np.frombuffer(
                IUPAC_TABLE if adapter.read_wildcards else ACGT_TABLE,
                dtype=np.uint8,
            )
        elif adapter.read_wildcards:
            self.query_lut = np.frombuffer(IUPAC_TABLE, dtype=np.uint8)
        else:
            self.query_lut = None

    def locate_batch(self, reads_u8, lengths):
        batch, width = reads_u8.shape
        m = self.m
        lengths = np.asarray(lengths)
        out = {
            "found": np.zeros(batch, bool),
            "start1": np.zeros(batch, np.int32),
            "stop1": np.zeros(batch, np.int32),
            "start2": np.zeros(batch, np.int32),
            "stop2": np.zeros(batch, np.int32),
            "matches": np.zeros(batch, np.int32),
            "cost": np.zeros(batch, np.int32),
        }
        is_prefix = self.adapter.where == PREFIX
        cmp_len = np.minimum(lengths, m)
        idx = np.arange(width)
        if is_prefix:
            window = reads_u8
            pos_valid = idx[None, :] < cmp_len[:, None]
        else:
            # align the last min(n, m) bases to the adapter's tail
            offs = lengths[:, None] - cmp_len[:, None]
            gather_idx = np.clip(offs + idx[None, :], 0, width - 1)
            window = np.take_along_axis(reads_u8, gather_idx, axis=1)
            pos_valid = idx[None, :] < cmp_len[:, None]

        ref = np.zeros(width, dtype=np.uint8)
        raw_ref_pad = np.zeros(width, dtype=np.uint8)
        take = min(m, width)
        if is_prefix:
            ref[:take] = self.ref_arr[:take]
            raw_ref_pad[:take] = self.raw_ref[:take]
        else:
            # suffix compare aligns adapter tail to read tail; per read the
            # compared adapter region is the LAST cmp_len bases
            pass

        if is_prefix:
            if self.compare_ascii:
                eq = window == raw_ref_pad[None, :]
            else:
                q = self.query_lut[window] if self.query_lut is not None else window
                eq = (q & ref[None, :]) != 0
            matches = np.sum(eq & pos_valid, axis=1).astype(np.int32)
            length = cmp_len.astype(np.int32)
            out["found"] = length >= 0  # compare_prefixes always returns
            out["stop1"] = length
            out["stop2"] = length
            out["matches"] = matches
            out["cost"] = length - matches
        else:
            # per-read adapter window: last cmp_len bases of the adapter
            a_offs = (m - cmp_len)[:, None]
            a_idx = np.clip(a_offs + idx[None, :], 0, m - 1)
            ref_rows = self.ref_arr[a_idx]
            raw_rows = self.raw_ref[a_idx]
            if self.compare_ascii:
                eq = window == raw_rows
            else:
                q = self.query_lut[window] if self.query_lut is not None else window
                eq = (q & ref_rows) != 0
            matches = np.sum(eq & pos_valid, axis=1).astype(np.int32)
            length = cmp_len.astype(np.int32)
            out["found"] = length >= 0
            out["start1"] = m - length
            out["stop1"] = np.full(batch, m, np.int32)
            out["start2"] = lengths.astype(np.int32) - length
            out["stop2"] = lengths.astype(np.int32)
            out["matches"] = matches
            out["cost"] = length - matches
        return out
