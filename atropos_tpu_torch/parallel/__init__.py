"""Multi-process scale-out of the port.

Counterpart of ``atropos_tpu/parallel``'s multi-host mode: one process a
card or host, joined by ``torch.distributed``
(:mod:`atropos_tpu_torch.parallel.distributed`). Each rank runs the whole
command on its own device over the chunks or batches it owns, writes its
own output shard, and the ranks' summaries merge into one report. The
in-process split of one device batch over a host's several cards is
ROADMAP.md queue 1 item 7a.
"""
