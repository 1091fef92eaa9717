"""Multi-process ranks over ``torch.distributed``.

Counterpart of ``atropos_tpu/parallel/distributed.py``, whose ranks are
``jax.distributed`` processes. The mapping of the reference's fork+Queue
parallelism (``atropos/commands/multicore.py``) is the same:

- the reader/feeder process  -> per-rank input sharding: every rank
  streams the same input and owns the k-th chunk or batch, counting from
  0, when k modulo the world size is its rank (no coordination; no
  record is trimmed twice). The rule lives where the chunks and batches
  are cut: ``BaseCommandRunner._assemble`` and the turbo runners;
- worker processes           -> ranks (each trims its shard with the same
  turbo runner or pipeline, its kernels on the rank's own device);
- parallel-write mode        -> per-rank output shard files
  (``output.<rank>``);
- pickled-summary Queue      -> an all-gather of the summaries over the
  process group, merged with the same ``merge_dicts`` algebra.

Activation: every rank calls :func:`initialize` with the same
coordinator address and world size and its own rank, then runs the
command with its device given explicitly (``main(argv,
device=torch.device("cuda", local_rank))``, or ``device="cpu"``). The
trim command sees a world larger than one and shards. The summaries are
host objects, so the group's backend is Gloo, also when ranks share one
card (NCCL refuses two ranks on one device).
"""
import logging


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator, num_processes, process_id):
    """Join the process group: ``coordinator`` is "host:port" of rank 0,
    ``num_processes`` the world size, ``process_id`` this process's rank.
    Calling it again in an initialized process does nothing."""
    dist = _dist()
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo",
        init_method="tcp://" + coordinator,
        world_size=num_processes,
        rank=process_id,
    )


def process_info():
    """(rank, world size) of the process group; (0, 1) when none is
    initialized."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def allgather_object(obj):
    """Every rank's picklable ``obj``, ordered by rank."""
    rank, world = process_info()
    if world == 1:
        return [obj]
    gathered = [None] * world
    _dist().all_gather_object(gathered, obj)
    return gathered


#: summary fields each rank keeps for itself: its own times, and its own
#: device (ranks on several cards name different ones)
LOCAL_SUMMARY_KEYS = ("timing", "device")


def merge_summaries(local_summary):
    """All-gather every rank's summary dict and merge them with the typed
    merge algebra of the worker summaries (``merge_dicts``), as the
    reference does. The fields of ``LOCAL_SUMMARY_KEYS`` are left out of
    the exchange; the caller keeps its own."""
    from atropos_tpu_torch.util import merge_dicts

    payload = {
        key: value
        for key, value in local_summary.items()
        if key not in LOCAL_SUMMARY_KEYS
    }
    summaries = allgather_object(payload)
    merged = summaries[0]
    for other in summaries[1:]:
        merge_dicts(merged, other)
    return merged


def barrier(name="atropos"):
    """Synchronization point of every rank (e.g. before rank 0 writes the
    merged report); ``name`` says which in the log."""
    rank, world = process_info()
    if world > 1:
        logging.getLogger().debug("Rank %d at barrier %s", rank, name)
        _dist().barrier()


def log_topology(device=None):
    """Log this rank, the world size and the rank's device."""
    rank, world = process_info()
    logging.getLogger().info(
        "Distributed trim: process %d/%d on %s", rank, world, device
    )
