"""Times of work launched on a CUDA stream, as ``chip_smoke.py``,
``dp_compare.py`` and ``diag_compare.py`` take them, and the helpers those
tools share: the card's ``nvidia-smi`` fields and a tool's child process.
It imports only ``torch`` and ``numpy``, so a process may load it beside
any tree's ``atropos_tpu_torch``."""
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: the least time the stream sleeps before the queued launches
MIN_SLEEP_MS = 20.0


def smi(query):
    """``nvidia-smi --query-gpu=QUERY --format=csv,noheader`` of card 0."""
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    )
    return done.stdout.strip().splitlines()[0]


def run_child(module, argv, cwd):
    """Run ``python -m MODULE ARGV`` in ``cwd`` and return the JSON object
    of its last output line; raises with its output if it fails."""
    done = subprocess.run([sys.executable, "-m", module] + argv,
                          cwd=cwd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError("{} failed:\n{}\n{}".format(argv, done.stdout, done.stderr))
    return json.loads(done.stdout.strip().splitlines()[-1])


def device_times(fn, launches, clock_mhz, queued=True):
    """Times of ``fn()``, which launches work on the current CUDA stream and
    returns its output, after 3 warm-ups; and the last output. Only the last
    output is kept alive, so that PyTorch's caching allocator hands each call
    the memory of the one before. ``clock_mhz`` is the card's SM clock, which
    sets how long the stream sleeps.

    - ``ms``: the median of ``launches`` calls, each between two events on an
      idle stream. It holds the host's work of the call before its launch
      and the launch itself: the reading of every kernel time of the port.
    - ``queued_ms``: the work alone. The stream first sleeps on the device
      while the host queues ``launches`` calls between two events, so the
      card runs them back to back; their time over ``launches``.
    - ``host_ms``: the median host time of one call, from the timed calls.
    - ``queue_host_ms`` and ``sleep_ms``: the host's time to queue the
      calls, and the sleep, four times the timed calls' longest host time
      (at least ``MIN_SLEEP_MS``). Raises if the host took longer than the
      sleep, since ``queued_ms`` would then hold the host's gaps.

    With ``queued`` False (for a call whose host waits for the card, which
    the sleep would hold up) only ``ms`` and ``host_ms`` are taken.
    """
    torch.cuda._sleep(1)  # loads the sleep kernel before it is timed
    for _ in range(3):
        out = fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(launches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        began = time.perf_counter()
        out = fn()
        host.append((time.perf_counter() - began) * 1e3)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    result = dict(ms=float(np.median(times)), host_ms=float(np.median(host)))
    if not queued:
        return result, out
    sleep_ms = max(MIN_SLEEP_MS, 4 * launches * max(host))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * 1e3 * clock_mhz))
    began = time.perf_counter()
    start.record()
    for _ in range(launches):
        out = fn()
    stop.record()
    queue_host_ms = (time.perf_counter() - began) * 1e3
    torch.cuda.synchronize()
    if queue_host_ms >= sleep_ms:
        raise AssertionError(
            "queuing {} calls took {:.3f} ms, the sleep {:.3f} ms".format(
                launches, queue_host_ms, sleep_ms))
    result.update(queued_ms=start.elapsed_time(stop) / launches,
                  queue_host_ms=queue_host_ms, sleep_ms=sleep_ms)
    return result, out
