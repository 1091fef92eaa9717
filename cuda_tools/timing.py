"""Times of work launched on a CUDA stream, as ``chip_smoke.py``,
``dp_compare.py``, ``diag_compare.py`` and ``probe_compare.py`` take them,
and the helpers those tools share: the card's ``nvidia-smi`` fields, a
tool's child process and copies of this checkout's package with a source
changed, and the session in which a compare tool times trees in turns. It
imports only ``torch`` and ``numpy``, so a process may load it beside any
tree's ``atropos_tpu_torch``."""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: the least time the stream sleeps before the queued launches
MIN_SLEEP_MS = 20.0
#: the root of this checkout
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def source_variant(work, label, source, substitute):
    """A copy of this checkout's ``atropos_tpu_torch`` under ``work/label``
    whose ``source`` (a path from the root, e.g.
    ``atropos_tpu_torch/csrc/diag_counts.cu``) went through
    ``substitute``; returns the copy's root. Raises if nothing changed."""
    root = os.path.join(work, label)
    shutil.copytree(os.path.join(ROOT, "atropos_tpu_torch"),
                    os.path.join(root, "atropos_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(root, source)
    with open(path) as handle:
        text = handle.read()
    changed = substitute(text)
    if changed == text:
        raise RuntimeError("{}: nothing to change in {}".format(label, source))
    with open(path, "w") as handle:
        handle.write(changed)
    return root


def constant_variant(work, source, setting):
    """A copy (:func:`source_variant`) whose ``source`` sets ``constexpr
    int``s otherwise, as ``NAME=VALUE`` joined by ``+`` (e.g.
    ``PAIR_LANES=8`` or ``QWORDS=5+MIN_BLOCKS=3``); raises on a name the
    source does not define."""
    def substitute(text):
        for item in setting.split("+"):
            name, value = item.split("=")
            text, found = re.subn(r"constexpr int {} = \d+;".format(name),
                                  "constexpr int {} = {};".format(name, int(value)),
                                  text, count=1)
            if not found:
                raise RuntimeError("{} defines no constexpr int {}".format(source, name))
        return text
    return source_variant(work, setting, source, substitute)


def compare_session(module, parent, make_argv, time_argv, variants=None):
    """The session of a compare tool ``module`` (``cuda_tools.probe_compare``
    and its siblings), in a temporary directory ``work``:

    1. ``python -m MODULE make_argv(work)`` writes the inputs; the JSON
       object it prints is returned as ``made``;
    2. ``variants(work)``, if given, makes copies of this checkout
       (:func:`constant_variant`) as ``{label: root}``;
    3. each tree is timed by ``python -m MODULE time_argv(work, label,
       root)`` in turns: ``parent``, ``this``, the copies, the copies again
       in the other order, ``this``, ``parent``.

    Returns ``(made, order, runs)``, ``runs`` the ``(label, result)`` of
    each turn in ``order``."""
    with tempfile.TemporaryDirectory() as work:
        made = run_child(module, make_argv(work), ROOT)
        roots = {"parent": os.path.abspath(parent), "this": ROOT}
        if variants is not None:
            roots.update(variants(work))
        others = list(roots)[2:]
        order = ["parent", "this"] + others + others[::-1] + ["this", "parent"]
        runs = [(label, run_child(module, time_argv(work, label, roots[label]), ROOT))
                for label in order]
    return made, order, runs


def turn_times(name, runs, keys):
    """The times ``keys`` of run ``name`` in each turn of ``runs``
    (:func:`compare_session`): ``LABEL_KEY``, the list of a tree's times in
    its turns, and for every tree but the parent the ratio of its mean to
    the parent's mean, ``ratio_KEY`` for ``this`` and ``ratio_LABEL_KEY``
    for a copy."""
    labels = list(dict.fromkeys(label for label, _ in runs))
    entry = {}
    for label in labels:
        for key in keys:
            entry["{}_{}".format(label, key)] = [
                result[name][key] for run_label, result in runs if run_label == label
            ]
    for label in labels:
        if label == "parent":
            continue
        prefix = "ratio_" if label == "this" else "ratio_{}_".format(label)
        for key in keys:
            entry[prefix + key] = float(np.mean(entry["{}_{}".format(label, key)])
                                        / np.mean(entry["parent_" + key]))
    return entry


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
