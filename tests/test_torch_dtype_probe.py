"""The dtype probe of the port against the TPU tool's Pallas kernel.

``tools/perf_dtype_probe.py`` runs its benchmark when imported, so its
kernel ``body_full`` is taken from the source with ``ast`` and bound to
the shape of the test (``M1`` = 34, ``B`` = N, ``L``); it runs through
``pl.pallas_call(..., interpret=True)`` on the CPU, with int16 and int32
state and both ``use_concat`` variants, and the port's plain version
``probe_columns`` must give the identical int32 output (tolerance 0), for
reads of bytes 0-3 and 0-255 made from a seed with numpy. The CUDA kernels
run only on a card (``tests/test_torch_cuda.py``); here their wrappers
are checked for what they refuse and for running the plain version on CPU
tensors.
"""
import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from atropos_tpu_torch import DeviceUnavailableError
from atropos_tpu_torch.tools import dtype_probe
from atropos_tpu_torch.tools.dtype_probe import (
    M1,
    dtype_probe_i16x2,
    dtype_probe_i32,
    probe_columns,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "perf_dtype_probe.py")
L, N = 104, 128
SEEDS = (0, 1, 2)


def _body_full_node():
    with open(TOOL) as handle:
        tree = ast.parse(handle.read())
    return next(
        node for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name == "body_full"
    )


@functools.lru_cache(maxsize=None)
def _body_full(n_reads, n_columns):
    """``body_full`` of the TPU tool, its globals bound to this shape."""
    namespace = dict(jnp=jnp, lax=lax, pl=pl, M1=M1, B=n_reads, L=n_columns)
    module = ast.Module(body=[_body_full_node()], type_ignores=[])
    exec(compile(module, TOOL, "exec"), namespace)
    return namespace["body_full"]


def reference(reads, dt, use_concat, use_dyn):
    """The TPU tool's kernel in interpret mode: [L, N] uint8 -> [8, N]."""
    n_columns, n_reads = reads.shape
    kern = functools.partial(
        _body_full(n_reads, n_columns), dt=dt, use_concat=use_concat,
        use_dyn=use_dyn,
    )
    call = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, n_reads), jnp.int32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(reads).astype(jnp.int32)))


def make_reads(seed, symbols, n_columns=L, n_reads=N):
    rng = np.random.default_rng([seed, symbols, n_columns, n_reads])
    return rng.integers(0, symbols, (n_columns, n_reads), dtype=np.uint8)


def test_body_full_is_where_the_port_says():
    assert _body_full_node().lineno == 25
    for kernel in dtype_probe.KERNELS:
        assert kernel.replaces.startswith("tools/perf_dtype_probe.py:25 ")
    with open(os.path.join(ROOT, "atropos_tpu_torch", "csrc", "dtype_probe.cu")) as src:
        text = src.read()
    assert "tools/perf_dtype_probe.py:25" in text
    for kernel in dtype_probe.KERNELS:
        assert "int " + kernel.name + "(" in text


@pytest.mark.parametrize("symbols", [4, 256], ids=["bytes0-3", "bytes0-255"])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
@pytest.mark.parametrize("use_concat", [True, False], ids=["concat", "select"])
@pytest.mark.parametrize(
    "jax_dt,torch_dt", [(jnp.int32, torch.int32), (jnp.int16, torch.int16)],
    ids=["int32", "int16"],
)
def test_plain_version_equals_body_full(jax_dt, torch_dt, use_concat, dyn, symbols):
    for seed in SEEDS:
        reads = make_reads(seed, symbols)
        expected = reference(reads, jax_dt, use_concat, dyn)
        got = probe_columns(torch.from_numpy(reads), torch_dt, dyn)
        assert got.dtype == torch.int32 and tuple(got.shape) == (8, N)
        assert np.array_equal(got.numpy(), expected), (seed, symbols)


@pytest.mark.parametrize("symbols", [4, 256], ids=["bytes0-3", "bytes0-255"])
@pytest.mark.parametrize("dyn", [True, False], ids=["dyn", "nodyn"])
def test_int16_and_int32_agree(dyn, symbols):
    """No state value leaves the int16 range, so both state types give the
    same output and the same final state, also over more columns than the
    TPU tool's."""
    for seed in SEEDS:
        reads = torch.from_numpy(make_reads(seed, symbols, n_columns=300, n_reads=64))
        out16, state16 = probe_columns(reads, torch.int16, dyn, state=True)
        out32, state32 = probe_columns(reads, torch.int32, dyn, state=True)
        assert torch.equal(out16, out32) and torch.equal(state16, state32)
        assert tuple(state32.shape) == (2, M1, 64)
        assert torch.equal(out32, state32[0, :8] + state32[1, :8])
        assert int(state32.min()) >= 0 and int(state32.max()) < 32768


@pytest.mark.parametrize("kernel", dtype_probe.KERNELS, ids=lambda k: k.name)
def test_wrapper_runs_the_plain_version_on_cpu_tensors(kernel):
    dtype_probe.reset_launch_counts()
    reads = torch.from_numpy(make_reads(7, 4))
    for dyn in (True, False):
        expected = probe_columns(reads, kernel.plain_dtype, dyn)
        assert torch.equal(kernel(reads, dyn), expected)
        assert torch.equal(kernel.plain(reads, dyn), expected)
        out, state = kernel(reads, dyn, state=True)
        assert torch.equal(out, expected)
        assert torch.equal(state, probe_columns(reads, torch.int32, dyn, state=True)[1])
    assert dtype_probe.launch_counts() == {
        "dtype_probe_i32": 0, "dtype_probe_i16x2": 0,
    }


@pytest.mark.parametrize("kernel", dtype_probe.KERNELS, ids=lambda k: k.name)
def test_wrapper_refuses_what_the_kernel_does_not_take(kernel):
    reads = torch.from_numpy(make_reads(3, 4))
    with pytest.raises(TypeError):
        kernel(reads.to(torch.int32), True)
    with pytest.raises(TypeError):
        kernel(reads[0], True)
    with pytest.raises(ValueError):
        kernel(reads.T, True)  # not contiguous
    with pytest.raises(ValueError):
        kernel(reads[: M1 - 2].contiguous(), True)  # fewer columns than m
    with pytest.raises(ValueError):
        kernel(reads[:, :0].contiguous(), True)
    odd = reads[:, :5].contiguous()
    if kernel is dtype_probe_i16x2:
        with pytest.raises(ValueError):
            kernel(odd, True)
    else:
        assert tuple(kernel(odd, True).shape) == (8, 5)


def test_tool_runs_on_cpu_at_a_tiny_shape(capsys):
    results = dtype_probe.main(["--device", "cpu", "--shape", "40,16", "--shape", "33,8"])
    names = [r["name"] for r in results]
    assert names == [
        "int32 full", "int16 full", "int16 no-dynslice", "int32 no-dynslice",
    ] * 2
    assert {(r["L"], r["N"]) for r in results} == {(40, 16), (33, 8)}
    assert all(r["device"] == "cpu (plain version)" for r in results)
    assert all(r["ms"] > 0 and r["cell_updates_per_second"] > 0 for r in results)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 8 and all("cpu (plain version)" in line for line in printed)
    assert [r["kernel"] for r in results[:4]] == [
        dtype_probe_i32.name, dtype_probe_i16x2.name,
        dtype_probe_i16x2.name, dtype_probe_i32.name,
    ]


def test_tool_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(DeviceUnavailableError):
        dtype_probe.main([])
    with pytest.raises(DeviceUnavailableError):
        dtype_probe.main(["--device", "cuda"])
