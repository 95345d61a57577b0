"""K4's cached launch on the CPU: the launch key and the launcher's
arguments.

A CUDA call of ``elementwise`` compiles the Triton kernel once per launch
key (``launch_key``) and later launches the cached compiled kernel through
its own launcher (``launch_args``).  The key must hold everything Triton
specializes the kernel on, so that a kernel compiled for 16-byte aligned
pointers is never reused on a view one element off: here the key, built
from CPU tensors, is equal for equal inputs and differs for a view off 16
bytes, another dtype, another map and a block not a multiple of 16.  The
kernel itself runs only on a card (``tests/test_torch_cuda.py``: 100 calls
compile once, a view one element off compiles a second kernel and stays
bitwise equal to the plain version).
"""
import inspect

import pytest
import torch

from repro_torch.kernels import elementwise as k4
from repro_torch.kernels.elementwise import (_map_kernel, elementwise,
                                             launch_args, launch_key)
from repro_torch.kernels.suites.appsdk import _add


def _mul(x, y):
    return x * y


def tensors_of(a, b, o=None):
    """(o, a, b, a): the output, then the three input slots, the unused
    one filled with the first array, as the wrapper fills it."""
    return (torch.empty_like(a) if o is None else o, a, b, a)


def key(fn=_add, tensors=None, blk=8192):
    if tensors is None:
        tensors = tensors_of(torch.zeros(16384), torch.zeros(16384))
    BLOCK = 1 << (blk - 1).bit_length()
    return launch_key(fn, 2, tensors, blk, BLOCK, 4 if BLOCK <= 2048 else 8)


def test_the_key_is_equal_for_equal_inputs():
    a, b = torch.zeros(16384), torch.ones(16384)
    o = torch.empty(16384)
    assert key(tensors=tensors_of(a, b, o)) == key(tensors=tensors_of(a, b,
                                                                      o))
    # other arrays of the same dtypes, all 16-byte aligned: the same kernel
    assert key(tensors=tensors_of(a, b)) == key(
        tensors=tensors_of(torch.randn(16384), torch.randn(16384)))


def test_a_view_one_element_off_has_another_key():
    buf = torch.zeros(16385)
    a, b = buf[:16384], torch.zeros(16384)
    off = buf[1:]
    assert a.data_ptr() % 16 == 0 and off.data_ptr() % 16 != 0
    assert key(tensors=tensors_of(a, b)) != key(tensors=tensors_of(off, b))
    assert key(tensors=tensors_of(a, b)) != key(tensors=tensors_of(a, off))


@pytest.mark.parametrize("change", ["dtype", "fn", "blk", "blk_1"])
def test_the_key_differs_for_what_triton_specializes(change):
    a, b = torch.zeros(16384), torch.zeros(16384)
    base = key(tensors=tensors_of(a, b))
    if change == "dtype":
        other = key(tensors=tensors_of(a.bfloat16(), b.bfloat16()))
    elif change == "fn":
        other = key(fn=_mul, tensors=tensors_of(a, b))
    elif change == "blk":            # 8184 = 8 * 1023: not a multiple of 16
        other = key(tensors=tensors_of(a, b), blk=8184)
        assert other[1:4] == base[1:4]   # same N_IN, BLOCK and warps
    else:
        other = key(tensors=tensors_of(a, b), blk=1)
    assert other != base


def test_the_launcher_takes_the_kernels_arguments_in_order():
    """After the nine launch fields (grid, stream, function, metadata,
    hooks) come ``_map_kernel``'s parameters in order, pointers as
    integers and the constexprs as they are."""
    a, b = torch.zeros(64), torch.ones(64)
    tensors = tensors_of(a, b)
    entry = ("run", "function", "packed", "fn_jit", "compiled")
    args = launch_args(entry, 4, 77, tensors, 16, 2, 16)
    assert args[:9] == (4, 1, 1, 77, "function", "packed", None, None, None)
    params = list(inspect.signature(_map_kernel).parameters)
    assert params == ["o_ptr", "a_ptr", "b_ptr", "c_ptr", "blk", "FN",
                      "N_IN", "BLOCK"]
    assert args[9:] == (*[t.data_ptr() for t in tensors], 16, "fn_jit", 2,
                        16)


@pytest.mark.parametrize("block,n", [(8192, 16777216), (8192, 6000),
                                     (16, 64), (7, 1000)])
def test_the_grid_is_the_fitted_block_in_a_power_of_two(block, n):
    blk, BLOCK, num_warps = k4._grid(block, n)
    assert blk == k4.fit(block, n) and n % blk == 0
    assert BLOCK >= blk > BLOCK // 2 and BLOCK & (BLOCK - 1) == 0
    assert num_warps == (4 if BLOCK <= 2048 else 8)


def test_cpu_calls_compile_nothing_and_launch_nothing():
    a, b = torch.randn(100), torch.randn(100)
    before = (elementwise.launches, elementwise.compiles,
              elementwise.cache_hits, len(k4._launches))
    got = elementwise(_add, a, b, block=16, device="cpu")
    assert torch.equal(got, a + b)
    assert (elementwise.launches, elementwise.compiles,
            elementwise.cache_hits, len(k4._launches)) == before


def test_the_wrapper_still_refuses_on_the_cpu(monkeypatch):
    with pytest.raises(ValueError, match="1-D"):
        elementwise(_add, torch.zeros(2, 3), torch.zeros(2, 3), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lies on cpu"):
        elementwise(_add, torch.zeros(4), device="cuda")


@pytest.mark.parametrize("version,ok", [
    ("3.6.0", True), ("3.6.1", True), ("3.6.0+git1a2b3c", True),
    ("3.5.1", False), ("3.7.0", False), ("4.0.0", False), ("3", False),
])
def test_the_launch_refuses_a_triton_of_another_launcher(version, ok):
    """The cached launch passes Triton 3.6's launcher arguments in their
    order; another release raises with both versions named."""
    if ok:
        k4.check_triton(version)
    else:
        with pytest.raises(RuntimeError, match=f"installed Triton is "
                                               f"{version}"):
            k4.check_triton(version)
