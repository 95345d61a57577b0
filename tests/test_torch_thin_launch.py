"""K3's wrapper and the thin launch path of K3 and K5, on the CPU.

* ``reduce_sum`` returns a 0-d tensor in x's dtype (``[1]`` with
  ``keepdim``, as the ``reduction`` case's build takes it), and still
  raises on a CPU/CUDA mismatch;
* ``reduce_sum.workspace`` hands out one ticket counter per (device,
  stream) key, zeroed when allocated, grown but never shared;
* ``launch.names_cuda`` reads a device argument as ``resolve_device`` does,
  and each C entry's packed struct has the size its ``static_assert``
  states.

The kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against their plain versions there, on two streams at once
and at an address off 16 bytes.
"""
import pytest
import torch

from repro_torch.core import get_case
from repro_torch.device import resolve_device
from repro_torch.kernels import moe_gemm
from repro_torch.kernels import reduce_sum as k3
from repro_torch.kernels.launch import names_cuda
from repro_torch.kernels.reduce_sum import (reduce_sum, reduce_sum_plain,
                                            workspace)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_sum_returns_a_0d_tensor_in_xs_dtype(dtype):
    x = torch.arange(12, dtype=torch.float32).to(dtype)
    before = reduce_sum.launches
    got = reduce_sum(x, block=4, device="cpu")
    assert got.shape == () and got.dtype == dtype and float(got) == 66.0
    kept = reduce_sum(x, block=4, keepdim=True, device="cpu")
    assert kept.shape == (1,) and kept.dtype == dtype
    assert torch.equal(kept[0], got)
    assert reduce_sum.launches == before          # CPU tensors launch nothing


def test_the_reduction_case_build_takes_the_1_element_form():
    """The ``cuda`` build returns the case's ``[1]`` output directly."""
    case = get_case("reduction")
    x = torch.randn(8192)
    got = case.build({"block": 1024}, impl="cuda")(x)
    assert got.shape == (1,) and got.dtype == torch.float32
    torch.testing.assert_close(got, case.ref(x))
    assert torch.equal(got[0], reduce_sum_plain(x, block=1024))


def test_reduce_sum_raises_on_a_device_mismatch(monkeypatch):
    x = torch.zeros(16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reduce_sum(x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lies on cpu"):
        reduce_sum(x, device="cuda")
    with pytest.raises(ValueError, match="lies on cpu"):
        reduce_sum(x, device=torch.device("cuda", 0), keepdim=True)
    with pytest.raises(ValueError, match="unsupported device"):
        reduce_sum(x, device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        moe_gemm.grouped_matmul(torch.zeros(2, 8, 16), torch.zeros(2, 16, 8),
                                device="cuda:0")


def test_the_wrappers_still_check_their_input_on_the_cpu():
    with pytest.raises(ValueError, match="1-D"):
        reduce_sum(torch.zeros(2, 3), device="cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduce_sum(torch.zeros(4, dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match=r"x \[E,M,K\]"):
        moe_gemm.grouped_matmul(torch.zeros(8, 16), torch.zeros(2, 16, 8),
                                device="cpu")
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        moe_gemm.grouped_matmul(torch.zeros(2, 8, 16),
                                torch.zeros(2, 16, 8, dtype=torch.bfloat16),
                                device="cpu")


def test_the_workspace_hands_out_one_ticket_per_stream(monkeypatch):
    monkeypatch.setattr(k3, "_workspaces", {})
    a = workspace((0, 11), 10, "cpu")
    b = workspace((0, 12), 10, "cpu")
    c = workspace((1, 11), 10, "cpu")
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert workspace((0, 11), 200, "cpu") is a    # room for 255 partials
    for ws in (a, b, c):
        assert ws.dtype == torch.int32 and ws.numel() >= 11
        assert int(ws[0]) == 0                     # the ticket starts at 0


def test_the_workspace_grows_and_starts_its_new_ticket_at_0(monkeypatch):
    monkeypatch.setattr(k3, "_workspaces", {})
    first = workspace((0, 5), 4, "cpu")
    first[0] = 7                                   # a ticket left mid-flight
    grown = workspace((0, 5), 1000, "cpu")
    assert grown is not first and grown.numel() >= 1001
    assert int(grown[0]) == 0
    assert workspace((0, 5), 1000, "cpu") is grown
    assert workspace((0, 5), 3, "cpu") is grown    # never shrunk
    doubled = workspace((0, 5), grown.numel(), "cpu")
    assert doubled.numel() - 1 >= 2 * (grown.numel() - 1)


@pytest.mark.parametrize("device,cuda", [
    ("cuda", True), ("cuda:1", True), (torch.device("cuda", 0), True),
    ("cpu", False), (torch.device("cpu"), False), ("meta", False)])
def test_names_cuda_reads_a_device_as_resolve_device_does(device, cuda):
    assert names_cuda(device) is cuda
    if not cuda and str(device) != "meta":
        assert resolve_device(device).type == "cpu"


def test_the_packed_arguments_match_the_c_structs():
    """``static_assert(sizeof(Args) == ...)`` in csrc/reduce_sum.cu (eight
    8-byte fields) and csrc/moe_gemm.cu (twenty)."""
    assert len(k3._ENTRY.pack(*[0] * 8)) == 8 * 8
    assert len(moe_gemm._ENTRY.pack(*[0] * 20)) == 20 * 8
    # pointers and the stream are unsigned; strides may be negative
    moe_gemm._ENTRY.pack(*[2 ** 64 - 1] * 4, *[-1] * 16)
    with pytest.raises(Exception):
        k3._ENTRY.pack(-1, *[0] * 7)
