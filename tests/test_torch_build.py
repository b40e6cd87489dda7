"""The port's kernel build and the kernels' input conditions, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); what
decides whether a library is rebuilt, and which tensor layouts the kernels
take, is plain Python and is held here.
"""

import importlib

import pytest
import torch

from edl_tpu_torch.ops import _build

# the module (the package's attribute of that name is the function)
fa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

#: a 16-byte aligned start standing in for an allocation's
BASE = 1 << 20


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernels.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_is_stable_for_unchanged_sources(csrc):
    assert _build.library_path() == _build.library_path()
    assert _build._sources() == [csrc / "kernels.cu"]


@pytest.mark.parametrize("name", ["kernels.cu", "helpers.cuh"])
def test_library_path_changes_when_any_source_changes(csrc, name):
    before = _build.library_path()
    (csrc / name).write_text((csrc / name).read_text() + "// edited\n")
    assert _build.library_path() != before


def test_library_path_changes_when_a_header_is_added(csrc):
    before = _build.library_path()
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before


def _problem(x: torch.Tensor, base: torch.Tensor, start: int = BASE):
    """`_view_problem` for view ``x`` of ``base``, with ``base`` at ``start``."""
    ptr = start + (x.data_ptr() - base.data_ptr())
    return fa._view_problem(x.shape, x.stride(), x.element_size(), ptr)


@pytest.mark.parametrize("D", [8, 16, 32, 64])
@pytest.mark.parametrize("H", [1, 2, 12])
def test_fused_qkv_views_are_accepted(D, H):
    qkv = torch.zeros((2, 24, 3, H, D), dtype=torch.bfloat16)
    for i in range(3):
        assert _problem(qkv[:, :, i], qkv) is None


@pytest.mark.parametrize("D", [8, 64])
def test_contiguous_views_are_accepted(D):
    x = torch.zeros((2, 24, 4, D), dtype=torch.bfloat16)
    assert _problem(x, x) is None


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_start_aligned_to_4_but_not_16_bytes_is_rejected(offset):
    x = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    assert "16-byte aligned start" in _problem(x, x, BASE + offset)


def test_stride_not_a_multiple_of_16_bytes_is_rejected():
    x = torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16)[..., :64]
    assert x.stride(2) * x.element_size() == 136
    assert "multiples of 16" in _problem(x, x)


@pytest.mark.parametrize("D", [4, 12, 60, 72, 128])
def test_head_dims_off_the_compiled_set_are_rejected(D):
    x = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16)
    assert "head_dim" in _problem(x, x)


def test_non_unit_stride_along_the_head_dim_is_rejected():
    x = torch.zeros((1, 16, 2, 128), dtype=torch.bfloat16)[..., ::2]
    assert "unit stride" in _problem(x, x)


@pytest.fixture
def launches(monkeypatch):
    """The backward wrappers with the card's parts stubbed: the input check
    (which needs CUDA tensors) and the two launches record their calls."""
    calls = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k, v: calls.append("check"))
    monkeypatch.setattr(fa, "_launch_bwd_dq",
                        lambda *args, **opts: calls.append("dq") or "dq")
    monkeypatch.setattr(fa, "_launch_bwd_dkv",
                        lambda *args, **opts: calls.append("dkv") or ("dk", "dv"))
    return calls


OPTS = dict(scale=1.0, causal=True, q_offset=0, k_offset=0)


def _bwd_inputs(do_dtype=torch.bfloat16):
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    stats = torch.zeros((1, 2, 8))
    return x, x, x, x.to(do_dtype), stats, stats


def test_backward_checks_its_inputs_once(launches):
    assert fa._bwd_kernel(*_bwd_inputs(), **OPTS) == ("dq", "dk", "dv")
    assert launches == ["check", "dq", "dkv"]


def test_each_backward_wrapper_checks_its_inputs(launches):
    assert fa._bwd_dq_kernel(*_bwd_inputs(), **OPTS) == "dq"
    assert fa._bwd_dkv_kernel(*_bwd_inputs(), **OPTS) == ("dk", "dv")
    assert launches == ["check", "dq", "check", "dkv"]


@pytest.mark.parametrize("wrapper", ["_bwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel"])
def test_backward_rejects_a_do_that_is_not_bf16(launches, wrapper):
    with pytest.raises(NotImplementedError, match="bf16 dO"):
        getattr(fa, wrapper)(*_bwd_inputs(torch.float32), **OPTS)
    assert launches == ["check"]
