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


@pytest.mark.parametrize("D", [8, 16, 32, 64, 136, 192, 200, 256])
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


@pytest.mark.parametrize("D", [4, 12, 60])
def test_head_dims_off_the_compiled_set_are_rejected(D):
    """Not a multiple of 8 (the wrapper pads those)."""
    x = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16)
    assert "head_dim" in _problem(x, x)


@pytest.mark.parametrize("D", [264, 512])
def test_head_dims_past_256_are_accepted(D):
    """Past 256 the sliced kernels read any multiple of 8, contiguous or as
    the fused projection's slices."""
    x = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16)
    assert _problem(x, x) is None
    qkv = torch.zeros((1, 16, 3, 2, D), dtype=torch.bfloat16)
    assert _problem(qkv[:, :, 1], qkv) is None


@pytest.mark.parametrize("D,padded", [(8, 16), (40, 64), (128, 128), (129, 192), (136, 192),
                                      (192, 192), (193, 256), (200, 256), (256, 256),
                                      (264, 320), (512, 512), (520, 576), (1024, 1024)])
def test_padded_head_dim(D, padded):
    """The compiled head dim that serves D, as ``csrc/flash_attention.cu``
    picks it."""
    assert fa.padded_head_dim(D) == padded


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_head_dim_256_compiles_one_64_by_64_tile(dtype):
    """The forward has one tile, 64 query rows by 64 keys a stage, in f32 at
    every head dim: the table's (128, 64) resolves to it, and a pin of
    anything else raises. In 16 bits no head dim compiles it: past 256 the
    sliced forward's block holds 128 query rows too (two consumer
    warpgroups of 64), so a pin of 64 x 64 raises there."""
    if dtype != torch.float32:
        for D in (264, 512, 1024):
            assert (64, 64) not in fa.compiled_blocks(D, dtype)
            with pytest.raises(NotImplementedError, match=r"compiled for \[\(128, 64\)\]"):
                fa.resolve_blocks(2048, D, dtype, block_q=64, block_k=64)
        return
    for D in (136, 256, 512):
        assert fa.compiled_blocks(D, dtype) == ((64, 64),)
        assert fa.resolve_blocks(2048, D, dtype) == (64, 64)
        assert fa.resolve_blocks(2048, D, dtype, block_q=64) == (64, 64)
        with pytest.raises(NotImplementedError, match=r"compiled for \[\(64, 64\)\]"):
            fa.resolve_blocks(2048, D, dtype, block_q=128, block_k=64)


@pytest.mark.parametrize("D", [136, 192, 200, 256, 264, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_head_dims_past_128_compile_one_128_by_64_tile(dtype, D):
    """From padded head dim 192 on, past 256 too (the sliced forward), the
    16-bit forward runs two consumer warpgroups, 128 query rows a block, at
    64 keys a stage: the table's tile resolves to it without raising, and a
    pin of a 64 x 64 tile or of 128 keys a stage raises."""
    assert fa.compiled_blocks(D, dtype) == ((128, 64),)
    assert fa.resolve_blocks(2048, D, dtype) == (128, 64)
    assert fa.resolve_blocks(2048, D, dtype, block_q=128) == (128, 64)
    for pin in ((64, 64), (128, 128)):
        with pytest.raises(NotImplementedError, match=r"compiled for \[\(128, 64\)\]"):
            fa.resolve_blocks(2048, D, dtype, *pin)


@pytest.mark.parametrize("dtype,passes", [(torch.bfloat16, (None,)),
                                          (torch.float16, (None,)),
                                          (torch.float32, (None,))])
def test_dkv_past_128_counts_one_launch_and_names_each_pass(dtype, passes, monkeypatch):
    """A dkv call is one CUDA launch in every dtype at every head dim: up to
    a padded head dim of 256 named None (the 16-bit kernel sums dK and dV in
    one pass at 192 and 256 too), past 256 by its column slices (520 pads to
    576: three slices of 256 columns in every dtype, the last 64 wide), as
    the forward and dq calls are (the forward at 576: three slices of 256 in
    bf16 and f16, two of 512 in f32; dq at 512: one slice of 512 columns)."""
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "VARIANT_LAUNCHES", {})
    fa._count("bwd_dkv", dtype, 200)
    fa._count("bwd_dkv", dtype, 136)
    fa._count("bwd_dkv", dtype, 128)
    fa._count("bwd_dkv", dtype, 520)
    fa._count("fwd", dtype, 520, 64)
    fa._count("bwd_dq", dtype, 512)
    name = {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]
    assert fa.LAUNCHES == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 4}
    assert fa.VARIANT_LAUNCHES == {**{("bwd_dkv", name, 256, p): 1 for p in passes},
                                   **{("bwd_dkv", name, 192, p): 1 for p in passes},
                                   ("bwd_dkv", name, 128, None): 1,
                                   ("bwd_dkv", name, 576, "3x256"): 1,
                                   ("fwd", name, 576,
                                    "2x512" if dtype == torch.float32 else "3x256"): 1,
                                   ("bwd_dq", name, 512, "1x512"): 1}


@pytest.mark.parametrize("D,bf16,f32", [(264, "2x256", "2x256"), (320, "2x256", "2x256"),
                                        (512, "2x256", "2x256"), (576, "3x256", "3x256"),
                                        (1024, "4x256", "4x256")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dkv_column_slices_past_256(D, bf16, f32, dtype, monkeypatch):
    """Past a padded head dim of 256 a dkv block owns 256 columns of dK and
    of dV in every dtype (``csrc/flash_sliced.cuh``,
    ``csrc/flash_bwd_dkv_f32_sliced.cu``: each consumer warpgroup sums one of
    the two), so the scores are summed twice a key tile at 512; the last
    slice is short where the width does not divide the padded head dim (264
    pads to 320). Every call is one launch, named by its slices."""
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "VARIANT_LAUNCHES", {})
    want = f32 if dtype == torch.float32 else bf16
    assert fa.column_slices("bwd_dkv", D, dtype) == want
    assert fa.slice_columns("bwd_dkv", dtype) == int(want.split("x")[1])
    fa._count("bwd_dkv", dtype, D)
    name = {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]
    assert fa.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 1}
    assert fa.VARIANT_LAUNCHES == {("bwd_dkv", name, fa.padded_head_dim(D), want): 1}


@pytest.mark.parametrize("D,bf16,f32", [(264, "2x256", "1x512"), (320, "2x256", "1x512"),
                                        (512, "2x256", "1x512"), (576, "3x256", "2x512"),
                                        (1024, "4x256", "2x512")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_fwd_column_slices_past_256(D, bf16, f32, dtype, monkeypatch):
    """Past a padded head dim of 256 a forward block owns 256 columns of O
    in bf16 and f16 (``csrc/flash_sliced.cuh``: the consumer warpgroups
    split the block's 128 rows) and 512 in f32
    (``csrc/flash_fwd_f32_sliced.cu``: each consumer warpgroup sums 256 of
    them), so the f32 scores are summed once a row up to 512 and twice at
    576 and 1024. Every call is one launch, named by its slices."""
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "VARIANT_LAUNCHES", {})
    want = f32 if dtype == torch.float32 else bf16
    assert fa.column_slices("fwd", D, dtype) == want
    assert fa.slice_columns("fwd", dtype) == int(want.split("x")[1])
    fa._count("fwd", dtype, D, 64)
    name = {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]
    assert fa.LAUNCHES == {"fwd": 1, "bwd_dq": 0, "bwd_dkv": 0}
    assert fa.VARIANT_LAUNCHES == {("fwd", name, fa.padded_head_dim(D), want): 1}


@pytest.mark.parametrize("D,bf16,f32", [(264, "1x512", "1x512"), (320, "1x512", "1x512"),
                                        (512, "1x512", "1x512"), (576, "2x512", "2x512"),
                                        (1024, "2x512", "2x512")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dq_column_slices_past_256(D, bf16, f32, dtype, monkeypatch):
    """Past a padded head dim of 256 a dq block owns 512 columns of dQ in
    every dtype (``csrc/flash_sliced.cuh``,
    ``csrc/flash_bwd_dq_f32_sliced.cu``: the scores are summed once for both
    256-column halves, each consumer warpgroup sums one), so one block
    covers a row up to 512 and two at 576 and 1024. Every call is one
    launch, named by its slices."""
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "VARIANT_LAUNCHES", {})
    want = f32 if dtype == torch.float32 else bf16
    assert fa.column_slices("bwd_dq", D, dtype) == want
    assert fa.slice_columns("bwd_dq", dtype) == int(want.split("x")[1])
    fa._count("bwd_dq", dtype, D)
    name = {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]
    assert fa.LAUNCHES == {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 0}
    assert fa.VARIANT_LAUNCHES == {("bwd_dq", name, fa.padded_head_dim(D), want): 1}


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
    """The kernels read dO in q's dtype: an f32 dO for a bf16 q is refused."""
    with pytest.raises(NotImplementedError, match="dO in q's dtype"):
        getattr(fa, wrapper)(*_bwd_inputs(torch.float32), **OPTS)
    assert launches == ["check"]
