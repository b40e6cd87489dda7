"""``chip_smoke.py`` leaves no process behind: orphans of its children come
to it, and its end stops and reaps every descendant."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# A pod-like child: a new session whose leader starts a sleeper and is then
# SIGKILLed, so the sleeper is orphaned; and a shell that backgrounds a
# sleeper and exits at once. Run in a process of its own, since
# `adopt_orphans` marks the process that calls it for good.
PLANT = """
import os, signal, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

cs.adopt_orphans()
pod = subprocess.Popen(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!; wait"],
                       start_new_session=True, stdout=subprocess.PIPE, text=True)
orphans = [int(pod.stdout.readline())]
os.kill(pod.pid, signal.SIGKILL)
pod.wait()
shell = subprocess.run(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"],
                       capture_output=True, text=True)
orphans.append(int(shell.stdout))
time.sleep(0.2)
adopted = sorted(cs._children())
stopped = cs.stop_descendants(timeout=30.0)
gone = [not os.path.exists(f"/proc/{pid}") for pid in orphans]
print(sorted(orphans) == adopted, len(stopped), gone, sorted(cs._children()))
"""


def test_orphaned_descendants_are_adopted_stopped_and_reaped():
    out = subprocess.run([sys.executable, "-c", PLANT, str(ROOT)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "True 2 [True, True] []", (out.stdout, out.stderr)
    assert out.stderr.count("chip_smoke: stopped a process left running: sleep 300") == 2


# Two functions of a ``cuobjdump -sass`` listing, as the build's library
# gives them: a forward variant that spills (LDL, STL) and names R231, and a
# dkv variant that does neither; and a function that is no flash kernel.
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN9edl_flash16flash_fwd_kernelI13__nv_bfloat16Li256ELi64EEEv14CUtensorMap_stS2_S2_PvPfiiiiiifii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0020*/                   LDL.64 R230, [R1+0x8] ;               /* 0x0000080001e67983 */
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0040*/                   STL [R1+0x10], R231 ;                 /* 0x0000100101007387 */
        /*0050*/                   UTMALDG.4D [UR8], [UR12] ;
        /*0060*/                   EXIT ;                                /* 0x000000000000794d */
\t\t..........
\t\tFunction : _ZN9edl_flash20flash_bwd_dkv_kernelI6__halfLi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PS1_S5_iiiiiiiffi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   HGMMA.64x32x16.F32 R8, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0020*/                   FADD R40, R8, -R9 ;
        /*0030*/                   SYNCS.ARRIVE.TRANS64.A1T0 RZ, [UR4+0x8], RZ ;
        /*0040*/                   EXIT ;
\t\t..........
\t\tFunction : _Z12other_kernelPf
        /*0000*/                   LDL R250, [R1] ;
        /*0010*/                   EXIT ;
"""


def test_sass_parser_counts_local_memory_and_the_highest_register():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    counts = cs.parse_sass(SASS)
    assert set(counts) == {"flash_fwd_kernel", "flash_bwd_dkv_kernel"}
    fwd = counts["flash_fwd_kernel"]["bf16 D256 k64"]
    assert (fwd["LDL"], fwd["STL"], fwd["max_register"]) == (1, 1, 231)
    assert (fwd["HGMMA"], fwd["UTMALDG"], fwd["HMMA"]) == (1, 1, 0)
    dkv = counts["flash_bwd_dkv_kernel"]["f16 D128"]
    assert (dkv["LDL"], dkv["STL"], dkv["max_register"]) == (0, 0, 40)
    assert (dkv["HGMMA"], dkv["SYNCS"]) == (1, 1)


@pytest.fixture
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _recorded_call(fa, dq_row_scale=None):
    """One backward call as `recorded_backward` records it, on the CPU: the
    plain backward stands in for the kernels, on inputs made as
    `_Flash.backward` makes them (the forward's own o and lse), with the
    ring's offsets; ``dq_row_scale`` plants a fault, query row 40 of dq off
    by that scale."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 16), dtype=np.float32))
               .to(torch.bfloat16) for _ in range(3))
    opts = dict(scale=0.25, causal=True, q_offset=10, k_offset=0)
    o, lse = fa._fwd_reference(q, k, v, out_dtype=torch.bfloat16, **opts)
    ct = torch.from_numpy(rng.standard_normal((1, 70, 2, 16), dtype=np.float32))
    do, delta = fa._backward_inputs(q, o, ct, torch.zeros_like(lse))
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = fa._bwd_reference(*args, **opts)
    if dq_row_scale is not None:
        dq = dq.clone()
        dq[:, 40] = (dq[:, 40].float() * dq_row_scale).to(dq.dtype)
    return args, opts, (dq, dk, dv)


def test_backward_call_check_passes_a_healthy_call(cs):
    fa = cs._flash_module()
    worst = cs.check_backward_calls(fa, "cpu", [_recorded_call(fa)], 1)
    assert worst[("dq", "row")] == 0.0 and worst[("dv", "elem")] == 0.0


def test_backward_call_check_raises_on_a_dq_row_off_by_a_scale(cs):
    fa = cs._flash_module()
    with pytest.raises(cs.SmokeFailure, match="backward call's dq off the plain backward"):
        cs.check_backward_calls(fa, "cpu", [_recorded_call(fa, dq_row_scale=1.05)], 1)
    with pytest.raises(cs.SmokeFailure, match="2 backward calls, expected 1"):
        cs.check_backward_calls(fa, "cpu", [_recorded_call(fa)] * 2, 1)


@pytest.mark.parametrize("planted", [False, True])
def test_served_views_hold_each_backward_call_on_its_own_inputs(cs, planted, monkeypatch):
    """`check_served_views` on the CPU, the plain versions standing in for
    the kernels (the route takes the kernel path on every device): it passes
    as it is, and with a backward whose dq has one row off by 5 % it fails
    on the recorded call, not on the whole plain chain's composed error."""
    fa = cs._flash_module()
    plain_bwd = fa._bwd_reference

    def bwd(*args, **opts):
        dq, dk, dv = plain_bwd(*args, **opts)
        if planted:
            dq = dq.clone()
            dq[:, 100] = (dq[:, 100].float() * 1.05).to(dq.dtype)
        return dq, dk, dv

    monkeypatch.setattr(fa, "_route", lambda x, plain, kernel: kernel)
    monkeypatch.setattr(fa, "_fwd_kernel", lambda q, k, v, block_k=None, **opts:
                        fa._fwd_reference(q, k, v, **opts))
    monkeypatch.setattr(fa, "_bwd_kernel", bwd)
    gen = torch.Generator().manual_seed(0)
    if planted:
        with pytest.raises(cs.SmokeFailure, match="served view stride_not_16B: a backward "
                                                  "call's dq off"):
            cs.check_served_views(fa, gen, torch.device("cpu"))
    else:
        cs.check_served_views(fa, gen, torch.device("cpu"))


def test_setmaxnreg_names_every_kernel_with_a_producer_warpgroup(cs):
    """The SASS check requires no local-memory access and no spill of every
    variant of the kernels that move registers with setmaxnreg: the three
    of ``csrc/flash_kernels.cuh`` and the three sliced ones of
    ``csrc/flash_sliced.cuh``, every 16-bit flash kernel, and the six f32
    kernels (``csrc/flash_*_f32.cu`` up to 256, ``csrc/flash_*_f32_sliced.cu``
    past it), which the SASS check also holds to ``mma.sync`` and TMA loads.
    Every name is a kernel in the sources, and each kernel in a source that
    calls setmaxnreg is named."""
    assert set(cs.SETMAXNREG_NAMES) == {"flash_fwd_kernel", "flash_bwd_dq_kernel",
                                        "flash_bwd_dkv_kernel", "flash_fwd_sliced_kernel",
                                        "flash_bwd_dq_sliced_kernel",
                                        "flash_bwd_dkv_sliced_kernel",
                                        "flash_fwd_f32_kernel",
                                        "flash_bwd_dq_f32_kernel",
                                        "flash_bwd_dkv_f32_kernel",
                                        "flash_fwd_f32_sliced_kernel",
                                        "flash_bwd_dq_f32_sliced_kernel",
                                        "flash_bwd_dkv_f32_sliced_kernel"}
    assert set(cs.SETMAXNREG_NAMES) == set(cs.FLASH_NAMES + cs.FLASH_SLICED_NAMES
                                           + cs.FLASH_TF32_NAMES)
    # the TF32 names are every f32 kernel, up to 256 and past it
    assert set(cs.FLASH_TF32_NAMES) == set(cs.FLASH_F32_NAMES + cs.FLASH_F32_SLICED_NAMES)
    csrc = ROOT / "edl_tpu_torch" / "ops" / "csrc"
    kernels = {}
    for src in sorted(csrc.glob("*.cu*")):
        for name in re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(",
                               src.read_text()):
            kernels[name] = src
    assert set(cs.SETMAXNREG_NAMES) <= set(kernels)
    raised = {n for n, src in kernels.items() if "setmaxnreg_inc" in src.read_text()}
    assert raised == set(cs.SETMAXNREG_NAMES)


@pytest.mark.parametrize("mangled,want", [
    ("_ZN9edl_flash12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_"
     "PKfS4_Pfiiiiiiffi", ("flash_bwd_dq_f32_kernel", "f32 D128")),
    ("_ZN9edl_flash12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_"
     "PKfS4_Pfiiiiiiffi", ("flash_bwd_dq_f32_kernel", "f32 D256")),
    ("_ZN9edl_flash12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_"
     "PKfS4_PfS5_iiiiiiffi", ("flash_bwd_dkv_f32_kernel", "f32 D128")),
    ("_ZN9edl_flash12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_"
     "PKfS4_PfS5_iiiiiiffi", ("flash_bwd_dkv_f32_kernel", "f32 D256")),
    ("_ZN9edl_flash12_GLOBAL__N_130flash_bwd_dq_f32_sliced_kernelE14CUtensorMap_stS1_S1_S1_"
     "PKfS3_Pfiiiiiiffi", ("flash_bwd_dq_f32_sliced_kernel", "f32 sliced")),
    ("_ZN9edl_flash12_GLOBAL__N_120flash_fwd_f32_kernelILi256EEEv14CUtensorMap_stS2_S2_PfS3_"
     "iiiiiifi", ("flash_fwd_f32_kernel", "f32 D256")),
    ("_ZN9edl_flash12_GLOBAL__N_127flash_fwd_f32_sliced_kernelE14CUtensorMap_stS1_S1_PfS2_"
     "iiiiiifi", ("flash_fwd_f32_sliced_kernel", "f32 sliced")),
])
def test_variant_names_the_f32_backward_kernels_by_the_labels_the_build_check_wants(
        cs, mangled, want):
    """`_variant` maps each f32 kernel's mangled name (its template argument
    the largest head dim it takes) to the label that the build check's
    ``want`` lists for it: "f32 D128" and "f32 D256" up to 256 for the
    3xTF32 forward, dq and dkv, "f32 sliced" past it."""
    assert cs._variant(mangled) == want
    fn, label = want
    assert fn in cs.FLASH_F32_NAMES + cs.FLASH_F32_SLICED_NAMES
    if fn in cs.FLASH_F32_NAMES:
        assert label in [cs._label("float32", dp) for dp in (128, 256)]
    assert fn in cs.FLASH_TF32_NAMES


@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_the_f32_backward_rows_name_the_3xtf32_design_and_source_up_to_256(cs, D):
    """An f32 kernel row up to a head dim of 256 names the 3xTF32 design of
    the forward, dq and dkv (all D columns a block, the second products over
    all eight consumer warps) and their sources; past 256 the sliced ones."""
    fa = cs._flash_module()
    for kname in ("fwd", "bwd_dq", "bwd_dkv"):
        design = cs._design(fa, kname, "float32", D)
        assert design.startswith("3xTF32 mma.sync + TMA") and "all eight" in design
        assert ("K and V held" in design) == (kname == "bwd_dkv" and D <= 128)
        assert ("V double-buffered" in design) == (kname == "fwd" and D <= 128)
        assert (ROOT / cs.SOURCE_F32[kname]).is_file()
        sliced = cs._design(fa, kname, "float32", 2 * D + 256)
        assert sliced.startswith("3xTF32 mma.sync + TMA ring") and "FMA" not in sliced
        assert (ROOT / cs.SOURCE_F32_SLICED[kname]).is_file()
    assert "512 columns of O a block" in cs._design(fa, "fwd", "float32", 512)


def test_turns_time_the_sliced_forward_and_dq_beside_an_unchanged_control(cs):
    """``--turns`` times the f32 forward at the JAX on-chip check's f32
    shape at D 64, 128, 192, 256 and 512 and at the D-128, D-256 and D-512
    LMs' attention; the f32 sliced dq at D 512 and the bf16 sliced dkv at
    the D-512 LM's attention, unchanged, are the controls for the card's
    drift between turns."""
    rows = {(k, dtype, tuple(shape)) for k, dtype, shape in cs.TURNS}
    check = tuple(cs.ONCHIP_CASES[0][:3])
    assert cs.ONCHIP_CASES[0][5] == "float32"
    shapes = [(*check, D) for D in (64, 128, 192, 256, 512)] + [
        cs.LM_D128_ATTENTION, cs.LM_D256_ATTENTION, cs.LM_D512_ATTENTION]
    assert [s[3] for s in shapes] == [64, 128, 192, 256, 512, 128, 256, 512]
    for shape in shapes:
        assert ("fwd", "float32", tuple(shape)) in rows
    controls = rows - {("fwd", "float32", tuple(s)) for s in shapes}
    assert controls == {("bwd_dq", "float32", (*check, 512)),
                        ("bwd_dkv", "bfloat16", cs.LM_D512_ATTENTION)}
    assert all(s[3] > 256 for _, _, s in controls)  # the sliced backward: unchanged
    assert len(rows) == len(cs.TURNS) == 10


def _stand_in_kernels(fa, monkeypatch, fwd_scale=None):
    """The kernels replaced by their plain versions on the CPU; ``fwd_scale``
    plants a fault, the forward's O off by that scale."""
    def fwd(q, k, v, block_k=None, **opts):
        o, lse = fa._fwd_reference(q, k, v, **opts)
        return (o if fwd_scale is None else (o.float() * fwd_scale).to(o.dtype)), lse

    monkeypatch.setattr(fa, "_fwd_kernel", fwd)
    monkeypatch.setattr(fa, "_bwd_dq_kernel", fa._bwd_dq_reference)
    monkeypatch.setattr(fa, "_bwd_dkv_kernel", fa._bwd_dkv_reference)


@pytest.mark.parametrize("kname", ["fwd", "bwd_dq", "bwd_dkv"])
def test_a_turn_row_holds_the_kernel_and_times_it(cs, kname, monkeypatch):
    """A row of ``--turns`` (`turn_row`), rehearsed on the CPU with the plain
    versions standing in for the kernels and a stub clock: the forward rows
    take the forward path (its lse held too), the backward rows the
    backward's, each row with its bound and SDPA's time."""
    fa = cs._flash_module()
    _stand_in_kernels(fa, monkeypatch)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=20, warmup=3, batch=1: (fn(), 1.0)[1])
    row = cs.turn_row(fa, kname, "bfloat16", (1, 70, 2, 264), torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    assert row["name"] == kname and row["shape"] == [1, 70, 2, 264]
    assert row["row_err"] == 0.0 and row["bound_ms"] > 0.0
    assert row["ms"] == row["ms_back_to_back"] == row["library_ms_back_to_back"] == 1.0


def test_a_turn_row_rejects_a_forward_off_its_plain_version(cs, monkeypatch):
    fa = cs._flash_module()
    _stand_in_kernels(fa, monkeypatch, fwd_scale=1.05)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=20, warmup=3, batch=1: 1.0)
    with pytest.raises(cs.SmokeFailure, match="turns: fwd bfloat16 .* off its plain version"):
        cs.turn_row(fa, "fwd", "bfloat16", (1, 70, 2, 264), torch.Generator().manual_seed(0),
                    torch.device("cpu"))


def _f32_case(cs, fa, D=264):
    """An f32 case as `check_cases` makes it, on the CPU: inputs drawn with
    its generator, the ring's offsets and an lse cotangent, and the plain
    versions' outputs."""
    shape = (1, 70, 90, 2, D)
    q, k, v, do, dlse, out_dtype = cs._case_inputs(shape, False, True,
                                                   torch.Generator().manual_seed(0),
                                                   torch.device("cpu"), "float32")
    opts = dict(scale=1.0 / D ** 0.5, causal=True, q_offset=20, k_offset=0)
    return q, k, v, out_dtype, opts, cs._plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts)


@pytest.mark.parametrize("D", [64, 200, 264, 576])
def test_the_f32_bound_passes_f32_outputs_and_rejects_tf32_rounded_inputs(cs, D):
    """A case's f32 bounds (`case_f32_bounds`: ``TOL_*_F32``, or four times
    the plain version's own error against the function in f64 where that is
    larger) pass that function in f64 (rounded to f32) against the plain
    versions' f32 outputs, and reject every output of the same plain
    versions fed q, k, v and dO with the low 13 mantissa bits masked (TF32),
    the planted fault `check_tf32_fault` holds them to; the kernel bounds
    pass both."""
    fa = cs._flash_module()
    q, k, v, out_dtype, opts, want = _f32_case(cs, fa, D)
    masked = cs.tf32_rounded(q)
    assert masked.dtype == torch.float32 and bool((masked != q).any())
    assert bool(((masked.view(torch.int32) & 0x1FFF) == 0).all())
    assert float((masked - q).abs().max()) <= 2.0 ** -10 * float(q.abs().max())
    bounds = cs.case_f32_bounds(fa, q, k, v, want, opts)
    assert set(bounds) == {"o", "dq", "dk", "dv"}
    bwd = (q, k, v, want["do"], want["lse"], want["delta"])
    exact = dict(zip(("o", "dq", "dk", "dv"), (
        *cs._exact_outputs(fa, "fwd", q, k, v, None, None, None, opts),
        *cs._exact_outputs(fa, "bwd_dq", *bwd, opts), *cs._exact_outputs(fa, "bwd_dkv", *bwd, opts))))
    for name, b in bounds.items():
        assert b["row"] >= cs.TOL_ROW_F32 and b["elem"] >= cs.TOL_ELEM_F32
        assert cs._compare(want[name], exact[name]) == b["own"]
        err = cs._compare(exact[name], want[name])
        assert cs._passes_f32(err, b) and cs._passes(err), (name, err)
    faulty = cs.tf32_fault_outputs(fa, q, k, v, want, out_dtype, opts)
    assert set(faulty) == {"o", "dq", "dk", "dv"}
    for name, got in faulty.items():
        err = cs._compare(got, want[name])
        assert not cs._passes_f32(err, bounds[name]) and not cs._passes_f32(err), (name, err)
        assert cs._passes(err), (name, err)  # the bf16 bounds alone would let it through
    cs.check_tf32_fault(fa, "cpu", q, k, v, want, out_dtype, opts, bounds)


def test_the_tf32_fault_check_fails_a_bound_too_loose_to_reject_it(cs, monkeypatch):
    fa = cs._flash_module()
    q, k, v, out_dtype, opts, want = _f32_case(cs, fa)
    monkeypatch.setattr(cs, "TOL_ROW_F32", cs.TOL_ROW)
    monkeypatch.setattr(cs, "TOL_ELEM_F32", cs.TOL_ELEM)
    bounds = cs.case_f32_bounds(fa, q, k, v, want, opts)
    with pytest.raises(cs.SmokeFailure, match="the f32 bound passes the planted TF32 fault"):
        cs.check_tf32_fault(fa, "cpu", q, k, v, want, out_dtype, opts, bounds)


def test_an_f32_bound_is_the_fixed_one_or_a_multiple_of_the_plain_versions_own_error(cs):
    """Where the plain version is within the fixed f32 bound of the exact
    function the bound is ``TOL_*_F32``; where it is further off (a row of
    dq that cancels, at a long sequence) the bound is ``F32_OWN_HEADROOM``
    times its own error, metric by metric."""
    exact = torch.ones(2, 3, 8)
    want = {"close": exact * (1 + 1e-7), "far": exact * (1 + 1e-3)}
    bounds = cs.f32_bounds(("close", "far"), want, (exact, exact))
    assert bounds["close"]["row"] == cs.TOL_ROW_F32
    assert bounds["close"]["elem"] == cs.TOL_ELEM_F32
    own = cs._compare(want["far"], exact)
    assert bounds["far"]["own"] == own
    assert bounds["far"]["row"] == pytest.approx(cs.F32_OWN_HEADROOM * own["row"])
    assert bounds["far"]["elem"] == pytest.approx(cs.F32_OWN_HEADROOM * own["elem"])
    assert bounds["far"]["row"] > cs.TOL_ROW_F32


def test_kernel_bounds_take_the_smaller_of_the_fma_and_3xtf32_bounds_in_f32(cs):
    """An f32 row's bound is the least time of its work: the smaller of its
    FLOPs at the f32 FMA peak and three TF32 FLOPs a FLOP at the TF32 peak
    (both kept), or its bytes at the HBM rate if more; 16-bit rows keep the
    bf16 peak."""
    shape = (2, 1024, 4, 512)
    pairs = 2 * 4 * 1024 * 1025 // 2
    f32 = cs.kernel_bounds(*shape, "float32")
    bf16 = cs.kernel_bounds(*shape, "bfloat16")
    for kname, per_pair in (("fwd", 4), ("bwd_dq", 6), ("bwd_dkv", 8)):
        flops = per_pair * pairs * 512
        row = f32[kname]
        assert row["bound_fma_ms"] == pytest.approx(flops / cs.PEAK_F32_FLOPS * 1e3)
        assert row["bound_tf32_ms"] == pytest.approx(3 * flops / cs.PEAK_TF32_FLOPS * 1e3)
        assert row["bound_ms"] == row["bound_tf32_ms"] and row["bound_by"] == "operations"
        assert (bf16[kname]["bound_ms"], bf16[kname]["bound_by"]) == cs._kernel_bounds(
            *shape, 2, cs.PEAK_BF16_FLOPS)[kname]
        assert set(bf16[kname]) == {"bound_ms", "bound_by"}
    # the sliced dq's FMA and 3xTF32 bounds at the JAX check's f32 shape
    assert round(f32["bwd_dq"]["bound_fma_ms"], 4) == 0.1925
    assert round(f32["bwd_dq"]["bound_tf32_ms"], 4) == 0.0782


@pytest.mark.parametrize("D", [200, 264])
@pytest.mark.parametrize("kname", ["bwd_dq", "bwd_dkv", "fwd"])
def test_an_f32_turn_row_holds_the_f32_bound_and_reports_both_bounds(cs, kname, D,
                                                                      monkeypatch):
    """An f32 row of ``--turns`` (`turn_row`), rehearsed on the CPU with the
    plain versions standing in for the kernels and a stub clock, at a head
    dim up to 256 and one past it: it holds the f32 bound and reports its
    FMA and 3xTF32 bounds, the smaller as its bound, and the plain version's
    time; a kernel whose output is off by one TF32 rounding of its inputs
    fails it."""
    fa = cs._flash_module()
    _stand_in_kernels(fa, monkeypatch)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=20, warmup=3, batch=1: (fn(), 1.0)[1])
    shape = (1, 70, 2, D)
    row = cs.turn_row(fa, kname, "float32", shape, torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    want = cs.kernel_bounds(*shape, "float32")[kname]
    assert row["bound_ms"] == want["bound_ms"] == min(row["bound_fma_ms"], row["bound_tf32_ms"])
    assert row["bound_tf32_ms"] <= row["bound_fma_ms"]
    assert row["row_err"] == 0.0 and row["plain_ms"] == 1.0
    if kname == "bwd_dq":
        plain = fa._bwd_dq_reference
        monkeypatch.setattr(fa, "_bwd_dq_kernel", lambda q, k, v, do, *rest, **opts: plain(
            cs.tf32_rounded(q), cs.tf32_rounded(k), cs.tf32_rounded(v), cs.tf32_rounded(do),
            *rest, **opts))
        with pytest.raises(cs.SmokeFailure, match="turns: bwd_dq float32 .* off its plain"):
            cs.turn_row(fa, kname, "float32", shape, torch.Generator().manual_seed(0),
                        torch.device("cpu"))


# Phases 12-16's group runner on the CPU, with stub phases: groups "a + b"
# and "c" must meet at a barrier (each waits for the other's file, which
# only groups running at once can pass); group "bad" fails while group "a"
# passes; group "slow" outlasts the runner's timeout. The children run this
# same script (``cs.__file__`` points at it), so they see the stubs too.
GROUPS = """
import json, os, sys, time
sys.path.insert(0, ROOT)
import chip_smoke as cs
import torch

cs.__file__ = os.path.abspath(__file__)
BARRIER = os.path.join(os.path.dirname(cs.__file__), "barrier")


def meet(me, other):
    open(f"{BARRIER}.{me}", "w").close()
    deadline = time.monotonic() + 60
    while not os.path.exists(f"{BARRIER}.{other}"):
        cs.require(time.monotonic() < deadline, f"{me}: {other} never came")
        time.sleep(0.05)


def stub(name, fn=None):
    def phase(device, job):
        if fn is not None:
            fn()
        print(f"phase {name} ran")
        return {"name": name, "device": str(device), "profiler": job["profiler"]}
    return phase


cs.GROUP_PHASES.update(a=stub("a", lambda: meet("a", "c")), b=stub("b"),
                       c=stub("c", lambda: meet("c", "a")),
                       bad=stub("bad", lambda: cs.require(False, "planted")),
                       slow=stub("slow", lambda: time.sleep(300)))
if sys.argv[1:2] == ["--phases"]:
    sys.exit(cs.main(sys.argv[1:]))
out = {}
for label, groups, timeout in (("met", (("a", "b"), ("c",)), 120),
                               ("bad", (("bad",), ("b",)), 120),
                               ("slow", (("slow",),), 8)):
    seconds = {}
    try:
        records = cs.run_phase_groups(torch.device("cpu"), seconds, {"p": 1}, groups, timeout)
        out[label] = {"records": records, "seconds": sorted(seconds)}
    except cs.SmokeFailure as e:
        out[label] = {"failure": str(e), "seconds": sorted(seconds)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    script = tmp_path_factory.mktemp("groups") / "groups.py"
    script.write_text(GROUPS.replace("ROOT", repr(str(ROOT)), 1))
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout, out.stderr


def test_phase_groups_run_at_once_and_merge_their_records(grouped):
    stdout, _ = grouped
    met = json.loads(stdout.strip().splitlines()[-1])["met"]
    assert "failure" not in met, met
    assert set(met["records"]) == {"a", "b", "c"} and met["seconds"] == ["a", "b", "c"]
    assert met["records"]["c"] == {"name": "c", "device": "cpu", "profiler": {"p": 1}}
    # each group's lines printed whole: a's and b's together
    assert "phase a ran\nseconds: the a phase took" in stdout
    assert "phase b ran\nseconds: the b phase took" in stdout


def test_a_failing_phase_group_fails_the_run_after_the_others_end(grouped):
    stdout, stderr = grouped
    bad = json.loads(stdout.strip().splitlines()[-1])["bad"]
    assert bad["failure"] == "phase groups failed: bad: exit 1"
    assert bad["seconds"] == ["b"]  # the other group ran to its end
    assert "SmokeFailure: planted" in stderr


def test_a_phase_group_past_the_timeout_is_stopped_and_fails_the_run(grouped):
    stdout, _ = grouped
    slow = json.loads(stdout.strip().splitlines()[-1])["slow"]
    assert slow["failure"] == "phase groups failed: slow: exit stopped after 8 s"


def test_phase_groups_hold_each_process_phase_once_and_leave_controller_and_chaos_alone(cs):
    """Phases 12-15 run at once in `PHASE_GROUPS`, each in one group; the
    elastic phase's two halves compose its record; the controller and chaos
    phases, whose checks are timed against their own processes, run alone."""
    names = [name for group in cs.PHASE_GROUPS for name in group]
    assert sorted(names) == sorted(cs.GROUP_PHASES) == [
        "dp", "elastic_local", "elastic_mp", "entries", "mp"]
    local = {"rows": {"lm": {"launches": {"fwd": 3, "bwd_dq": 2, "bwd_dkv": 2}}},
             "multihost": {}, "ckpt_plane": {}}
    mp = {"launches": {"fwd": 16, "bwd_dq": 8, "bwd_dkv": 8}}
    record = cs.elastic_record(local, mp)
    assert record["launches"] == {"fwd": 19, "bwd_dq": 10, "bwd_dkv": 10}
    assert set(record) == {"rows", "multihost", "ckpt_plane", "mp", "launches"}
