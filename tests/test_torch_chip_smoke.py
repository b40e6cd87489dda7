"""``chip_smoke.py`` leaves no process behind: orphans of its children come
to it, and its end stops and reaps every descendant."""

import subprocess
import sys
from pathlib import Path

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
