#!/usr/bin/env python3
"""Drive the PyTorch port (``edl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # phases 1-3 only: build, check, time

It imports nothing of JAX and nothing of ``edl_tpu``. Phases, in order; a
phase that fails raises, and the script exits non-zero without its last line:

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them; turns TF32 off for f32 matmuls
   and convolutions.
2. Build: compiles the CUDA sources with ``nvcc`` for ``sm_90a``, prints
   ptxas's registers and spills, and counts with ``cuobjdump -sass`` each
   kernel's wgmma (``HGMMA``), TMA load (``UTMALDG``), mbarrier
   (``SYNCS``) and ``mma.sync`` (``HMMA``) instructions; every flash kernel
   must have wgmma and TMA loads and no ``mma.sync``.
3. Kernels: each of the three flash-attention kernels against its plain
   PyTorch version on the same inputs, at the slice's shape, a ragged shape,
   the ring's offset cases (with an lse cotangent), cases with rows that see
   no key (one with a whole 128-row query block that sees none), head dims
   8, 16 and 32, and fewer queries than keys, row by row and element by
   element;
   then proof that the comparison rejects two planted faults (one key tile
   left out for the later query tiles; the later rows off by 2 %) at the
   slice's shape; then each kernel's time at the slice's shape (``ms``: one
   call at a time; ``ms_back_to_back``: ten launches in a row), its wrapper's
   host time a call (and the whole backward's, inputs checked once), its
   plain version's time, one library call's (timed both ways) and the
   card's bound.
4. The LM: the GPT-2-small-width transformer LM (12 layers, d_model 768,
   seq 1024, vocab 32000, batch 8) trained by the ``Trainer`` with Adam at lr
   3e-4 on one repeated synthetic batch. Losses must be finite and fall, and
   each kernel's launch count over the timed steps must be 12 x steps. Then
   one more step under ``torch.profiler``: its device time by kernel.
5. The same width at depth 2, one step through the kernels and one through
   the plain attention path from the same weights: loss and every gradient
   compared.
6. CTR, the flagship, at its published width (tables of 1000192 rows,
   embed 10, MLP 400-400-400) and batch 8192, trained with adagrad at lr
   0.05: a finite, falling loss; the padded table rows and a sample of rows
   no id reaches bit for bit unchanged; step ms, samples/s, MFU, peak
   memory and the profiled step's busy share and top device ops.
7. CTR on the card against the port on the CPU: the same state_dict and a
   batch of 1024, the loss and each param's update after one adagrad step.
8. fit_a_line, word2vec, MNIST and ResNet-50 (224 px, batch 64) at their
   default widths, 10 timed steps each: a finite, falling loss and the same
   numbers as CTR's.
9. The LM of phase 4 with ``remat=True``: the flash forward launched twice
   a block (fwd 240, dq 120, dkv 120 over the timed steps), lower peak
   memory and the same losses as phase 4's.
10. Serve (`edl_tpu_torch.serving`): phase 4's LM, exported right after
    its run, served by an ``LMServingReplica`` on the card to 16 streams in
    three staggered waves (four through HTTP ``/generate``), each to its
    full token count; its decode held against a re-prefill per token on the
    card (tokens and K/V cache), which must reject a planted fault (the new
    K/V written one slot late), and against the port's prefill on the CPU;
    prefill and decode step times, tokens/s, TTFT and a profiled window of
    decode steps. Then phase 6's CTR, exported right after its run, served
    by a ``ServingReplica`` to 512 single-row requests (16 through HTTP
    ``/predict``), with version 2 (two more adagrad steps) exported
    mid-traffic and swapped in with no failed request; every answer against
    the module's ``predict``. The serving path launches no flash kernel.
11. One JSON line ``{"kernels": [...]}``, one ``{"zoo": [...]}`` (a row
    per model, the remat LM included) and one ``{"serve": {...}}``.
12. The last line: ``{"ok": true, "device": {...}}``.

Every step time here is the host clock around one ``train_step`` and a
``torch.cuda.synchronize()``: the median of the timed steps after
``WARMUP_STEPS`` steps. MFU is `edl_tpu_torch.tools.mfu`'s: the model's
analytic FLOPs over the card's dense bf16 peak.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: kernel vs plain version, both on the card, compared row by row (a row is
#: one query's or one key's D outputs), so that the late rows of a causal
#: run, whose values are far smaller than the first rows', are held as
#: tightly: each row's ||kernel - plain|| / ||plain|| <= TOL_ROW, and each
#: element's |kernel - plain| <= TOL_ELEM * (|plain| + the rms of its row).
#: O, dQ, dK and dV are bf16 (one rounding: up to 2^-8 of the value), and the
#: kernels round P and dS to bf16 before their second product where the
#: plain version stays f32 (about 1e-3 of a row's norm, as a random walk of
#: roundings of up to 2^-9). A row's norm counts as at least ROW_FLOOR of the
#: tensor's rms row norm: a row that cancels to zero in exact arithmetic
#: (query 0 of a causal run has dQ = 0, as delta equals its one dP) is held
#: to rounding, not to its own vanishing size. Rows that are zero by the mask
#: (a query that sees no key, a key that no query sees) must be exactly zero.
TOL_ROW = 1e-2
TOL_ELEM = 2**-5
ROW_FLOOR = 1e-2
#: lse is f32 from f32 statistics in both versions (summation order only);
#: absolute, since an error in lse is a relative error of the softmax's sum
TOL_LSE = 1e-4
#: the planted faults that the comparison must reject at the slice's shape:
#: key tile FAULT_K_TILE left out for query tiles FAULT_Q_TILE and later, and
#: the rows of those query tiles (keys, for dK and dV) off by FAULT_SCALE
FAULT_K_TILE, FAULT_Q_TILE, FAULT_SCALE = 3, 8, 0.02
#: depth-2 step, kernel path against the plain attention path (dense_attention)
#: from the same weights: both round P to bf16 before P·V, at different
#: places, and the bf16 residual stream carries the difference through two
#: layers. Loss relative error, and each gradient's relative norm error.
TOL_STEP_LOSS = 2e-2
TOL_STEP_GRAD = 5e-2

SLICE = dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072, seq_len=1024,
             vocab_size=32000)
BATCH = 8
STEPS = 10
WARMUP_STEPS = 2
#: the remat LM against the remat-off LM from the same seed and batch: the
#: recompute runs the same kernels on the same inputs, so each step's loss
#: agrees to this relative error
TOL_REMAT_LOSS = 1e-5

#: CTR at its published width (`models/ctr.py`): sparse dim 1000001, padded
#: to a multiple of 256, and the benchmark's batch
CTR_BATCH = 8192
CTR_PADDED_ROWS = 1000192
#: rows of each table that no id of the batch reaches, sampled and held bit
#: for bit over the run, besides the padded rows
UNTOUCHED_ROWS = 4096
#: CTR on the card against the port on the CPU, one batch of PARITY_BATCH:
#: both run the MLP in bf16 with their own roundings (cuBLAS against the
#: CPU's), and the table gradient's duplicate ids add up in another order on
#: the card (atomics). The loss's relative error, and each param's update
#: after one adagrad step as a relative norm error; the LM's tolerances
PARITY_BATCH = 1024
TOL_CTR_LOSS = 2e-2
TOL_CTR_UPDATE = 5e-2
#: the other zoo models at their default widths: (batch, optimizer, lr)
ZOO = {
    "fit_a_line": (1024, "sgd", 0.1),
    "word2vec": (1024, "adam", 1e-2),
    "mnist": (256, "adam", 1e-3),
    "resnet50": (64, "adam", 1e-3),
}
#: device ops listed per profiled step
TOP_OPS = 10
#: launches in a row for the back-to-back kernel and library timings
BACK_TO_BACK = 10

KERNELS = {  # name -> (plain version, TPU kernel it replaces)
    "fwd": ("_fwd_reference", "edl_tpu/ops/flash_attention.py:88"),
    "bwd_dq": ("_bwd_dq_reference", "edl_tpu/ops/flash_attention.py:178"),
    "bwd_dkv": ("_bwd_dkv_reference", "edl_tpu/ops/flash_attention.py:219"),
}
SOURCE = "edl_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
#: kernel -> (its function in the library, the design it is built on)
DESIGNS = {
    "fwd": ("flash_fwd_kernel", "wgmma+TMA, PR 2"),
    "bwd_dq": ("flash_bwd_dq_kernel", "wgmma+TMA, PR 3"),
    "bwd_dkv": ("flash_bwd_dkv_kernel", "wgmma+TMA, PR 2"),
}
#: SASS instructions counted per kernel: wgmma, TMA tile load, mbarrier,
#: mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA")

#: (name, (B, Sq, Sk, H, D), causal, q_offset, k_offset, return_lse, fused):
#: ``fused`` cases take q, k and v as strided slices of one (B, S, 3, H, D)
#: tensor, as the model hands them over
CASES = [
    ("slice", (8, 1024, 1024, 12, 64), True, 0, 0, False, True),
    ("ragged", (2, 300, 300, 2, 64), False, 0, 0, False, True),
    ("ragged_causal", (2, 300, 300, 2, 64), True, 0, 0, False, True),
    ("ring_diagonal", (2, 300, 300, 2, 64), True, 300, 300, True, False),
    ("ring_past", (2, 300, 300, 2, 64), True, 300, 0, True, False),
    ("no_key_rows", (1, 200, 200, 2, 64), True, 0, 69, True, False),
    # queries 0-199 see no key: the first 128-row dq block sees none, the
    # second has one warpgroup that sees none; keys 100-299 are seen by none
    ("no_key_block", (1, 300, 300, 2, 64), True, 0, 200, True, False),
    ("head_dim_8", (1, 100, 100, 2, 8), True, 0, 0, False, True),
    ("head_dim_16", (1, 100, 100, 2, 16), True, 0, 0, False, True),
    ("head_dim_32", (1, 100, 100, 2, 32), False, 0, 0, False, True),
    # fewer queries than keys, the queries late in the sequence
    ("uneven", (1, 100, 260, 2, 32), True, 160, 0, True, False),
]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Device time of one call of ``fn`` in ms, by CUDA events: the median of
    ``reps`` runs after a warm-up. A run is one call by default, so the
    host's work for the call shows in its time; with ``batch`` > 1 it is
    ``batch`` calls in a row, divided by ``batch``, so that the host's work
    for a call overlaps the device's work as it does in a step."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Host time of one call of ``fn`` in ms: the wall clock over ``reps``
    calls in a row with no synchronisation between them (the wrapper's
    Python, ctypes and tensor-map work and the launch itself), after a
    warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def _flash_module():
    """The module ``edl_tpu_torch.ops.flash_attention`` (the package's
    attribute of that name is the function)."""
    import importlib

    return importlib.import_module("edl_tpu_torch.ops.flash_attention")


def bound(flops: float, nbytes: float):
    """(ms, what bounds it): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# -- phases --------------------------------------------------------------------


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return torch.device("cuda", 0)


def phase_build() -> dict:
    """Build the library; returns the SASS counts (`sass_counts`)."""
    from edl_tpu_torch.ops import _build

    fa = _flash_module()
    t0 = time.perf_counter()
    path = _build.build()
    fa._kernels()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            print(f"  ptxas: {line.strip()}")
    counts = sass_counts(path)
    for fn, by_dp in counts.items():
        for dp, ops in sorted(by_dp.items()):
            print(f"  sass: {fn}<{dp}> " + ", ".join(f"{op} {n}" for op, n in ops.items()))
    for fn, _ in DESIGNS.values():
        require(fn in counts, f"{fn} is not in the library's SASS")
        for dp, ops in counts[fn].items():
            require(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                    f"{fn}<{dp}> lacks wgmma or TMA loads, or has mma.sync, in its "
                    f"SASS: {ops}")
    return counts


def sass_counts(path) -> dict:
    """{kernel: {padded head dim: {op: instructions}}} for the flash
    kernels, from ``cuobjdump -sass`` of the built library."""
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(path)],
        check=True, capture_output=True, text=True, timeout=300).stdout
    counts, ops = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((n for n in FLASH_NAMES if n in fn), None)
            dp = re.search(r"ILi(\d+)E", fn)
            ops = None
            if name is not None and dp is not None:
                ops = counts.setdefault(name, {}).setdefault(int(dp.group(1)),
                                                             dict.fromkeys(SASS_OPS, 0))
        elif ops is not None:
            hit = re.search(r"\b(" + "|".join(SASS_OPS) + r")\b", line)
            if hit:
                ops[hit.group(1)] += 1
    return counts


def _case_inputs(shape, fused, return_lse, gen, device):
    import torch

    B, Sq, Sk, H, D = shape

    def randn(*s):
        return torch.randn(s, generator=gen, device=device).to(torch.bfloat16)

    if fused:
        qkv = randn(B, Sq, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
    out_dtype = torch.float32 if return_lse else torch.bfloat16
    do = torch.randn((B, Sq, H, D), generator=gen, device=device).to(out_dtype)
    dlse = (torch.randn((B, H, Sq), generator=gen, device=device) if return_lse
            else torch.zeros((B, H, Sq), device=device))
    return q, k, v, do, dlse, out_dtype


def _compare(got, want) -> dict:
    """Errors of ``got`` against ``want``, rows along the last dim: ``abs``,
    the largest |got - want|; ``row``, the worst ||got - want|| / ||want||
    of a row; ``elem``, the worst |got - want| / (|want| + rms of its row).
    A row's norm counts as at least ``ROW_FLOOR`` of the rms row norm."""
    g, w = got.float(), want.float()
    diff = g - w
    w_norm = w.norm(dim=-1)
    w_norm = w_norm.clamp_min(ROW_FLOOR * w_norm.square().mean().sqrt().item())
    row = diff.norm(dim=-1) / w_norm
    elem = diff.abs() / (w.abs() + (w_norm / math.sqrt(w.shape[-1]))[..., None])
    return {"abs": diff.abs().max().item(), "row": row.max().item(),
            "elem": elem.max().item()}


def _passes(err: dict) -> bool:
    return err["row"] <= TOL_ROW and err["elem"] <= TOL_ELEM


def _fmt(err: dict) -> str:
    return " ".join(f"{m} {x:.3e}" for m, x in err.items())


def _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts) -> dict:
    """The plain versions' outputs, and the dO, lse and delta that both
    backward versions are given: the plain forward's lse, and dO and delta as
    the autograd function makes them from its O."""
    o, lse = fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)
    do, delta = fa._backward_inputs(q, o, do, dlse)
    dk, dv = fa._bwd_dkv_reference(q, k, v, do, lse, delta, **opts)
    return dict(o=o, lse=lse, do=do, delta=delta, dk=dk, dv=dv,
                dq=fa._bwd_dq_reference(q, k, v, do, lse, delta, **opts))


def check_planted_faults(fa, gen, device) -> None:
    """The comparison must reject two planted faults at the slice's shape,
    each held against the true outputs: a kernel that leaves out one key tile
    for the later query tiles (the plain versions' outputs with that tile
    masked off), and one whose later rows are off by ``FAULT_SCALE`` of their
    value (a slip in a rescaling), small beside the first rows' values."""
    from unittest import mock

    name, shape, causal, qo, ko, ret_lse, fused = CASES[0]
    q, k, v, do, dlse, out_dtype = _case_inputs(shape, fused, ret_lse, gen, device)
    opts = dict(scale=1.0 / math.sqrt(shape[4]), causal=causal, q_offset=qo, k_offset=ko)
    want = _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts)
    valid, first = fa._valid, FAULT_Q_TILE * fa.TILE

    def faulty_valid(*args):
        mask = valid(*args).clone()
        mask[first:, FAULT_K_TILE * fa.TILE:(FAULT_K_TILE + 1) * fa.TILE] = False
        return mask

    def rescaled(x):
        x = x.clone()
        x[:, first:] = (x[:, first:].float() * (1 + FAULT_SCALE)).to(x.dtype)
        return x

    args = (q, k, v, want["do"], want["lse"], want["delta"])
    with mock.patch.object(fa, "_valid", faulty_valid):
        o, lse = fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)
        dk, dv = fa._bwd_dkv_reference(*args, **opts)
        dropped = dict(o=o, dq=fa._bwd_dq_reference(*args, **opts), dk=dk, dv=dv)
    lse_err = (lse - want["lse"]).abs().max().item()
    require(lse_err > TOL_LSE, "the lse check passes the planted fault")
    faults = {
        f"key tile {FAULT_K_TILE} left out for query tiles >= {FAULT_Q_TILE} "
        f"(lse abs {lse_err:.3e})": dropped,
        f"rows from {first} on off by {FAULT_SCALE} of their value":
            {n: rescaled(want[n]) for n in dropped},
    }
    for label, got in faults.items():
        print(f"planted fault ({name} {shape}): {label}")
        for n, g in got.items():
            err = _compare(g, want[n])
            scaled = err["abs"] / max(1.0, want[n].float().abs().max().item())
            print(f"  {n}: {_fmt(err)}; max abs err / max(1, max |plain|) {scaled:.3e}")
            require(not _passes(err), f"the {n} check passes the planted fault {label}")


def phase_kernels(device):
    """Every kernel against its plain version on every case, and the check
    against planted faults; returns per-kernel worst errors (each with the
    case and output it came from) and, at the slice's shape, the timings."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    gen = torch.Generator(device=device).manual_seed(0)
    outputs = {"fwd": ("o", "lse"), "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}
    worst = {kname: {} for kname in KERNELS}  # metric -> (value, "case output")

    for name, shape, causal, qo, ko, ret_lse, fused in CASES:
        q, k, v, do, dlse, out_dtype = _case_inputs(shape, fused, ret_lse, gen, device)
        opts = dict(scale=1.0 / math.sqrt(shape[4]), causal=causal,
                    q_offset=qo, k_offset=ko)
        want = _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts)
        do, lse_p, delta = want["do"], want["lse"], want["delta"]
        o_k, lse_k = fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts)
        dq_k = fa._bwd_dq_kernel(q, k, v, do, lse_p, delta, **opts)
        dk_k, dv_k = fa._bwd_dkv_kernel(q, k, v, do, lse_p, delta, **opts)
        torch.cuda.synchronize()

        for t in (o_k, lse_k, dq_k, dk_k, dv_k):
            require(bool(torch.isfinite(t).all()), f"{name}: non-finite kernel output")
        no_key = lse_p == fa._NEG_INF  # (B, H, Sq)
        require(torch.equal(lse_k == fa._NEG_INF, no_key),
                f"{name}: the -1e30 sentinel rows of the kernel's lse differ")
        rows = no_key.transpose(1, 2)  # (B, Sq, H)
        require(bool((o_k[rows] == 0).all()) and bool((dq_k[rows] == 0).all()),
                f"{name}: rows that see no key must give O = 0 and dQ = 0")
        unseen = ~fa._valid(shape[1], shape[2], qo, ko, causal, device).any(0)
        require(bool((dk_k[:, unseen] == 0).all()) and bool((dv_k[:, unseen] == 0).all()),
                f"{name}: keys that no query sees must give dK = 0 and dV = 0")
        live = ~no_key
        lse_err = ((lse_k[live] - lse_p[live]).abs().max().item()
                   if live.any() else 0.0)
        errs = {"o": _compare(o_k, want["o"]), "dq": _compare(dq_k, want["dq"]),
                "dk": _compare(dk_k, want["dk"]), "dv": _compare(dv_k, want["dv"])}
        print(f"kernels {name} {shape} causal={causal} offsets=({qo}, {ko}) "
              f"lse={ret_lse} no-key rows={int(no_key.sum())} unseen keys="
              f"{int(unseen.sum())}: lse abs "
              f"{lse_err:.3e}; " + "; ".join(f"{n} {_fmt(e)}" for n, e in errs.items()))
        require(lse_err <= TOL_LSE,
                f"{name}: lse off its plain version by {lse_err:.3e} (tolerance {TOL_LSE})")
        for n, e in errs.items():
            require(_passes(e), f"{name}: {n} off its plain version: {_fmt(e)} "
                                f"(tolerances: row {TOL_ROW}, elem {TOL_ELEM})")
        errs["lse"] = {"abs": lse_err}
        for kname, outs in outputs.items():
            for n in outs:
                for metric, x in errs[n].items():
                    if x >= worst[kname].get(metric, (-1.0, ""))[0]:
                        worst[kname][metric] = (x, f"{name} {n}")

    check_planted_faults(fa, gen, device)

    # -- timings at the slice's shape
    name, shape, causal, qo, ko, ret_lse, fused = CASES[0]
    B, S, _, H, D = shape
    q, k, v, do, dlse, out_dtype = _case_inputs(shape, fused, ret_lse, gen, device)
    opts = dict(scale=1.0 / math.sqrt(D), causal=causal, q_offset=qo, k_offset=ko)
    o, lse = fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts)
    do, delta = fa._backward_inputs(q, o, do, dlse)
    args = (q, k, v, do, lse, delta)
    timed = {
        "fwd": (lambda: fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts),
                lambda: fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)),
        "bwd_dq": (lambda: fa._bwd_dq_kernel(*args, **opts),
                   lambda: fa._bwd_dq_reference(*args, **opts)),
        "bwd_dkv": (lambda: fa._bwd_dkv_kernel(*args, **opts),
                    lambda: fa._bwd_dkv_reference(*args, **opts)),
    }
    # the library yardstick, never called by the port: PyTorch's fused SDPA
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_do = do.transpose(1, 2)

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)

    # each (one call at a time, back to back)
    fwd_times = (time_ms(lib_fwd), time_ms(lib_fwd, batch=BACK_TO_BACK))
    bwd_times = (time_ms(lib_bwd), time_ms(lib_bwd, batch=BACK_TO_BACK))
    library = {"fwd": fwd_times, "bwd_dq": bwd_times, "bwd_dkv": bwd_times}

    pairs = B * H * S * (S + 1) // 2  # visible (query, key) pairs, causal
    row_bytes = B * H * S * D * 2     # one bf16 (B, S, H, D) tensor
    stat_bytes = B * H * S * 4        # one f32 (B, H, S) row statistic
    bounds = {
        # q, k, v in; o, lse out. QKᵀ and PV
        "fwd": bound(2 * 2 * pairs * D, 4 * row_bytes + stat_bytes),
        # q, k, v, dO, lse, delta in; dq out. S, dP and dS·K
        "bwd_dq": bound(3 * 2 * pairs * D, 5 * row_bytes + 2 * stat_bytes),
        # q, k, v, dO, lse, delta in; dk, dv out. Sᵀ, dPᵀ, Pᵀ·dO and dSᵀ·Q
        "bwd_dkv": bound(4 * 2 * pairs * D, 6 * row_bytes + 2 * stat_bytes),
    }
    results = {}
    for kname, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, reps=5, warmup=1)
        ms_b2b, wrapper_ms = time_ms(kernel, batch=BACK_TO_BACK), host_ms(kernel)
        (lib_ms, lib_b2b), (bound_ms, bound_by) = library[kname], bounds[kname]
        print(f"time {kname} at {shape}: kernel {ms:.4f} ms one call at a time "
              f"({ms_b2b:.4f} ms back to back; host {wrapper_ms:.4f} ms a call), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms ({lib_b2b:.4f} ms back to back), "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        results[kname] = dict(
            name=kname, route="cuda", source=SOURCE, replaces=KERNELS[kname][1],
            design=DESIGNS[kname][1],
            max_abs_err=worst[kname]["abs"][0],
            worst={m: {"value": x, "case": c} for m, (x, c) in worst[kname].items()},
            tolerance={"row": TOL_ROW, "elem": TOL_ELEM, "lse_abs": TOL_LSE}, ms=ms,
            ms_back_to_back=ms_b2b, host_ms=wrapper_ms,
            plain_ms=plain_ms, plain=KERNELS[kname][0], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, library_ms_back_to_back=lib_b2b,
            library_call=("scaled_dot_product_attention(is_causal=True)"
                          if kname == "fwd" else
                          "scaled_dot_product_attention backward: dq, dk and dv together"),
        )
    bwd_host = host_ms(lambda: fa._bwd_kernel(*args, **opts))
    print(f"host: the backward's two launches (inputs checked once) {bwd_host:.4f} ms a "
          f"call, against {results['bwd_dq']['host_ms'] + results['bwd_dkv']['host_ms']:.4f} "
          f"ms for the two wrappers called one after the other")
    return results


class Run:
    """One model trained by the ``Trainer`` on one placed synthetic batch
    (made with numpy from ``seed``): `start` builds it, `timed` runs it."""

    def __init__(self, label: str, model, config, batch_size: int, device, seed: int = 0):
        import numpy as np

        from edl_tpu_torch.runtime import Trainer

        self.label, self.model, self.config = label, model, config
        self.batch_size, self.device = batch_size, device
        self.trainer = Trainer(model, device=device, config=config)
        self.state = self.trainer.init_state()
        self.host_batch = model.synthetic_batch(np.random.default_rng(seed), batch_size)
        self.batch = self.trainer.place_batch(self.host_batch)

    def step(self) -> None:
        import torch

        self.state, _ = self.trainer.train_step(self.state, self.batch)
        torch.cuda.synchronize()

    def timed(self, reset_counts=None) -> dict:
        """``WARMUP_STEPS`` steps, then ``STEPS`` timed steps (host clock around
        each step and a synchronise), peak memory over the timed steps.
        ``reset_counts`` runs just before the timed steps. Requires a finite,
        falling loss; prints and returns the zoo row."""
        import torch

        from edl_tpu_torch.tools.mfu import mfu_fields

        for _ in range(WARMUP_STEPS):
            self.state, loss = self.trainer.train_step(self.state, self.batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.device)
        allocs = torch.cuda.memory_stats(self.device).get("num_device_alloc", 0)
        if reset_counts is not None:
            reset_counts()
        losses, step_s = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            self.state, loss = self.trainer.train_step(self.state, self.batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        require(all(math.isfinite(x) for x in losses), f"{self.label}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{self.label}: loss did not fall: {losses}")
        # cudaMalloc calls of the caching allocator in the timed steps
        allocs = torch.cuda.memory_stats(self.device).get("num_device_alloc", 0) - allocs
        step = statistics.median(step_s)
        acc = mfu_fields(self.model, self.batch_size, 1.0 / step, device=self.device)
        n_params = sum(p.numel() for p in self.state.params.parameters())
        cfg = self.config
        self.row = dict(
            name=self.label, model=self.model.name, params=n_params, batch=self.batch_size,
            optimizer=cfg.optimizer, learning_rate=cfg.learning_rate, steps=STEPS,
            step_ms=step * 1e3, samples_per_s=self.batch_size / step,
            model_flops=acc["model_flops"], tflops_per_sec=acc["tflops_per_sec"],
            mfu=acc["mfu"], peak_tflops=acc["peak_tflops"],
            peak_memory_gib=torch.cuda.max_memory_allocated(self.device) / 2**30,
            device_allocs_in_timed_steps=allocs, losses=losses, loss_first=losses[0],
            loss_last=losses[-1])
        print(f"{self.label}: {n_params / 1e6:.2f} M params, batch {self.batch_size}, "
              f"{cfg.optimizer} lr {cfg.learning_rate}: step {step * 1e3:.3f} ms (median of "
              f"{STEPS}), {self.batch_size / step:.0f} samples/s, MFU "
              + (f"{acc['mfu']:.5f} of {acc['peak_tflops']:.0f} TFLOP/s"
                 if acc["mfu"] is not None else "not measured (no peak for this card)")
              + f" ({acc['tflops_per_sec']:.3f} TFLOP/s), peak memory "
              f"{self.row['peak_memory_gib']:.3f} GiB ({allocs} cudaMalloc in the timed steps), "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        return self.row

    def profile(self, groups: dict) -> list:
        """One more step under the profiler (`profile_step`); its busy share
        and top device ops go into the row. Returns the kernel events."""
        kernels, summary = profile_step(self.step, self.row["step_ms"], groups, self.label)
        self.row.update(summary)
        return kernels


def phase_slice(device) -> tuple:
    """Train the GPT-2-small-width LM through the Trainer; returns the launch
    counts of the timed steps, the profiled step's device ms a launch of each
    flash kernel, the zoo row and the trained state."""
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    cfg = TransformerConfig(flash=True, **SLICE)
    run = Run("transformer", make_model(cfg), TrainerConfig(
        optimizer="adam", learning_rate=3e-4, seed=0), BATCH, device)
    row = run.timed(reset_counts=fa.reset_launches)
    launches = dict(fa.LAUNCHES)
    want = cfg.n_layers * STEPS
    require(all(n == want for n in launches.values()),
            f"launch counts {launches}, want {want} each (12 layers x {STEPS} steps)")
    print(f"slice: batch {BATCH} x {cfg.seq_len}, {BATCH * cfg.seq_len / row['step_ms'] * 1e3:.0f} "
          f"tokens/s, launches {launches}")
    kernels = run.profile(LM_GROUPS)
    in_step = {}
    for kname, (fn, _) in DESIGNS.items():
        hits = [e for e in kernels if fn in e.key]
        n = sum(e.count for e in hits)
        if n:
            in_step[kname] = sum(e.self_device_time_total for e in hits) / 1e3 / n
    print("profile: flash kernels' device ms a launch in the step: " + ", ".join(
        f"{k} {ms:.4f}" for k, ms in in_step.items()))
    row.update(config="GPT-2-small width " + json.dumps(SLICE), remat=False, launches=launches)
    return launches, in_step, row, run.state


#: kernel groups of the profile, by a substring of the kernel's name, first
#: match wins
LM_GROUPS = {
    "flash attention kernels": FLASH_NAMES,
    "f32 matmuls (TF32 off)": ("sgemm", "f32f32_f32f32"),
    "bf16 matmuls": ("gemm", "xmma", "cutlass", "nvjet"),
}
ZOO_GROUPS = {
    "table lookup (gather, sort, segment sums)": (
        "embedding", "indexing", "index_select", "gather", "sum_and_scatter",
        "compute_grad_weight", "partial_segment", "radixsort"),
    "convolutions (cuDNN, layout changes included)": (
        "conv", "wgrad", "dgrad", "fprop", "winograd", "nchwtonhwc", "nhwctonchw",
        "nhwcaddpadding"),
    "matmuls": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "dot_kernel"),
    "group norm": ("rowwisemoments", "computeinternalgradients", "gammabeta",
                   "groupnorm", "group_norm"),
    "dtype casts and copies": ("copy_kernel",),
    "foreach optimizer updates": ("multi_tensor_apply",),
}


def profile_step(step, step_ms: float, groups: dict, label: str) -> tuple:
    """Where one step's device time goes, by CUDA kernel (torch.profiler),
    and the device's busy share: of the profiled step's own wall time (the
    profiler slows the host) and of the median unprofiled step ``step_ms``.
    Returns (the kernel events, empty if not measured; the summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side user annotations (Optimizer.step#...) span kernels counted
    # on their own, so only real kernels are summed
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print(f"profile {label}: device time not measured (the profiler saw no CUDA kernel)")
        return [], {"device_busy_share": None, "top_device_ops": None}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups.items() if any(k in name for k in keys)),
                     "other")
        by_group[group] += e.self_device_time_total
    busy = total_us / 1e3 / step_ms
    print(f"profile {label}: one step, {total_us / 1e3:.3f} ms of kernels, "
          f"{sum(e.count for e in kernels)} launches; device busy "
          f"{total_us / 1e3 / wall_ms:.1%} of this step's {wall_ms:.3f} ms, "
          f"{busy:.1%} of the median step; " + ", ".join(
              f"{g} {us / 1e3:.3f} ms ({us / total_us:.1%})" for g, us in by_group.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_OPS]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")
    return kernels, {
        "device_kernel_ms": total_us / 1e3, "device_busy_share": busy,
        "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
        "top_device_ops": [{"op": e.key[:110], "ms": e.self_device_time_total / 1e3,
                            "count": e.count} for e in top]}


def phase_ctr(device) -> tuple:
    """The slice's main path: CTR at its full published width through the
    Trainer with adagrad; padded and untouched table rows must not move.
    Returns the zoo row and the run."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    t0 = time.perf_counter()
    run = Run("ctr", ctr.MODEL, TrainerConfig(optimizer="adagrad", learning_rate=0.05,
                                              seed=0), CTR_BATCH, device)
    module = run.state.params
    setup_s = time.perf_counter() - t0
    # rows no id of the batch reaches: the padded ones, and a sample of real ones
    seen = np.unique(run.host_batch["sparse"])
    unseen = np.setdiff1d(np.arange(ctr.SPARSE_DIM), seen)
    sample = torch.from_numpy(np.random.default_rng(1).choice(unseen, UNTOUCHED_ROWS,
                                                              replace=False)).to(device)
    tables = {name: getattr(module, name) for name in ("deep_table", "wide_table")}
    before = {name: (t[ctr.SPARSE_DIM:].detach().clone(), t[sample].detach().clone())
              for name, t in tables.items()}
    row = run.timed(reset_counts=fa.reset_launches)
    flash_launches = dict(fa.LAUNCHES)
    for name, t in tables.items():
        require(t.shape[0] == CTR_PADDED_ROWS, f"{name} has {t.shape[0]} rows, want "
                                               f"{CTR_PADDED_ROWS}")
        pad, untouched = before[name]
        require(torch.equal(t[ctr.SPARSE_DIM:].detach(), pad),
                f"padded rows of {name} changed in training")
        require(torch.equal(t[sample].detach(), untouched),
                f"rows of {name} that no id reaches changed in training")
    print(f"ctr: tables of {CTR_PADDED_ROWS} rows (sparse dim {ctr.SPARSE_DIM}), "
          f"{len(seen)} distinct ids in the batch of {CTR_BATCH} x {ctr.NUM_SPARSE}; "
          f"after {WARMUP_STEPS + STEPS} steps the {CTR_PADDED_ROWS - ctr.SPARSE_DIM} padded "
          f"rows and {UNTOUCHED_ROWS} sampled rows no id reaches are bit for bit unchanged "
          f"in both tables; set-up {setup_s:.2f} s; flash launches {flash_launches}")
    run.profile(ZOO_GROUPS)
    row["table_backward_ms"] = time_table_backward(module.deep_table, run.batch["sparse"])
    row.update(config=f"sparse dim {ctr.SPARSE_DIM} (tables {CTR_PADDED_ROWS} x "
                      f"{ctr.EMBED_DIM} and x 1), MLP {list(ctr.HIDDEN)}",
               distinct_ids=int(len(seen)), padded_rows_unchanged=True,
               untouched_rows_checked=UNTOUCHED_ROWS, flash_launches=flash_launches)
    return row, run


def time_table_backward(table, ids) -> dict:
    """The deep table's lookup at the step's ids, forward and backward to a
    dense table gradient, by each route PyTorch offers (CUDA events, one
    call at a time): the port's ``F.embedding``, ``table[ids]`` (index_put
    with accumulate) and `dedup_gather` (sort, segment-sum, one
    ``index_add_`` a row). Each gradient must agree with the port's."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.parallel.embedding import dedup_gather

    t = table.detach().requires_grad_()
    cot = torch.randn(ids.shape + (t.shape[1],), generator=torch.Generator(
        device=t.device).manual_seed(3), device=t.device)
    routes = {
        "F.embedding (the port's)": lambda: torch.autograd.grad(F.embedding(ids, t), t, cot),
        "table[ids]": lambda: torch.autograd.grad(t[ids], t, cot),
        "dedup_gather": lambda: torch.autograd.grad(
            dedup_gather(t, ids.reshape(-1)), t, cot.reshape(-1, t.shape[1])),
    }
    (want,) = routes["F.embedding (the port's)"]()
    out = {}
    for name, fn in routes.items():
        (got,) = fn()
        err = ((got - want).norm() / want.norm()).item()
        require(err <= 1e-5, f"the table gradient through {name} is off the port's by {err:.3e}")
        out[name] = time_ms(fn, reps=10, warmup=2)
    print(f"ctr table lookup, forward and backward ({ids.numel()} ids into {t.shape[0]} x "
          f"{t.shape[1]}): " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in out.items()))
    return out


def phase_ctr_cpu_parity(device) -> dict:
    """CTR at full table width on the card against the port on the CPU: the
    same state_dict and batch, the loss, and each param's update after one
    adagrad step."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    cfg = TrainerConfig(optimizer="adagrad", learning_rate=0.05)
    host_batch = ctr.MODEL.synthetic_batch(np.random.default_rng(1), PARITY_BATCH)
    runs = {}
    for where in ("cuda", "cpu"):
        trainer = Trainer(ctr.MODEL, device=device if where == "cuda" else "cpu", config=cfg)
        state = trainer.init_state(torch.Generator().manual_seed(1))
        if where == "cpu":
            state.params.load_state_dict(runs["cuda"]["init"])
        init = {k: v.detach().cpu().clone() for k, v in state.params.state_dict().items()}
        state, loss = trainer.train_step(state, trainer.place_batch(host_batch))
        runs[where] = dict(init=init, loss=float(loss), after={
            k: v.detach().cpu() for k, v in state.params.state_dict().items()})
    gpu, cpu = runs["cuda"], runs["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    errs = {}
    for name, want in cpu["after"].items():
        step_cpu, step_gpu = want - cpu["init"][name], gpu["after"][name] - gpu["init"][name]
        errs[name] = ((step_gpu - step_cpu).norm() / step_cpu.norm()).item()
    worst = max(errs, key=errs.get)
    print(f"ctr card vs CPU (batch {PARITY_BATCH}, tables {CTR_PADDED_ROWS} rows): loss card "
          f"{gpu['loss']:.7f} CPU {cpu['loss']:.7f} (rel {loss_rel:.3e}, tolerance "
          f"{TOL_CTR_LOSS}); one adagrad step's update, rel norm err: " + ", ".join(
              f"{n} {e:.3e}" for n, e in errs.items()) + f" (tolerance {TOL_CTR_UPDATE})")
    require(loss_rel <= TOL_CTR_LOSS, f"CTR loss on the card off the CPU's by {loss_rel:.3e}")
    require(all(math.isfinite(e) and e <= TOL_CTR_UPDATE for e in errs.values()),
            f"CTR updates on the card off the CPU's: {errs}")
    return {"batch": PARITY_BATCH, "loss_rel": loss_rel, "loss_tolerance": TOL_CTR_LOSS,
            "update_rel_norm": errs, "worst": worst, "update_tolerance": TOL_CTR_UPDATE}


def phase_zoo(device) -> list:
    """The other four models at their default widths, each on one placed
    batch through the Trainer."""
    from edl_tpu_torch import models
    from edl_tpu_torch.runtime import TrainerConfig

    rows = []
    for name, (batch, optimizer, lr) in ZOO.items():
        model = models.get(name)
        run = Run(name, model, TrainerConfig(optimizer=optimizer, learning_rate=lr, seed=0),
                  batch, device)
        row = run.timed()
        run.profile(ZOO_GROUPS)
        row["config"] = (json.dumps(dataclasses.asdict(model.config)) if model.config
                         else "default")
        rows.append(row)
        # free this model before the next is built: a run's peak memory
        # starts from what is still allocated when its timed steps begin
        del run
    return rows


def phase_remat(device, off: dict) -> dict:
    """The LM of phase 4 with ``remat=True``, from the same seed and batch:
    the same losses, less memory, and the flash forward run twice a block."""
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    cfg = TransformerConfig(flash=True, remat=True, **SLICE)
    run = Run("transformer (remat)", make_model(cfg), TrainerConfig(
        optimizer="adam", learning_rate=3e-4, seed=0), BATCH, device)
    row = run.timed(reset_counts=fa.reset_launches)
    launches = dict(fa.LAUNCHES)
    want = {"fwd": 2 * cfg.n_layers * STEPS, "bwd_dq": cfg.n_layers * STEPS,
            "bwd_dkv": cfg.n_layers * STEPS}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], off["losses"]))
    print(f"remat: step {row['step_ms']:.3f} ms against {off['step_ms']:.3f} ms without remat "
          f"({row['step_ms'] / off['step_ms'] - 1:+.1%}); peak memory "
          f"{row['peak_memory_gib']:.3f} against {off['peak_memory_gib']:.3f} GiB; losses "
          f"within {loss_rel:.3e} rel of the remat-off run's (tolerance {TOL_REMAT_LOSS}); "
          f"launches {launches}, want {want}")
    require(launches == want, f"remat launch counts {launches}, want {want}")
    require(row["peak_memory_gib"] < off["peak_memory_gib"],
            "remat does not lower the peak memory")
    require(loss_rel <= TOL_REMAT_LOSS, f"remat losses off the remat-off run's by {loss_rel:.3e}")
    run.profile(LM_GROUPS)
    row.update(config="GPT-2-small width " + json.dumps(SLICE), remat=True,
               launches=launches, loss_rel_to_remat_off=loss_rel,
               step_ms_remat_off=off["step_ms"], peak_memory_gib_remat_off=off["peak_memory_gib"])
    return row


def phase_step_parity(device) -> None:
    """One step at depth 2 through the kernels and through dense attention."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model

    cfg = TransformerConfig(flash=True, **{**SLICE, "n_layers": 2})
    model = make_model(cfg)
    kern = model.build(device=device, generator=torch.Generator().manual_seed(1))
    plain = make_model(dataclasses.replace(cfg, flash=False)).build(
        device=device, generator=torch.Generator().manual_seed(2))
    plain.load_state_dict(kern.state_dict())
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in model.synthetic_batch(np.random.default_rng(1), BATCH).items()}
    losses = []
    for module in (kern, plain):
        loss = module(batch)
        loss.backward()
        losses.append(loss.item())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    grads = {}
    for (name, pk), (_, pp) in zip(kern.named_parameters(), plain.named_parameters()):
        grads[name] = ((pk.grad - pp.grad).norm() / pp.grad.norm()).item()
    worst = max(grads, key=grads.get)
    print(f"step parity (depth 2): loss kernel {losses[0]:.6f} plain {losses[1]:.6f} "
          f"(rel {rel:.3e}); worst grad {worst} rel norm err {grads[worst]:.3e}")
    require(rel <= TOL_STEP_LOSS, f"depth-2 loss off by {rel:.3e}")
    require(all(math.isfinite(e) and e <= TOL_STEP_GRAD for e in grads.values()),
            f"depth-2 grads off: {grads}")


# -- the serve phase -----------------------------------------------------------

#: the LM tier at GPT-2-small width (phase 4's LM): batch and seq buckets, and
#: a KV pool of 1024 blocks of 16 tokens (604 MB at 36,864 B a token: room for
#: 16 streams at 1024)
SERVE_BATCH_BUCKETS = (1, 4, 8)
SERVE_SEQ_BUCKETS = (128, 256, 512, 1024)
SERVE_KV_BLOCKS, SERVE_KV_BLOCK_TOKENS = 1024, 16
#: 16 streams from seed 0 (prompts of 16-512 tokens, 32-64 new tokens),
#: admitted in waves of 6, 5 and 5 (each wave once the one before decodes);
#: the last 4 through HTTP /generate
SERVE_PROMPT_TOKENS = (16, 512)
SERVE_NEW_TOKENS = (32, 64)
SERVE_WAVES = (6, 5, 5)
SERVE_HTTP_STREAMS = 4
#: streams held against a re-prefill per token on the card (the first 4), and
#: against the port's prefill on the CPU (the 2 shortest prompts)
CONSISTENCY_STREAMS = 4
CPU_STREAMS = 2
#: the engine's K/V cache against the prefill's K/V of the same sequence
#: (relative norm): decode and prefill round their bf16 activations at the
#: same places but sum the f32 attention in another order
TOL_SERVE_KV = 1e-2
#: a greedy token may differ from its reference (teacher forced on the same
#: tokens) only where the reference's top logit exceeds the token's logit by
#: at most this many logit units: a near tie that rounding noise may flip.
#: Twice the largest difference of the card's and the CPU's logits over the
#: same sequences (0.028 of logits up to 3.5 in a first run on an H100): a
#: flip needs both logits to move toward each other
TOL_NEAR_TIE = 6e-2
#: timed shapes: prefill (batch, seq) and decode (batch, capacity)
PREFILL_TIMED = ((1, 128), (8, 512))
DECODE_TIMED = ((1, 256), (1, 1024), (8, 256), (8, 1024))
#: the profiled window of the live engine: decode steps at the largest
#: buckets (8, capacity 1024), from 8 streams of PROFILE_PROMPT tokens and 64
#: new tokens each
PROFILE_DECODE_STEPS = 16
PROFILE_PROMPT = 700
PROFILE_NEW_TOKENS = 64
#: the batch tier: CTR at full width, 512 single-row requests from seed 5 by
#: 32 client threads; every 32nd through HTTP /predict; version 2 exported
#: once 128 are answered, and the last 128 sent once it serves
CTR_SERVE_BUCKETS = (1, 8, 32, 256)
CTR_REQUESTS = 512
CTR_HTTP_EVERY = 32
CTR_SWAP_AFTER = 128
CTR_POST_SWAP = 128
CTR_CLIENTS = 32
#: a served answer against the module's predict on all 512 rows at once
#: (cuBLAS picks other kernels at other batch sizes; the MLP is bf16):
#: `tests/test_torch_ctr.py`'s logit tolerance, |d| <= abs + rel * |want|
TOL_CTR_SERVE_ABS, TOL_CTR_SERVE_REL = 2e-3, 2e-2
#: the share of rows whose version-1 and version-2 answers lie outside each
#: other's tolerance must be at least this, or the swap check has no teeth
#: (an answer of version 1 on such a row fails the check against version 2)
CTR_VERSIONS_APART = 0.5


def wait_for(cond, timeout_s: float, msg: str) -> None:
    """Poll ``cond`` every 5 ms (a cheap read: the engine and the dispatcher
    share the interpreter with this thread) until it holds."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        require(time.monotonic() < deadline, msg)
        time.sleep(0.005)


def _post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _quantiles(xs) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "n": len(xs)}


def export_lm(state, root: str) -> dict:
    """Export phase 4's trained LM with the port's ``save_inference_model``
    (versioned), as a trainer publishes for a serving replica."""
    import os

    from edl_tpu_torch.runtime.export import save_inference_model

    directory = os.path.join(root, "lm")
    t0 = time.perf_counter()
    save_inference_model(directory, "transformer", state, config={**SLICE, "flash": True},
                         step=state.step, versioned=True)
    seconds = time.perf_counter() - t0
    print(f"serve: exported phase 4's LM (step {state.step}) in {seconds:.3f} s")
    return {"dir": directory, "step": state.step, "export_s": seconds}


def stage_ctr_versions(run, root: str) -> dict:
    """Export phase 6's CTR as version 1 (versioned layout), then take two
    more adagrad steps on new batches: version 2, kept on the host for the
    serve phase to export mid-traffic. Both versions' state_dicts are kept on
    the host as the references of the answers."""
    import os

    import numpy as np

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime.export import save_inference_model

    directory = os.path.join(root, "ctr")

    def host_state():
        return {k: v.detach().cpu().clone() for k, v in run.state.params.state_dict().items()}

    t0 = time.perf_counter()
    save_inference_model(directory, "ctr", run.state, step=run.state.step, versioned=True)
    seconds = time.perf_counter() - t0
    v1 = {"step": run.state.step, "state": host_state()}
    for seed in (11, 12):
        batch = run.trainer.place_batch(ctr.MODEL.synthetic_batch(np.random.default_rng(seed),
                                                                  CTR_BATCH))
        run.state, _ = run.trainer.train_step(run.state, batch)
    v2 = {"step": run.state.step, "state": host_state()}
    print(f"serve: exported phase 6's CTR as version 1 (step {v1['step']}) in {seconds:.3f} s; "
          f"version 2 is step {v2['step']}")
    return {"dir": directory, 1: v1, 2: v2, "export_s": seconds}


def _teacher_forced(module, prompts, generated) -> list:
    """The reference of each stream's greedy tokens: for token j, the
    prefill of prompt + generated[:j] (the streams of a step batched, right
    padded to a seq bucket), its f32 logits at the last position. Returns per
    stream (logits (n, V), and K and V (L, len, H, Dh) of its last prefill,
    which covers every cached position)."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.serving.batcher import pad_token_rows, pick_seq_bucket

    out = [{"logits": []} for _ in prompts]
    device = module.embed.device
    for j in range(max(len(g) for g in generated)):
        live = [i for i, g in enumerate(generated) if j < len(g)]
        seqs = [np.concatenate([prompts[i], np.asarray(generated[i][:j], np.int32)])
                for i in live]
        seq_bucket = pick_seq_bucket(max(len(q) for q in seqs), SERVE_SEQ_BUCKETS)
        tokens, lengths = pad_token_rows(seqs, len(seqs), seq_bucket)
        with torch.no_grad():
            x, k, v = transformer._prefill_forward(module, torch.from_numpy(tokens).to(device))
            last = torch.from_numpy(lengths.astype(np.int64) - 1).to(device)
            h = x[torch.arange(len(live), device=device), last]
            logits = transformer._rmsnorm(h, module.lnf).float() @ module.head
        for r, i in enumerate(live):
            out[i]["logits"].append(logits[r])
            if j == len(generated[i]) - 1:
                out[i]["k"] = k[:, r, :lengths[r]]
                out[i]["v"] = v[:, r, :lengths[r]]
    for o in out:
        o["logits"] = torch.stack(o["logits"])
    return out


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _token_check(logits, tokens) -> dict:
    """Greedy ``tokens`` against reference ``logits`` (n, V): the positions
    where they differ, and the reference's margin there (its top logit less
    the token's)."""
    import torch

    t = torch.as_tensor(tokens, device=logits.device)
    top = logits.max(dim=-1).values
    margin = top - logits.gather(1, t[:, None].long())[:, 0]
    differ = logits.argmax(dim=-1) != t
    return {"positions": len(tokens), "differ": int(differ.sum()),
            "worst_margin": float(margin[differ].max()) if differ.any() else 0.0}


def check_cache_consistency(replica, prompts, budgets) -> dict:
    """The engine's decode against a re-prefill of the grown sequence per
    token on the card: tokens (near ties allowed) and the stream's K/V cache
    against the last prefill's K/V. Then the same streams with the planted
    fault — the new K/V written one slot late — which the check must reject."""
    import contextlib
    from unittest import mock

    from edl_tpu_torch.serving import LMServingReplica

    caches = {}
    retire = LMServingReplica._retire

    def capturing(self, s, outcome):
        caches[s.id] = (s.k[:, :s.length].clone(), s.v[:, :s.length].clone())
        retire(self, s, outcome)

    def one_slot_late(s, k, v):
        s.k[:, s.length + 1] = k
        s.v[:, s.length + 1] = v

    def run(fault: bool) -> dict:
        caches.clear()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(LMServingReplica, "_retire", capturing))
            if fault:
                stack.enter_context(mock.patch.object(LMServingReplica, "_append_kv",
                                                      staticmethod(one_slot_late)))
            handles = [replica.submit(p, max_new_tokens=int(b)) for p, b in zip(prompts, budgets)]
            outs = []
            for h in handles:
                try:
                    outs.append(h.result(timeout=600))
                except (RuntimeError, IndexError) as e:  # the fault may write past the cache
                    return {"ok": False, "raised": repr(e)}
        generated = [o["tokens"] for o in outs]
        refs = _teacher_forced(replica._art.module, prompts, generated)
        streams = []
        for prompt, h, g, ref in zip(prompts, handles, generated, refs):
            k, v = caches[h.stream_id]
            kv = {"k": _rel(k, ref["k"]), "v": _rel(v, ref["v"])}
            streams.append({"prompt_tokens": len(prompt), **_token_check(ref["logits"], g),
                            "kv_rel_norm": kv})
        ok = all(s["worst_margin"] <= TOL_NEAR_TIE and max(s["kv_rel_norm"].values()) <= TOL_SERVE_KV
                 for s in streams)
        return {"ok": ok, "streams": streams}

    good = run(fault=False)
    fault = run(fault=True)
    print(f"serve cache check ({len(prompts)} streams against a re-prefill per token): "
          f"{json.dumps(good)}; with the K/V written one slot late: {json.dumps(fault)}")
    require(good["ok"], f"the engine's decode is off a re-prefill per token: {good}")
    require(not fault["ok"], "the cache check passes the planted one-slot-late fault")
    return {"as_built": good, "kv_one_slot_late": fault}


def _lm_traffic(replica, prompts, budgets) -> dict:
    """The 16 streams in staggered waves; returns their results (by index),
    the wall time, and each direct stream's submit time and id."""
    from concurrent.futures import ThreadPoolExecutor

    n, first_http = len(prompts), len(prompts) - SERVE_HTTP_STREAMS
    handles, http, submitted = {}, {}, {}

    def emitted():
        return sum(replica.instruments.tokens.value(phase=p) for p in ("prefill", "decode"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVE_HTTP_STREAMS) as pool:
        i = 0
        for w, size in enumerate(SERVE_WAVES):
            before = emitted()
            for j in range(i, min(i + size, n)):
                if j >= first_http:
                    http[j] = pool.submit(_post, replica.url + "/generate", {
                        "prompt": prompts[j].tolist(), "max_new_tokens": int(budgets[j])})
                else:
                    submitted[j] = time.time()
                    handles[j] = replica.submit(prompts[j], max_new_tokens=int(budgets[j]))
            i += size
            if w < len(SERVE_WAVES) - 1:
                # the next wave joins a decode batch that is already running
                wait_for(lambda: emitted() >= before + 4 * size, 600, f"wave {w} never decoded")
        results = {j: h.result(timeout=600) for j, h in handles.items()}
        results.update({j: f.result(timeout=600) for j, f in http.items()})
    return {"results": [results[j] for j in range(n)], "wall_s": time.perf_counter() - t0,
            "submitted": submitted, "ids": {j: h.stream_id for j, h in handles.items()}}


def _device_ms(fn) -> tuple:
    """(device kernel ms, launches) of one call of ``fn`` under
    ``torch.profiler``, after a warm-up call; (None, None) when the profiler
    sees no CUDA kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        return None, None
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def time_lm_steps(module, cfg, device) -> dict:
    """One prefill and one decode step at the timed shapes: the time of one
    call at a time (CUDA events, so the host's launches show in it), and
    the device's kernel time and launches in one profiled call. Decode runs
    on a full cache of random K/V."""
    import torch

    from edl_tpu_torch.models import transformer

    prefill = transformer.make_prefill_step(cfg)
    decode = transformer.make_decode_step(cfg)
    gen = torch.Generator(device=device).manual_seed(4)
    L, H, Dh = transformer.lm_cache_shape(cfg)
    calls = {}
    for b, s in PREFILL_TIMED:
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                               dtype=torch.int32)
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        calls[f"prefill_{b}x{s}"] = lambda t=tokens, n=lengths: prefill(module, t, n)
    for b, c in DECODE_TIMED:
        k, v = (torch.randn((L, b, c, H, Dh), generator=gen, device=device).to(torch.bfloat16)
                for _ in range(2))
        tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device,
                               dtype=torch.int32)
        lengths = torch.full((b,), c - 1, dtype=torch.int32, device=device)
        calls[f"decode_{b}x{c}"] = lambda k=k, v=v, t=tokens, n=lengths: decode(module, k, v, t, n)
    out = {}
    for name, fn in calls.items():
        kernel_ms, launches = _device_ms(fn)
        out[name] = {"ms": time_ms(fn, reps=10, warmup=2), "device_kernel_ms": kernel_ms,
                     "launches": launches}
    print("serve step times (one call at a time; device kernel ms and launches of one call): "
          + ", ".join(f"{name} {r['ms']:.4f} ms ({r['device_kernel_ms']} ms, {r['launches']})"
                      for name, r in out.items()))
    return out


def profile_decode_window(replica, cfg) -> dict:
    """``torch.profiler`` over PROFILE_DECODE_STEPS decode steps of the live
    engine at the largest buckets (8, capacity 1024): device busy share and
    launches a step. The busy share is also given against the median
    unprofiled step of the same streams (the engine's spans after the
    window)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    bucket, capacity = SERVE_BATCH_BUCKETS[-1], SERVE_SEQ_BUCKETS[-1]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, PROFILE_PROMPT).astype(np.int32)
               for _ in range(bucket)]
    handles = [replica.submit(p, max_new_tokens=PROFILE_NEW_TOKENS) for p in prompts]

    def steps():
        return replica.instruments.decode_steps.value(bucket=str(bucket),
                                                      seq_bucket=str(capacity))

    wait_for(lambda: steps() >= 2, 600, "the profiled streams never decoded")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c0, t0 = steps(), time.perf_counter()
        wait_for(lambda: steps() >= c0 + PROFILE_DECODE_STEPS, 600, "decode stalled")
        wall_ms, n = (time.perf_counter() - t0) * 1e3, steps() - c0
    t_end = time.time()
    for h in handles:
        h.result(timeout=600)
    spans = [sp.seconds * 1e3 for sp in replica.tracer.find(name="lm_decode_step")
             if sp.start > t_end and sp.attrs.get("bucket") == bucket
             and sp.attrs.get("seq_bucket") == capacity]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print("serve profile: device time not measured (the profiler saw no CUDA kernel)")
        return {"device_busy_share": None, "launches_per_step": None}
    launches = sum(e.count for e in kernels)
    step_ms = statistics.median(spans) if spans else None
    out = {"steps": n, "window_ms": wall_ms, "kernel_ms_per_step": total_us / 1e3 / n,
           "launches_per_step": launches / n,
           "device_busy_share": total_us / 1e3 / wall_ms,
           "unprofiled_step_ms": step_ms,
           "device_busy_share_unprofiled": (total_us / 1e3 / n / step_ms) if step_ms else None,
           "top_device_ops": [{"op": e.key[:110], "ms_per_step": e.self_device_time_total / 1e3 / n,
                               "count_per_step": e.count / n}
                              for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_OPS]]}
    print(f"serve profile: {n} decode steps at bucket {bucket}, capacity {capacity}: "
          f"{out['kernel_ms_per_step']:.4f} ms of kernels and {out['launches_per_step']:.1f} "
          f"launches a step; device busy {out['device_busy_share']:.1%} of the profiled "
          f"window" + (f", {out['device_busy_share_unprofiled']:.1%} of the median unprofiled "
                       f"step ({step_ms:.4f} ms)" if step_ms else ""))
    for op in out["top_device_ops"]:
        print(f"  {op['ms_per_step']:8.4f} ms x{op['count_per_step']:<6.1f} {op['op']}")
    return out


def check_card_against_cpu(lm_dir, card_module, prompts, generated) -> dict:
    """The card's greedy tokens of the given streams, teacher forced through
    the port's prefill on the CPU from the same artifact: a token may differ
    only at a near tie of the CPU's logits. Also the largest difference of
    the card's and the CPU's logits over the same sequences."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.runtime.export import load_inference_model

    cpu = load_inference_model(lm_dir, device="cpu").module
    out = []
    for prompt, g in zip(prompts, generated):
        seq = torch.from_numpy(np.concatenate([prompt, np.asarray(g[:-1], np.int32)]))[None]
        cpu_logits = transformer.prefill_logits(cpu, seq)[0, len(prompt) - 1:]
        card_logits = transformer.prefill_logits(card_module, seq.to(card_module.embed.device))
        card_logits = card_logits[0, len(prompt) - 1:].cpu()
        out.append({"prompt_tokens": len(prompt), **_token_check(cpu_logits, g),
                    "max_abs_logit_diff": float((card_logits - cpu_logits).abs().max()),
                    "max_abs_logit": float(cpu_logits.abs().max())})
    ok = all(s["worst_margin"] <= TOL_NEAR_TIE for s in out)
    print(f"serve card vs CPU ({len(out)} streams, teacher forced): {json.dumps(out)}; "
          f"near-tie positions {sum(s['differ'] for s in out)} (tolerance {TOL_NEAR_TIE})")
    require(ok, f"the card's tokens are off the CPU's beyond near ties: {out}")
    return {"streams": out, "near_tie_positions": sum(s["differ"] for s in out),
            "tolerance": TOL_NEAR_TIE}


def serve_lm(device, lm: dict) -> dict:
    """The LM tier on the card (see phase 10 in the module docstring)."""
    import numpy as np
    import torch

    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
    from edl_tpu_torch.obs.tracing import Tracer
    from edl_tpu_torch.serving import LMServingConfig, LMServingReplica
    from edl_tpu_torch.serving.__main__ import REQUIRED_LM_FAMILIES

    fa = _flash_module()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    replica = LMServingReplica(LMServingConfig(
        model_dir=lm["dir"], batch_buckets=SERVE_BATCH_BUCKETS, seq_buckets=SERVE_SEQ_BUCKETS,
        kv_blocks=SERVE_KV_BLOCKS, kv_block_tokens=SERVE_KV_BLOCK_TOKENS, port=0,
        name="chip-lm", request_timeout_s=600.0, device=str(device)),
        registry=MetricsRegistry(), tracer=Tracer(component="serving")).start()
    start_s = time.perf_counter() - t0
    try:
        cfg, module = replica._model_cfg, replica._art.module
        n = sum(SERVE_WAVES)
        rng = np.random.default_rng(0)
        plens = rng.integers(SERVE_PROMPT_TOKENS[0], SERVE_PROMPT_TOKENS[1] + 1, n)
        budgets = rng.integers(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, n)
        prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32) for k in plens]
        fa.reset_launches()
        traffic = _lm_traffic(replica, prompts, budgets)
        flash_launches = dict(fa.LAUNCHES)
        # the JAX package's serving path runs dense f32 attention, not flash
        require(not any(flash_launches.values()),
                f"the serving path launched flash kernels: {flash_launches}")
        results = traffic["results"]
        short = [j for j, r in enumerate(results)
                 if len(r["tokens"]) != budgets[j] or r["finish_reason"] != "length"]
        require(not short, f"LM streams {short} ended short of their token counts")
        unwarmed = replica.jit_cache_size()
        require(unwarmed == 0, f"{unwarmed} LM dispatch shapes were not warmed")
        families = parse_prometheus(scrape_metrics(replica.url))
        missing = [f for f in REQUIRED_LM_FAMILIES if f not in families]
        require(not missing, f"missing LM metric families: {missing}")
        status = replica.status()
        require(status["completed"] == n and status["rejected"] == 0
                and status["kv"]["used_blocks"] == 0, f"LM replica status: {status}")
        prefill_end = {sp.attrs["stream"]: sp.end for sp in replica.tracer.find(name="lm_prefill")}
        ttft = [prefill_end[traffic["ids"][j]] - t for j, t in traffic["submitted"].items()]
        decode_spans = {}
        for sp in replica.tracer.find(name="lm_decode_step"):
            key = f"{sp.attrs['bucket']}x{sp.attrs['seq_bucket']}"
            decode_spans.setdefault(key, []).append(sp.seconds * 1e3)
        tokens = sum(len(r["tokens"]) for r in results)
        row = {"streams": n, "http_streams": SERVE_HTTP_STREAMS, "waves": list(SERVE_WAVES),
               "prompt_tokens": plens.tolist(), "new_tokens": budgets.tolist(),
               "start_s": start_s, "export_s": lm["export_s"], "artifact_step": lm["step"],
               "tokens": tokens, "wall_s": traffic["wall_s"],
               "tokens_per_s": tokens / traffic["wall_s"],
               "ttft_s": _quantiles(ttft),
               "engine_decode_step_ms": {k: _quantiles(v) for k, v in sorted(decode_spans.items())},
               "kv_peak_blocks": status["kv"]["peak_blocks_used"],
               "flash_launches": flash_launches, "unwarmed_shapes": unwarmed}
        print(f"serve LM: {n} streams ({SERVE_HTTP_STREAMS} over HTTP), {tokens} tokens in "
              f"{traffic['wall_s']:.3f} s ({row['tokens_per_s']:.1f} tokens/s), TTFT p50 "
              f"{row['ttft_s']['p50']:.4f} s p99 {row['ttft_s']['p99']:.4f} s (direct streams), "
              f"replica start {start_s:.2f} s, KV peak {row['kv_peak_blocks']} blocks, flash "
              f"launches {flash_launches}; engine decode step ms by (bucket x capacity): "
              + json.dumps(row["engine_decode_step_ms"]))
        row["cache_consistency"] = check_cache_consistency(
            replica, prompts[:CONSISTENCY_STREAMS], budgets[:CONSISTENCY_STREAMS])
        row["profile"] = profile_decode_window(replica, cfg)
    finally:
        replica.stop()
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    # timed with the replica stopped: no engine or HTTP thread shares the host
    row["step_ms"] = time_lm_steps(module, cfg, device)
    shortest = sorted(range(n), key=lambda j: plens[j])[:CPU_STREAMS]
    row["card_vs_cpu"] = check_card_against_cpu(
        lm["dir"], module, [prompts[j] for j in shortest],
        [results[j]["tokens"] for j in shortest])
    return row


def serve_ctr(device, staged: dict) -> dict:
    """The batch tier on the card (see phase 10 in the module docstring)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
    from edl_tpu_torch.obs.tracing import Tracer
    from edl_tpu_torch.runtime.export import save_inference_model
    from edl_tpu_torch.serving import ServingConfig, ServingReplica
    from edl_tpu_torch.serving.__main__ import REQUIRED_FAMILIES

    batch = ctr.MODEL.synthetic_batch(np.random.default_rng(5), CTR_REQUESTS)
    rows = [{"dense": batch["dense"][i], "sparse": batch["sparse"][i]}
            for i in range(CTR_REQUESTS)]
    want = {}
    for v in (1, 2):
        module = ctr.MODEL.build(device=device)
        module.load_state_dict(staged[v]["state"])
        with torch.no_grad():
            want[v] = module.predict({k: torch.from_numpy(batch[k]).to(device)
                                      for k in ("dense", "sparse")}).cpu().numpy()
        del module

    def close(got, v):
        return abs(got - want[v]) <= TOL_CTR_SERVE_ABS + TOL_CTR_SERVE_REL * abs(want[v])

    apart = float(np.mean(~close(want[1], 2)))
    require(apart >= CTR_VERSIONS_APART, f"versions 1 and 2 answer apart on only {apart:.1%} of "
                                         "the rows: the swap check would have no teeth")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    replica = ServingReplica(ServingConfig(
        model_dir=staged["dir"], buckets=CTR_SERVE_BUCKETS, max_batch_delay_s=0.002, port=0,
        version_poll_s=0.05, name="chip-ctr", request_timeout_s=600.0, device=str(device)),
        registry=MetricsRegistry(), tracer=Tracer(component="serving")).start()
    start_s = time.perf_counter() - t0
    answers, latency, sent = [None] * CTR_REQUESTS, [None] * CTR_REQUESTS, [None] * CTR_REQUESTS
    errors, done, lock, publish_s = [], [0], threading.Lock(), []

    def one(i):
        sent[i] = time.time()
        try:
            if i % CTR_HTTP_EVERY == 0:
                reply = _post(replica.url + "/predict", {"features": {
                    k: rows[i][k].tolist() for k in ("dense", "sparse")}})
                answers[i] = float(reply["outputs"])
            else:
                answers[i] = float(replica.predict(rows[i]))
        except Exception as e:  # every failure is counted and fails the phase below
            errors.append((i, repr(e)))
        latency[i] = time.time() - sent[i]
        with lock:
            done[0] += 1

    def publish():
        wait_for(lambda: done[0] >= CTR_SWAP_AFTER, 600, "CTR traffic stalled")
        t = time.perf_counter()
        save_inference_model(staged["dir"], "ctr", staged[2]["state"], step=staged[2]["step"],
                             versioned=True)
        publish_s.append(time.perf_counter() - t)

    try:
        first = range(CTR_REQUESTS - CTR_POST_SWAP)
        publisher = threading.Thread(target=publish)
        publisher.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CTR_CLIENTS) as pool:
            list(pool.map(one, first))
        first_wall = time.perf_counter() - t0
        publisher.join(timeout=600)
        wait_for(lambda: replica.status()["model_step"] == staged[2]["step"], 600,
                 "version 2 never swapped in")
        swapped = time.time()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CTR_CLIENTS) as pool:
            list(pool.map(one, range(CTR_REQUESTS - CTR_POST_SWAP, CTR_REQUESTS)))
        second_wall = time.perf_counter() - t0
        status = replica.status()
        unwarmed = replica.jit_cache_size()
        families = parse_prometheus(scrape_metrics(replica.url))
        swap_span = replica.tracer.find(name="model_swap")
    finally:
        replica.stop()
    require(not errors and status["errors"] == 0 and status["rejected"] == 0,
            f"CTR requests failed: {errors[:4]} {status}")
    require(status["completed"] == CTR_REQUESTS, f"CTR replica status: {status}")
    require(status["swaps"] == 1 and status["model_step"] == staged[2]["step"],
            f"the swap did not land: {status}")
    require(unwarmed == 0, f"{unwarmed} CTR dispatch shapes were not warmed")
    missing = [f for f in REQUIRED_FAMILIES if f not in families]
    require(not missing, f"missing metric families: {missing}")
    got = np.asarray(answers)
    post = np.asarray([sent[i] > swapped for i in range(CTR_REQUESTS)])
    # each answer is version 1's or version 2's: the nearer, within tolerance
    by2 = np.abs(got - want[2]) < np.abs(got - want[1])
    ok = np.where(by2, close(got, 2), close(got, 1))
    require(bool(ok.all()), f"CTR answers off both versions' predict at rows "
                            f"{np.flatnonzero(~ok)[:8].tolist()}")
    require(bool((by2 & close(got, 2))[post].all()),
            "CTR answers after the swap are not version 2's")
    err = {v: float(np.max(np.abs(got[sel] - want[v][sel]))) if sel.any() else None
           for v, sel in ((1, ~by2), (2, by2))}
    row = {"requests": CTR_REQUESTS, "http_requests": len(range(0, CTR_REQUESTS, CTR_HTTP_EVERY)),
           "buckets": list(CTR_SERVE_BUCKETS), "clients": CTR_CLIENTS, "start_s": start_s,
           "versions_apart_share": apart,
           "export_s": staged["export_s"], "publish_s": publish_s[0],
           "versions": [staged[1]["step"], staged[2]["step"]],
           "answered_by": {"1": int((~by2).sum()), "2": int(by2.sum()),
                           "after_swap": int(post.sum())},
           "max_abs_err": err, "tolerance": {"abs": TOL_CTR_SERVE_ABS, "rel": TOL_CTR_SERVE_REL},
           "swap_s": swap_span[0].seconds if swap_span else None,
           "latency_s": _quantiles([x for x in latency]),
           "requests_per_s": CTR_REQUESTS / (first_wall + second_wall),
           "bucket_hits": status["bucket_hits"], "failed": len(errors),
           "unwarmed_shapes": unwarmed,
           "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    print(f"serve CTR: {CTR_REQUESTS} requests ({row['http_requests']} over HTTP), 0 failed, "
          f"{row['requests_per_s']:.1f} requests/s, latency p50 {row['latency_s']['p50'] * 1e3:.3f} "
          f"ms p99 {row['latency_s']['p99'] * 1e3:.3f} ms; swap to step {staged[2]['step']} in "
          f"{row['swap_s']} s, answered by version 1 / 2: {row['answered_by']}; max abs err "
          f"{err}; bucket hits {status['bucket_hits']}")
    return row


def phase_serve(device, lm: dict, ctr_staged: dict) -> dict:
    """The serving tier on the card: the LM tier, then the batch tier."""
    t0 = time.perf_counter()
    out = {"lm": serve_lm(device, lm)}
    t1 = time.perf_counter()
    out["ctr"] = serve_ctr(device, ctr_staged)
    out["seconds"] = {"lm": t1 - t0, "ctr": time.perf_counter() - t1}
    print(f"serve: LM tier {t1 - t0:.1f} s, CTR tier {out['seconds']['ctr']:.1f} s")
    return out


def main(argv) -> int:
    device = phase_device()
    sass = phase_build()
    kernels = phase_kernels(device)
    for name, row in kernels.items():
        fn = DESIGNS[name][0]
        row["sass"] = {f"DP{dp}": ops for dp, ops in sorted(sass[fn].items())}
    if "--kernels" in argv:
        print(json.dumps({"kernels": list(kernels.values())}))
        return 0
    with tempfile.TemporaryDirectory(prefix="edl-serve-") as serve_root:
        launches, in_step, lm, lm_state = phase_slice(device)
        # exported as its run ends, as a trainer publishes; the state is then
        # freed, so the later phases' peak memory does not hold it
        lm_export = export_lm(lm_state, serve_root)
        del lm_state
        phase_step_parity(device)
        ctr_row, ctr_run = phase_ctr(device)
        ctr_staged = stage_ctr_versions(ctr_run, serve_root)
        del ctr_run
        ctr_row["cpu_parity"] = phase_ctr_cpu_parity(device)
        others = phase_zoo(device)
        remat = phase_remat(device, lm)
        serve = phase_serve(device, lm_export, ctr_staged)
    for name, row in kernels.items():
        row["launches"] = launches[name]
        row["launches_remat"] = remat["launches"][name]
        row["launches_serve"] = serve["lm"]["flash_launches"][name]
        row["in_step_ms"] = in_step.get(name)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"zoo": [ctr_row, *others, lm, remat]}))
    print(json.dumps({"serve": serve}))
    import torch

    # count: the devices this run uses
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
