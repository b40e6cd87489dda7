#!/usr/bin/env python3
"""Drive the PyTorch port (``edl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``edl_tpu``. Phases, in order; a
phase that fails raises, and the script exits non-zero without its last line:

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them; turns TF32 off for f32 matmuls
   and convolutions.
2. Build: compiles the CUDA sources with ``nvcc`` for ``sm_90a``.
3. Kernels: each of the three flash-attention kernels against its plain
   PyTorch version on the same inputs, at the slice's shape, a ragged shape,
   the ring's offset cases (with an lse cotangent), a case with rows that see
   no key, and head dims 8, 16 and 32, row by row and element by element;
   then proof that the comparison rejects two planted faults (one key tile
   left out for the later query tiles; the later rows off by 2 %) at the
   slice's shape; then each kernel's
   time at the slice's shape beside its plain version's, one library call's
   and the card's bound.
4. The slice: the GPT-2-small-width transformer LM (12 layers, d_model 768,
   seq 1024, vocab 32000, batch 8) trained by the ``Trainer`` with Adam at lr
   3e-4 on one repeated synthetic batch. Losses must be finite and fall, and
   each kernel's launch count over the timed steps must be 12 x steps. Then
   one more step under ``torch.profiler``: its device time by kernel.
5. The same width at depth 2, one step through the kernels and one through
   the plain attention path from the same weights: loss and every gradient
   compared.
6. One JSON line ``{"kernels": [...]}``.
7. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
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

KERNELS = {  # name -> (plain version, TPU kernel it replaces)
    "fwd": ("_fwd_reference", "edl_tpu/ops/flash_attention.py:88"),
    "bwd_dq": ("_bwd_dq_reference", "edl_tpu/ops/flash_attention.py:178"),
    "bwd_dkv": ("_bwd_dkv_reference", "edl_tpu/ops/flash_attention.py:219"),
}
SOURCE = "edl_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")

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
    ("head_dim_8", (1, 100, 100, 2, 8), True, 0, 0, False, True),
    ("head_dim_16", (1, 100, 100, 2, 16), True, 0, 0, False, True),
    ("head_dim_32", (1, 100, 100, 2, 32), False, 0, 0, False, True),
]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build() -> None:
    from edl_tpu_torch.ops import _build

    fa = _flash_module()
    t0 = time.perf_counter()
    path = _build.build()
    fa._kernels()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


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
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                                  retain_graph=True))
    library = {"fwd": lib_fwd, "bwd_dq": lib_bwd, "bwd_dkv": lib_bwd}

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
        bound_ms, bound_by = bounds[kname]
        print(f"time {kname} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library[kname]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        results[kname] = dict(
            name=kname, route="cuda", source=SOURCE, replaces=KERNELS[kname][1],
            max_abs_err=worst[kname]["abs"][0],
            worst={m: {"value": x, "case": c} for m, (x, c) in worst[kname].items()},
            tolerance={"row": TOL_ROW, "elem": TOL_ELEM, "lse_abs": TOL_LSE}, ms=ms,
            plain_ms=plain_ms, plain=KERNELS[kname][0], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library[kname],
            library_call=("scaled_dot_product_attention(is_causal=True)"
                          if kname == "fwd" else
                          "scaled_dot_product_attention backward: dq, dk and dv together"),
        )
    return results


def phase_slice(device) -> dict:
    """Train the GPT-2-small-width LM through the Trainer; returns the launch
    counts of the timed steps."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    fa = _flash_module()
    cfg = TransformerConfig(flash=True, **SLICE)
    model = make_model(cfg)
    trainer = Trainer(model, device=device,
                      config=TrainerConfig(optimizer="adam", learning_rate=3e-4, seed=0))
    state = trainer.init_state()
    n_params = sum(p.numel() for p in state.params.parameters())
    batch = trainer.place_batch(model.synthetic_batch(np.random.default_rng(0), BATCH))
    for _ in range(WARMUP_STEPS):
        state, loss = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(fa.LAUNCHES)

    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = cfg.n_layers * STEPS
    require(all(n == want for n in launches.values()),
            f"launch counts {launches}, want {want} each (12 layers x {STEPS} steps)")
    step = statistics.median(step_s)
    tokens = BATCH * cfg.seq_len
    print(f"slice: {n_params / 1e6:.1f} M params, batch {BATCH} x {cfg.seq_len}, "
          f"losses {[round(x, 4) for x in losses]}")
    print(f"slice: step {step * 1e3:.2f} ms (median of {STEPS}), "
          f"{tokens / step:.0f} tokens/s, MFU "
          f"{model.flops_per_step(BATCH) / step / PEAK_BF16_FLOPS:.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB, "
          f"launches {launches}")
    profile_step(trainer, state, batch, step * 1e3)
    return launches


def profile_step(trainer, state, batch, step_ms: float) -> None:
    """Where one step's device time goes, by CUDA kernel (torch.profiler),
    and the device's busy share: of the profiled step's own wall time (the
    profiler slows the host) and of the median unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side user annotations (Optimizer.step#...) span kernels counted
    # on their own, so only real kernels are summed
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print("profile: device time not measured (the profiler saw no CUDA kernel)")
        return
    groups = {"flash attention kernels": 0.0, "bf16 matmuls": 0.0,
              "f32 matmuls (TF32 off)": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        group = ("flash attention kernels" if any(k in name for k in FLASH_NAMES) else
                 "f32 matmuls (TF32 off)" if "sgemm" in name or "f32f32_f32f32" in name else
                 "bf16 matmuls" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet"))
                 else "other")
        groups[group] += e.self_device_time_total
    print(f"profile: one step, {total_us / 1e3:.2f} ms of kernels; device busy "
          f"{total_us / 1e3 / wall_ms:.1%} of this step's {wall_ms:.2f} ms, "
          f"{total_us / 1e3 / step_ms:.1%} of the median step; " + ", ".join(
              f"{g} {us / 1e3:.2f} ms ({us / total_us:.1%})" for g, us in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")


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


def main() -> int:
    device = phase_device()
    phase_build()
    kernels = phase_kernels(device)
    launches = phase_slice(device)
    phase_step_parity(device)
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
