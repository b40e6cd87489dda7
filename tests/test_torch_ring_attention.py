"""Ring attention over the ``seq`` axis: the port's `ring_attention` on gloo
ranks against the JAX package's on a CPU mesh of the same shape, from the
same numpy q, k, v and output cotangent.

One set of ranks a mesh (`torch_dp_worker.spawn_ranks` with
`torch_mp_worker`): ``{"seq": 2}`` on 2 ranks; ``{"seq": 4}`` and
``{"data": 2, "seq": 2}`` on 4. Each mesh runs causal and not causal, the
einsum engine and the flash engine (the port's plain versions of the
kernels on the CPU against the JAX kernels in interpret mode), in f32 and
bf16, in four runs that hold every pair of those levels (`CONFIGS`): the
rank's block of the output, and dq, dk, dv of the global q, k, v
for the loss ``sum(out * ct)``, the ranks' gradients summed (each holds
its own block's share). B 2, S 64, H 2, D 16.

Tolerances (absolute and relative alike): f32 1e-4 (the flash tests' f32
gradient bound; measured at most 4.2e-7 on outputs and 7.5e-7 on
gradients, absolute); bf16 2e-2 (the flash tests' bf16 bound; measured at
most 6e-8 on outputs, 4.9e-4 on the einsum engine's gradients and 7.8e-3
on the flash engine's). The flash engine's hops have an f32 dO,
which the kernels read in bf16 where the JAX kernels keep f32 (ROADMAP
queue B4): the port's backward runs on dO's bf16 part and again on the
remainder. Here the flash gradients' 7.8e-3 is the same with or without
that second pass: one bf16 unit at the gradients' size, their own
rounding. At the slice's size on the card the rounded dO alone put dq off
the plain full attention by 0.1 of a row (`chip_smoke.py`'s merged-hop
check, PERF.md), which is why the second pass is there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.parallel.ring_attention import ring_attention as jax_ring
from torch_dp_worker import spawn_ranks

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
B, S, H, D = 2, 64, 2, 16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (causal, flash, dtype): every level of each factor, and every pair of
#: levels of any two factors, in four runs a mesh
CONFIGS = [(True, False, "float32"), (True, True, "bfloat16"), (False, True, "float32"),
           (False, False, "bfloat16")]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    return q, k, v, rng.standard_normal((B, S, H, D)).astype(np.float32)


def _jax(axes, case):
    """JAX's whole output and gradients for the case, in f32."""
    spec = MeshSpec(dict(axes))
    mesh = build_mesh(spec, jax.devices()[:spec.size()])
    dtype = jnp.dtype(case["dtype"])

    def loss(q, k, v):
        out = jax_ring(q, k, v, mesh, causal=case["causal"], flash=case["flash"])
        return jnp.sum(out.astype(jnp.float32) * case["ct"]), out

    args = [jnp.asarray(case[n], dtype) for n in "qkv"]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(*args)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _run(tmp_path, world, meshes):
    cases = []
    for m, axes in enumerate(meshes):
        for c, (causal, flash, dtype) in enumerate(CONFIGS):
            q, k, v, ct = _inputs(10 * m + c)
            cases.append((axes, dict(axes=axes, q=q, k=k, v=v, ct=ct, causal=causal,
                                     flash=flash, dtype=dtype)))
    want = {}

    def references():
        for i, (axes, case) in enumerate(cases):
            want[i] = _jax(axes, case)

    results, _ = spawn_ranks(tmp_path, world, [("ring", c) for _, c in cases],
                             overlap=references, script=WORKER, timeout=300)
    for i, (axes, case) in enumerate(cases):
        tol = TOL[case["dtype"]]
        out, grads = want[i]
        label = f"{axes} causal={case['causal']} flash={case['flash']} {case['dtype']}"
        b, s = B // axes.get("data", 1), S // axes.get("seq", 1)
        for res in results:
            bi, sj = res[i]["block"]
            block = out[bi * b:(bi + 1) * b, sj * s:(sj + 1) * s]
            np.testing.assert_allclose(res[i]["out"].numpy(), block, rtol=tol, atol=tol,
                                       err_msg=f"out {label}")
        for n, g in enumerate(grads):
            got = sum(res[i]["grads"][n].numpy() for res in results)
            np.testing.assert_allclose(got, g, rtol=tol, atol=tol,
                                       err_msg=f"d{'qkv'[n]} {label}")


def test_ring_on_two_ranks(tmp_path):
    """{"seq": 2}: every configuration."""
    _run(tmp_path, 2, [{"seq": 2}])


def test_ring_on_four_ranks_over_seq(tmp_path):
    """{"seq": 4}: every configuration."""
    _run(tmp_path, 4, [{"seq": 4}])


def test_ring_on_four_ranks_over_data_and_seq(tmp_path):
    """{"data": 2, "seq": 2}: every configuration."""
    _run(tmp_path, 4, [{"data": 2, "seq": 2}])
