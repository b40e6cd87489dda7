"""The port's flash attention against the JAX package's, on the CPU.

On the CPU the port runs its plain PyTorch versions of the three kernels
(through the same ``autograd.Function`` the CUDA kernels sit behind) and the
JAX package runs its Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and handed to both. Tolerances: f32 forward 2e-5 (as the
JAX package's own tests), f32 gradients 1e-4, bf16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_attention as jax_flash
from edl_tpu_torch.ops import flash_attention
from edl_tpu_torch.ops.flash_attention import _NEG_INF, TILE

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def rand_qkv(rng, B, S, H, D, Sk=None):
    Sk = Sk or S
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


def torch_leaves(*xs, dtype=torch.float32):
    return [torch.tensor(x, dtype=dtype, requires_grad=True) for x in xs]


def jax_leaves(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def both_grads(jloss, tloss, q, k, v, dtype=(jnp.float32, torch.float32)):
    """(JAX grads, torch grads) of q, k, v for the same loss in both."""
    want = jax.grad(jloss, argnums=(0, 1, 2))(*jax_leaves(q, k, v, dtype=dtype[0]))
    leaves = torch_leaves(q, k, v, dtype=dtype[1])
    got = torch.autograd.grad(tloss(*leaves), leaves)
    return [np.asarray(x, np.float32) for x in want], [g.float().numpy() for g in got]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 16, 1, 8),    # tiny, single block
    (2, 64, 2, 16),   # multi-head
    (1, 300, 2, 32),  # ragged S, several query blocks
])
def test_forward_matches_jax(shape, causal):
    rng = np.random.default_rng(0)
    q, k, v = rand_qkv(rng, *shape)
    want = jax_flash(*jax_leaves(q, k, v), causal=causal, block_q=128, block_k=128)
    got = flash_attention(*torch_leaves(q, k, v), causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_FWD)


def test_multiple_kv_blocks_accumulate():
    """More keys than one JAX block and several of the CUDA tiles."""
    rng = np.random.default_rng(1)
    q, k, v = rand_qkv(rng, 1, 384, 1, 16)
    want = jax_flash(*jax_leaves(q, k, v), causal=True, block_q=128, block_k=128)
    got = flash_attention(*torch_leaves(q, k, v), causal=True, block_q=TILE,
                          block_k=TILE)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_FWD)


@pytest.mark.parametrize("q_off,k_off", [
    (32, 32),  # the ring's own block: causal within it
    (32, 0),   # a block from the past: every key visible
    (0, 5),    # keys in the queries' future: rows that see no key at all
])
def test_global_offsets_and_lse_match_jax(q_off, k_off):
    """(out, lse) with global offsets, as the ring's hop engine calls it."""
    rng = np.random.default_rng(2)
    q, k, v = rand_qkv(rng, 1, 32, 2, 8)
    jo, jl = jax_flash(*jax_leaves(q, k, v), causal=True, q_offset=q_off,
                       k_offset=k_off, return_lse=True)
    to, tl = flash_attention(*torch_leaves(q, k, v), causal=True, q_offset=q_off,
                             k_offset=k_off, return_lse=True)
    assert to.dtype == torch.float32 and tl.shape == (1, 2, 32)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **F32_FWD)
    jl, tl = np.asarray(jl), tl.detach().numpy()
    np.testing.assert_array_equal(tl == _NEG_INF, jl == _NEG_INF)
    np.testing.assert_allclose(tl, jl, **F32_FWD)


@pytest.mark.parametrize("S,q_off,k_off,through_lse", [
    pytest.param(160, 16, 8, False, id="False"),
    pytest.param(160, 16, 8, True, id="True"),
    # queries 0-199 see no key (a whole 128-row dq block of the CUDA kernel
    # and one warpgroup of the next), and keys 100-299 are seen by none
    pytest.param(300, 0, 200, True, id="no_key_block"),
])
def test_gradients_match_jax(S, q_off, k_off, through_lse):
    """dq, dk, dv with offsets and a ragged sequence; with ``through_lse`` the
    loss also reads lse, so its cotangent reaches the backward's delta.
    Queries that see no key get dq = 0 and keys that no query sees get
    dk = dv = 0, exactly."""
    rng = np.random.default_rng(3)
    q, k, v = rand_qkv(rng, 1, S, 2, 16)
    w = rng.standard_normal((1, 2, S)).astype(np.float32)
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off)

    def jloss(q, k, v):
        if not through_lse:
            return jnp.sum(jax_flash(q, k, v, **kw) ** 2)
        out, lse = jax_flash(q, k, v, return_lse=True, **kw)
        return jnp.sum(out ** 2) + jnp.sum(lse * w)

    def tloss(q, k, v):
        if not through_lse:
            return (flash_attention(q, k, v, **kw) ** 2).sum()
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        return (out ** 2).sum() + (lse * torch.from_numpy(w)).sum()

    want, got = both_grads(jloss, tloss, q, k, v)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **F32_GRAD, err_msg=f"d{name}")
    pos = np.arange(S)
    valid = (k_off + pos)[None, :] <= (q_off + pos)[:, None]
    no_key, unseen = ~valid.any(1), ~valid.any(0)
    assert (got[0][:, no_key] == 0).all()
    assert (got[1][:, unseen] == 0).all() and (got[2][:, unseen] == 0).all()


def test_bfloat16_values_and_gradients():
    rng = np.random.default_rng(4)
    q, k, v = rand_qkv(rng, 1, 64, 2, 16)
    want = jax_flash(*jax_leaves(q, k, v, dtype=jnp.bfloat16), causal=True)
    got = flash_attention(*torch_leaves(q, k, v, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **BF16)
    want, got = both_grads(
        lambda q, k, v: jnp.sum(jax_flash(q, k, v).astype(jnp.float32) ** 2),
        lambda q, k, v: (flash_attention(q, k, v).float() ** 2).sum(),
        q, k, v, dtype=(jnp.bfloat16, torch.bfloat16))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **BF16, err_msg=f"d{name}")


def test_bfloat16_gradients_through_lse():
    """bf16 inputs on the ring's path: out and lse in f32, and a loss that
    reads both. The port's backward takes dO in bf16, the kernels' operand,
    with delta formed from that same dO; the JAX kernels keep the f32 dO."""
    rng = np.random.default_rng(5)
    q, k, v = rand_qkv(rng, 1, 96, 2, 16)
    w = rng.standard_normal((1, 2, 96)).astype(np.float32)
    kw = dict(causal=True, q_offset=32, k_offset=32)

    def jloss(q, k, v):
        out, lse = jax_flash(q, k, v, return_lse=True, **kw)
        return jnp.sum(out ** 2) + jnp.sum(lse * w)

    def tloss(q, k, v):
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        assert out.dtype == torch.float32
        return (out ** 2).sum() + (lse * torch.from_numpy(w)).sum()

    want, got = both_grads(jloss, tloss, q, k, v, dtype=(jnp.bfloat16, torch.bfloat16))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **BF16, err_msg=f"d{name}")


def test_fully_masked_rows_give_zero_and_the_sentinel():
    """Rows that see no key: out exactly 0, lse exactly -1e30, no gradient,
    as the JAX kernels give them."""
    rng = np.random.default_rng(6)
    q, k, v = rand_qkv(rng, 1, 16, 1, 8)
    off = 5  # keys start 5 positions into the queries' future
    out, lse = flash_attention(*torch_leaves(q, k, v), causal=True, q_offset=0,
                               k_offset=off, return_lse=True)
    assert (out[0, :off] == 0).all()
    assert (lse[0, 0, :off] == _NEG_INF).all() and (lse[0, 0, off:] > -1e3).all()
    want, got = both_grads(
        lambda q, k, v: jnp.sum(jax_flash(q, k, v, q_offset=0, k_offset=off) ** 2),
        lambda q, k, v: (flash_attention(q, k, v, q_offset=0, k_offset=off) ** 2).sum(),
        q, k, v)
    assert (got[0][0, :off] == 0).all() and np.isfinite(got[0]).all()
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **F32_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("trial", range(4))
def test_randomized_shapes_and_offsets(trial):
    """The ring's input space: random (B, Sq, Sk, H, D), global offsets
    (key blocks wholly or partly in the queries' future), causal or not;
    values and dq against the JAX kernels."""
    rng = np.random.default_rng(100 + trial)
    B, H = int(rng.integers(1, 3)), int(rng.integers(1, 3))
    D = int(rng.choice([4, 8, 16]))
    Sq, Sk = int(rng.integers(3, 70)), int(rng.integers(3, 70))
    kw = dict(causal=bool(trial % 2 == 0), q_offset=int(rng.integers(0, 50)),
              k_offset=int(rng.integers(0, 50)))
    q, k, v = rand_qkv(rng, B, Sq, H, D, Sk=Sk)
    want = jax_flash(*jax_leaves(q, k, v), **kw)
    got = flash_attention(*torch_leaves(q, k, v), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_FWD,
                               err_msg=str((B, Sq, Sk, H, D, kw)))
    want, got = both_grads(lambda q, k, v: jnp.sum(jax_flash(q, k, v, **kw) ** 2),
                           lambda q, k, v: (flash_attention(q, k, v, **kw) ** 2).sum(),
                           q, k, v)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **F32_GRAD, err_msg=f"d{name}")


def test_unsupported_blocks_raise():
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, block_q=128)
