"""The port's flash attention against the JAX package's, on the CPU.

On the CPU the port runs its plain PyTorch versions of the three kernels
(through the same ``autograd.Function`` the CUDA kernels sit behind) and the
JAX package runs its Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and handed to both. Tolerances: f32 forward 2e-5 (as the
JAX package's own tests), f32 gradients 1e-4, bf16 2e-2, f16 5e-3 (both
sides round the same f16 inputs; outputs and gradients are f16, whose
rounding is 2^-11 of a value, and the two sum in other orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_attention as jax_flash
from edl_tpu_torch.ops import flash_attention
from edl_tpu_torch.ops.flash_attention import _NEG_INF, TILE

# the module (the package's attribute of that name is the function)
fa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
F16 = dict(rtol=5e-3, atol=5e-3)


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
    reads both. The port's kernels take dO in bf16, so its backward runs on
    dO's bf16 part and again on the remainder; the JAX kernels take the f32
    dO."""
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
    """A tile outside the compiled set (f32: 64 x 64) raises, naming the set."""
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(NotImplementedError, match=r"compiled for \[\(64, 64\)\]"):
        flash_attention(q, q, q, block_q=256)


def _lse_loss_grads(q, k, v, w, kw, dtype=(jnp.float32, torch.float32)):
    """(JAX, port) gradients of sum(out²) + sum(lse · w), and each side's
    (out, lse)."""
    def jloss(q, k, v):
        out, lse = jax_flash(q, k, v, return_lse=True, **kw)
        return jnp.sum(out ** 2) + jnp.sum(lse * w)

    def tloss(q, k, v):
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        return (out ** 2).sum() + (lse * torch.from_numpy(w)).sum()

    return both_grads(jloss, tloss, q, k, v, dtype=dtype)


@pytest.mark.parametrize("D", [40, 80, 96, 128, 136, 192, 200, 256, 264, 320, 512, 576])
def test_head_dims_past_64_match_jax(D):
    """The head dims that the D-64 (40, its last 24 columns zero), D-128 (80,
    96, 128), D-192 (136, 192) and D-256 (200, 256) kernels serve, and past
    256 the sliced kernels (264: a last chunk of 8 columns; 320, 512; 576: a
    short last slice): forward, lse and gradients through lse, with a ragged
    sequence and the ring's offsets, and rows that see no key."""
    rng = np.random.default_rng(7)
    q, k, v = rand_qkv(rng, 1, 70, 2, D)
    w = rng.standard_normal((1, 2, 70)).astype(np.float32)
    kw = dict(causal=True, q_offset=16, k_offset=24)
    jo, jl = jax_flash(*jax_leaves(q, k, v), return_lse=True, **kw)
    to, tl = flash_attention(*torch_leaves(q, k, v), return_lse=True, **kw)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **F32_FWD)
    jl, tl = np.asarray(jl), tl.detach().numpy()
    np.testing.assert_array_equal(tl == _NEG_INF, jl == _NEG_INF)
    assert (tl == _NEG_INF).any()
    np.testing.assert_allclose(tl, jl, **F32_FWD)
    want, got = _lse_loss_grads(q, k, v, w, kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **F32_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_float16_and_float32_match_jax(dtype, D):
    """f16 and f32 through the same wrapper, with offsets and a ragged
    sequence: out (in the input's dtype), out and lse with lse, and the
    gradients of a loss that reads both."""
    rng = np.random.default_rng(8)
    q, k, v = rand_qkv(rng, 1, 90, 2, D, Sk=75)
    w = rng.standard_normal((1, 2, 90)).astype(np.float32)
    kw = dict(causal=True, q_offset=40, k_offset=20)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    fwd, grad = (F32_FWD, F32_GRAD) if dtype == "float32" else (F16, F16)
    want = jax_flash(*jax_leaves(q, k, v, dtype=jt), **kw)
    got = flash_attention(*torch_leaves(q, k, v, dtype=tt), **kw)
    assert got.dtype == tt
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32), **fwd)
    jo, jl = jax_flash(*jax_leaves(q, k, v, dtype=jt), return_lse=True, **kw)
    to, tl = flash_attention(*torch_leaves(q, k, v, dtype=tt), return_lse=True, **kw)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **fwd)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **fwd)
    want, got = _lse_loss_grads(q, k, v, w, kw, dtype=(jt, tt))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **grad, err_msg=f"d{name}")


def test_head_dim_not_a_multiple_of_8_is_padded_and_matches_jax(monkeypatch):
    """D 20: the wrapper pads q, k and v to 24 columns of zeros before the
    autograd function (on either device) and slices the output back; values
    and gradients are the JAX kernels' at D 20, with the scale of D 20."""
    seen = []
    apply = fa._Flash.apply
    monkeypatch.setattr(fa._Flash, "apply", lambda *args: seen.append(args) or apply(*args))
    rng = np.random.default_rng(9)
    q, k, v = rand_qkv(rng, 1, 50, 2, 20)
    want = jax_flash(*jax_leaves(q, k, v), causal=True)
    got = flash_attention(*torch_leaves(q, k, v), causal=True)
    assert got.shape == (1, 50, 2, 20)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_FWD)
    assert seen[0][0].shape == (1, 50, 2, 24) and seen[0][3] == pytest.approx(20 ** -0.5)
    assert (seen[0][0][..., 20:] == 0).all()
    want, got = both_grads(lambda q, k, v: jnp.sum(jax_flash(q, k, v) ** 2),
                           lambda q, k, v: (flash_attention(q, k, v) ** 2).sum(), q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == (1, 50, 2, 20)
        np.testing.assert_allclose(a, b, **F32_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("cut", ["stride_not_16B", "odd_stride"])
def test_views_tma_cannot_read_are_copied(cut, monkeypatch):
    """A view whose strides or start TMA cannot read is copied to a
    contiguous tensor before the autograd function; values and gradients
    are those of the contiguous input."""
    seen = []
    apply = fa._Flash.apply
    monkeypatch.setattr(fa._Flash, "apply", lambda *args: seen.append(args) or apply(*args))
    rng = np.random.default_rng(10)
    bases = [torch.tensor(rng.standard_normal((1, 40, 2, 68)), dtype=torch.bfloat16)
             for _ in range(3)]
    views = [b[..., :64] if cut == "stride_not_16B" else b[..., 1:65] for b in bases]
    assert fa._view_problem(views[0].shape, views[0].stride(), views[0].element_size(),
                            views[0].data_ptr() - bases[0].data_ptr() + (1 << 20)) is not None
    leaves = [x.detach().requires_grad_() for x in views]
    out = flash_attention(*leaves)
    assert all(x.is_contiguous() for x in seen[0][:3])
    dense = [x.contiguous().requires_grad_() for x in views]
    want = flash_attention(*dense)
    assert torch.equal(out, want)
    for g, w in zip(torch.autograd.grad(out.float().sum(), leaves),
                    torch.autograd.grad(want.float().sum(), dense)):
        assert torch.equal(g, w)
