"""A model of the f32 forward kernels' arithmetic against the JAX package's forward, on the CPU.

The f32 forwards (``edl_tpu_torch/ops/csrc/flash_fwd_f32.cu`` up to a head
dim of 256, ``flash_fwd_f32_sliced.cu`` past it) run only on the card. This
file models in PyTorch on the CPU what they compute, step by step, and holds
the model to the JAX package's `flash_attention` forward in f32 (its Pallas
kernel in interpret mode) within the f32 bound that ``chip_smoke.py`` holds
the kernels to on the card (``TOL_ROW_F32``, ``TOL_ELEM_F32``, ``TOL_LSE``):

* 3xTF32 products: each f32 operand split by integer operations on its bits
  into hi, rounded to TF32, and lo = x - hi (`hopper::tf32_split`); the
  tensor cores read an operand's top 19 bits (`tf32_read`); each mma.sync
  step of 8 sums its products exactly into an f32 accumulator, lo·hi, hi·lo
  and hi·hi in that order (`hopper::mma_3xtf32`);
* the scores summed over 32-column chunks, each step's three products in a
  fresh accumulator added to the chunk's in f32, each chunk's added to S in
  f32 (``chunk_scores<2, true>``);
* each 64-key tile's keys split 32/32 between the two consumer warpgroups,
  whose row maxima and sums of P are merged (``fwd_tile_softmax``), P and l
  in f32;
* O rescaled by alpha in f32, and each tile's P·V summed in a fresh
  accumulator (24 products deep) added to O in f32 (``spread_product``,
  ``tile_product``);
* past a padded head dim of 256, blocks of 512 columns of O, each of which
  sums the scores in the same order, so that all hold the same m and l.

A model whose products take hi·hi alone, one TF32 rounding of each operand,
must fail the same bound in the same cases: the bound tells 3xTF32 from
TF32.
"""

import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_attention as jax_flash

ROOT = Path(__file__).resolve().parents[1]

TILE = 64  # query rows a block and keys a tile
CHUNK = 32  # f32 head-dim columns a chunk (one 128-byte TMA box)
SLICE = 512  # O's columns a block past a padded head dim of 256
NEG_INF = -1e30  # the kernels' sentinel

#: (B, Sq, Sk, H, D, causal, q_offset, k_offset): D 64 with a ragged last
#: tile (22 rows and keys); D 256 with fewer queries than keys, late in the
#: sequence; D 576 in two 512-column slices (the last 64 wide) with queries
#: 0-39 seeing no key
CASES = {
    "d64_ragged": (2, 150, 150, 2, 64, True, 0, 0),
    "d256_offsets": (1, 100, 130, 2, 256, True, 40, 0),
    "d576_no_key_rows": (1, 90, 90, 2, 576, True, 0, 40),
}


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def tf32_split(x):
    """x (f32) as (hi, lo): hi rounded to TF32 by integer operations on its
    bits, ``(bits + 0x1000) & 0xFFFFE000``, and lo = x - hi."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def tf32_read(x):
    """An f32 operand as the tensor cores read it: its low 13 bits ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mma(acc, a, b):
    """One m16n8k8 step: acc (f32) + a (..., M, 8) · b (..., 8, N), the
    products of the TF32 operands exact and their sum rounded into acc."""
    return (acc.double() + tf32_read(a).double() @ tf32_read(b).double()).float()


def terms(a, b, three):
    """The operand pairs of one product step: 3xTF32 (lo·hi, hi·lo, hi·hi,
    the small terms first) or hi·hi alone."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return [(al, bh), (ah, bl), (ah, bh)] if three else [(ah, bh)]


def scores(q, k, three):
    """S = Q·Kᵀ (q (..., 64, Dp), k (..., 64, Dp), Dp a multiple of CHUNK):
    per 32-column chunk, each 8-column step's products in a fresh
    accumulator added to the chunk's in f32, the chunk's added to S."""
    s = torch.zeros(q.shape[:-1] + (k.shape[-2],))
    for c0 in range(0, q.shape[-1], CHUNK):
        part = torch.zeros_like(s)
        for s0 in range(c0, c0 + CHUNK, 8):
            step = torch.zeros_like(s)
            for a, b in terms(q[..., s0:s0 + 8], k[..., s0:s0 + 8].transpose(-1, -2), three):
                step = mma(step, a, b)
            part = part + step
        s = s + part
    return s


def tile_pv(p, v, three):
    """One tile's P·V (p (..., 64, 64 keys), v (..., 64 keys, W)): every
    8-key step's products into one fresh accumulator, for the caller to add
    to O in f32."""
    part = torch.zeros(p.shape[:-1] + (v.shape[-1],))
    for s0 in range(0, TILE, 8):
        for a, b in terms(p[..., s0:s0 + 8], v[..., s0:s0 + 8, :], three):
            part = mma(part, a, b)
    return part


def forward_model(q, k, v, *, causal, q_offset, k_offset, three=True):
    """The f32 forward kernels' function as they compute it: (B, Sq, H, D)
    q and (B, Sk, H, D) k, v -> O (B, Sq, H, D), lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    width = D if D <= 256 else SLICE
    n_qt, n_kt_all = -(-Sq // TILE), -(-Sk // TILE)

    def tiles(x, n):  # (B, S, H, D) -> (B, H, n·TILE, Dp), zeros past S and D (TMA's fill)
        x = x.permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, -D % CHUNK, 0, n * TILE - x.shape[2]))

    q3, k3, v3 = tiles(q, n_qt), tiles(k, n_kt_all), tiles(v, n_kt_all)
    o = torch.zeros(B, H, n_qt * TILE, D)
    lse = torch.zeros(B, H, n_qt * TILE)
    for qt in range(n_qt):
        q0 = qt * TILE
        qpos = q_offset + q0 + torch.arange(TILE)
        last = q_offset + q0 + TILE - 1 - k_offset  # the last key a row of the tile sees
        n_kt = min(n_kt_all, max(0, last // TILE + 1)) if causal else n_kt_all
        qb = q3[:, :, q0:q0 + TILE]
        for c0 in range(0, D, width):  # a block a slice of O's columns
            m = torch.full((B, H, TILE), NEG_INF)
            l = torch.zeros(B, H, TILE)
            acc = torch.zeros(B, H, TILE, min(width, D - c0))
            for kt in range(n_kt):
                keys = kt * TILE + torch.arange(TILE)
                vis = (keys < Sk)[None, :] & (
                    (k_offset + keys[None, :] <= qpos[:, None]) if causal else True)
                s = scores(qb, k3[:, :, kt * TILE:(kt + 1) * TILE], three) * scale
                # each warpgroup's maximum of its 32 keys, merged
                halves = [torch.where(vis[:, h:h + 32], s[..., h:h + 32], NEG_INF).amax(-1)
                          for h in (0, 32)]
                m_new = torch.maximum(m, torch.maximum(*halves))
                p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + (p[..., :32].sum(-1) + p[..., 32:].sum(-1))
                vb = v3[:, :, kt * TILE:(kt + 1) * TILE, c0:c0 + acc.shape[-1]]
                acc = acc * alpha[..., None] + tile_pv(p, vb, three)
                m = m_new
            row_lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), NEG_INF)
            if c0 == 0:
                lse[:, :, q0:q0 + TILE] = row_lse
            else:  # every slice sums the scores in the same order
                assert torch.equal(row_lse, lse[:, :, q0:q0 + TILE])
            o[:, :, q0:q0 + TILE, c0:c0 + acc.shape[-1]] = acc / torch.where(
                l > 0, l, 1.0)[..., None]
    return o[:, :, :Sq].permute(0, 2, 1, 3), lse[:, :, :Sq]


def _inputs(name):
    B, Sq, Sk, H, D, causal, qo, ko = CASES[name]
    rng = np.random.default_rng(23)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    jo, jl = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), return_lse=True, **kw)
    return [torch.from_numpy(x) for x in (q, k, v)], kw, (
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl)))


def _errors(cs, got, want):
    """The model's O against the JAX forward's (``chip_smoke``'s metrics)
    and its lse's largest absolute error over the rows that see a key."""
    (o, lse), (jo, jl) = got, want
    live = jl != NEG_INF
    return cs._compare(o, jo), (lse[live] - jl[live]).abs().max().item()


def test_tf32_split_is_exact_and_rounds_hi_to_tf32():
    """hi + lo is x exactly, hi has its low 13 bits clear and is x rounded
    to the nearest TF32 value, so |lo| <= 2^-11 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())


@pytest.mark.parametrize("name", list(CASES))
def test_the_3xtf32_forward_model_holds_the_f32_bound_against_jax(cs, name):
    """The model in 3xTF32 is within ``TOL_ROW_F32`` and ``TOL_ELEM_F32`` of
    the JAX forward's O and ``TOL_LSE`` of its lse; a row that sees no key
    gets O = 0 and lse = -1e30 exactly in both."""
    (q, k, v), kw, want = _inputs(name)
    got = forward_model(q, k, v, **kw)
    err, lse_err = _errors(cs, got, want)
    assert err["row"] <= cs.TOL_ROW_F32 and err["elem"] <= cs.TOL_ELEM_F32, err
    assert lse_err <= cs.TOL_LSE
    no_key = want[1] == NEG_INF
    assert torch.equal(got[1] == NEG_INF, no_key)
    assert bool((got[0].permute(0, 2, 1, 3)[no_key] == 0).all())
    if name == "d576_no_key_rows":
        assert bool(no_key.any())


@pytest.mark.parametrize("name", list(CASES))
def test_a_tf32_forward_model_fails_the_f32_bound(cs, name):
    """The model with hi·hi products alone (one TF32 rounding of each
    operand) is off the JAX forward's O by more than the f32 bound."""
    (q, k, v), kw, want = _inputs(name)
    err, _ = _errors(cs, forward_model(q, k, v, three=False, **kw), want)
    assert err["row"] > cs.TOL_ROW_F32 or err["elem"] > cs.TOL_ELEM_F32, err
